"""Copy of `subread_tpu/quant/cellcounts.py`: the port imports nothing of the JAX package.

Departures from the original, each for a whitelist of 10x Chromium v3's
size (6,794,880 barcodes): `BatchBarcodeMatcher` rescues a barcode by
looking up its single-base substitutions in the sorted whitelist, with no
per-barcode dicts; `BatchCellCounter` packs (cell, gene, UMI) into a key
whose fields are as wide as the whitelist, the gene list and the UMI need
(two words where one does not hold them), where the original gave the
cell 20 bits and let larger whitelist indices collide.  `CellAnnotation`
builds the annotation's two views once; the counters and spans are the
port's (`timing`).

cellCounts: single-cell RNA-seq counting pipeline.

Reference: cell-counts.c — barcode matching with hamming≤1 rescue
(:1713, input-blc.h:52), seed-and-vote mapping of the cDNA read
(cellCounts_do_voting :3051), batched (cell, gene, UMI) sort-merge dedup
with hamming≤1 UMI merging (:3523-3620), CellRanger-style sparse output
(cellCounts_run_counting :4837).

Input modes (cell-counts.c `--inputMode`): FASTQ (R1 = barcode+UMI,
R2 = cDNA) and raw BCL/CBCL run directories with sample-sheet demultiplex
(io/bcl.py; sample-index matching with hamming<=1 rescue like the
cell-barcode rescue, input-blc.h:52).  Exact + hamming<=1 cell-barcode
matching, device alignment via align.Aligner, gene assignment via the
featureCounts interval engine, UMI dedup with hamming<=1 merge, sparse
matrix-market output.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna, timing

MAX_UMI_LEN = 14  # cell-counts.c:26


@dataclass
class CellCountsOptions:
    barcode_len: int = 16     # learned from the whitelist (cell-counts.c:280)
    umi_len: int = 10
    min_mapq: int = 0


class BarcodeMatcher:
    """Exact + hamming<=1 cell-barcode matching.

    The reference builds hash tables over half-barcode keys so one lookup
    finds all whitelist entries within hamming 1 (hamming_dist_ATGC_max1_2p,
    input-blc.h:52).  Same structure here: two dicts keyed by each half.
    """

    def __init__(self, whitelist: list[str]):
        lens = {len(b) for b in whitelist}
        assert len(lens) == 1, "all cell barcodes must have equal length"
        self.barcode_len = lens.pop()
        self.barcodes = list(whitelist)
        self.exact = {b: i for i, b in enumerate(self.barcodes)}
        h = self.barcode_len // 2
        self.half = h
        self.by_head: dict[str, list[int]] = {}
        self.by_tail: dict[str, list[int]] = {}
        for i, b in enumerate(self.barcodes):
            self.by_head.setdefault(b[:h], []).append(i)
            self.by_tail.setdefault(b[h:], []).append(i)

    def match(self, bc: str) -> int:
        """Whitelist index, or -1.  Exact first; else unique hamming<=1."""
        hit = self.exact.get(bc)
        if hit is not None:
            return hit
        h = self.half
        cands = set(self.by_head.get(bc[:h], ())) | set(
            self.by_tail.get(bc[h:], ())
        )
        best = -1
        for i in cands:
            w = self.barcodes[i]
            d = sum(1 for a, b in zip(bc, w) if a != b)
            if d <= 1:
                if best >= 0:
                    return -1  # ambiguous rescue -> dropped
                best = i
        return best


def hamming1_umi_merge(umi_counts: dict[str, int]) -> dict[str, int]:
    """Merge UMIs within hamming distance 1 into the most-supported UMI
    (cell-counts.c:3523-3620 sort-merge)."""
    if len(umi_counts) <= 1:
        return umi_counts
    order = sorted(umi_counts, key=lambda u: (-umi_counts[u], u))
    kept: list[str] = []
    merged: dict[str, int] = {}
    for u in order:
        target = None
        for k in kept:
            if len(k) == len(u) and sum(
                1 for a, b in zip(k, u) if a != b
            ) <= 1:
                target = k
                break
        if target is None:
            kept.append(u)
            merged[u] = umi_counts[u]
        else:
            merged[target] += umi_counts[u]
    return merged


class CellCounter:
    """Accumulates (cell, gene) -> set of UMIs, then dedups and emits the
    sparse matrix."""

    def __init__(self, matcher: BarcodeMatcher, gene_names: list[str],
                 umi_len: int = 10):
        self.matcher = matcher
        self.gene_names = gene_names
        self.umi_len = min(umi_len, MAX_UMI_LEN)
        # (cell_idx, gene_idx) -> {umi: reads}
        self.table: dict[tuple[int, int], dict[str, int]] = {}
        self.stats = {
            "reads": 0, "barcode_matched": 0, "assigned": 0,
        }

    def add(self, r1_seq: str, gene_idx: int) -> None:
        self.stats["reads"] += 1
        bl = self.matcher.barcode_len
        cell = self.matcher.match(r1_seq[:bl])
        if cell < 0:
            return
        self.stats["barcode_matched"] += 1
        if gene_idx < 0:
            return
        umi = r1_seq[bl : bl + self.umi_len]
        d = self.table.setdefault((cell, gene_idx), {})
        d[umi] = d.get(umi, 0) + 1
        self.stats["assigned"] += 1

    def finalise(self) -> tuple[np.ndarray, list[int]]:
        """Returns (COO entries [n,3] = (gene, cell, umi_count), cell list)."""
        cells = sorted({c for c, _ in self.table})
        cell_rank = {c: i for i, c in enumerate(cells)}
        entries = []
        for (c, g), umis in sorted(self.table.items()):
            merged = hamming1_umi_merge(umis)
            entries.append((g, cell_rank[c], len(merged)))
        return np.asarray(entries, dtype=np.int64).reshape(-1, 3), cells

    def write_matrix(
        self, out_dir: str, cell_calling: bool = False,
        umi_cutoff: float | None = None,
    ) -> dict:
        """CellRanger-style triplet: matrix.mtx + features.tsv +
        barcodes.tsv.  With cell_calling, only knee-called (+ rescued)
        barcodes are kept (cellCounts_merged_bootstrap_a_sample /
        _ambient_rescure) and the applied UMI cutoff is returned."""
        import os

        os.makedirs(out_dir, exist_ok=True)
        entries, cells = self.finalise()
        info = {"umi_cutoff": 0, "n_cells": len(cells)}
        if cell_calling and len(cells):
            totals = {c: 0 for c in cells}
            for (g, cr, n) in entries:
                totals[cells[cr]] += int(n)
            called, rescued, cutoff = call_cells(totals, umi_cutoff)
            keep = set(called) | set(rescued)
            cells_kept = [c for c in cells if c in keep]
            rank = {c: i for i, c in enumerate(cells_kept)}
            entries = np.asarray(
                [
                    (g, rank[cells[cr]], n)
                    for (g, cr, n) in entries
                    if cells[cr] in keep
                ],
                dtype=np.int64,
            ).reshape(-1, 3)
            cells = cells_kept
            info = {"umi_cutoff": cutoff, "n_cells": len(cells)}
        with open(os.path.join(out_dir, "features.tsv"), "w") as f:
            for g in self.gene_names:
                f.write(f"{g}\t{g}\tGene Expression\n")
        with open(os.path.join(out_dir, "barcodes.tsv"), "w") as f:
            for c in cells:
                f.write(self.matcher.barcodes[c] + "\n")
        with open(os.path.join(out_dir, "matrix.mtx"), "w") as f:
            f.write("%%MatrixMarket matrix coordinate integer general\n")
            f.write(f"{len(self.gene_names)} {len(cells)} {len(entries)}\n")
            for g, c, n in entries:
                f.write(f"{g + 1} {c + 1} {n}\n")
        return info


def write_reference_outputs(
    counter, prefix: str, sample_name: str, annot_rows=None,
    umi_cutoff: float | None = None,
) -> dict:
    """The reference cell-counts artifact set for ONE sample
    (cellCounts_merged_to_tables_write cell-counts.c:4430-4500):
    {prefix}.scRNA.SampleTable, .scRNA.001.{HighConf,RescCand}.{BCtab,
    GENEtab,spmtx}, .scRNA.001.{no0Genes,AmbSum}, and {prefix}.Annot.
    GENEtab lists ALL genes (spmtx row ids index it); BCtab lists the
    called/rescued barcodes; spmtx entries are cell-major."""
    import os

    entries, cells = counter.finalise()
    gene_names = counter.gene_names
    totals = {c: 0 for c in cells}
    per_cell: dict[int, list] = {c: [] for c in cells}
    for (g, cr, n) in entries:
        c = cells[int(cr)]
        totals[c] += int(n)
        per_cell[c].append((int(g), int(n)))
    called, rescued, cutoff = call_cells(totals, umi_cutoff)

    def write_tab(tabtype: str, cell_list: list[int]):
        base = f"{prefix}.scRNA.001.{tabtype}"
        with open(base + ".GENEtab", "w") as f:
            for g in gene_names:
                f.write(g + "\n")
        with open(base + ".BCtab", "w") as f:
            for c in cell_list:
                f.write(counter.matcher.barcodes[c] + "\n")
        rows = []
        for ci, c in enumerate(cell_list):
            for g, n in sorted(per_cell.get(c, ())):
                if n > 0:
                    rows.append((g + 1, ci + 1, n))
        with open(base + ".spmtx", "w") as f:
            f.write("%%MatrixMarket matrix coordinate integer general\n")
            f.write(f"{len(gene_names)} {len(cell_list)} {len(rows)}\n")
            for g1, c1, n in rows:
                f.write(f"{g1} {c1} {n}\n")

    write_tab("HighConf", called)
    write_tab("RescCand", rescued)
    order = sorted(totals, key=lambda c: (-totals[c], c))
    amb_cells = set(order[45000:90000])
    amb: dict[int, int] = {}
    for c in amb_cells:
        for g, n in per_cell.get(c, ()):
            amb[g] = amb.get(g, 0) + n
    with open(f"{prefix}.scRNA.001.AmbSum", "w") as f:
        f.write("GeneID\tUMIs\n")
        for g in sorted(amb):
            f.write(f"{gene_names[g]}\t{amb[g]}\n")
    no0 = sorted({int(g) for (g, _cr, n) in entries if n > 0})
    with open(f"{prefix}.scRNA.001.no0Genes", "w") as f:
        for g in no0:
            f.write(gene_names[g] + "\n")
    with open(f"{prefix}.scRNA.SampleTable", "w") as f:
        f.write("SampleName\tUMICutoff\tTotalReads\tMappedReads"
                "\tAssignedReads\tIndex\n")
        f.write(f"{sample_name}\t{cutoff}\t{counter.stats['reads']}"
                f"\t{counter.stats.get('mapped', counter.stats['reads'])}"
                f"\t{counter.stats['assigned']}\t1\n")
    if annot_rows is not None:
        with open(f"{prefix}.Annot", "w") as f:
            f.write("GeneID\tChr\tStart\tEnd\tStrand\tLength\n")
            for row in annot_rows:
                f.write("\t".join(str(x) for x in row) + "\n")
    return {"umi_cutoff": cutoff, "n_called": len(called)}


def _hamming(a: str, b: str) -> int:
    return sum(1 for x, y in zip(a, b) if x != y)


def demux_bcl(data_dir: str, entries, umi_guess: bool = True):
    """Demultiplex a raw run dir into per-sample (R1, R2) ReadBatches.

    entries: SampleEntry list from the rawdir sample sheet.  The sample
    index read is the IsIndexedRead segment (both for dual index); the
    barcode/UMI read is the first non-index segment and the cDNA read the
    last.  Index matching = exact, then unique hamming<=1 (the reference
    applies the same <=1 rescue to sample indices as to cell barcodes).
    Returns {sample_name: (ReadBatch r1, ReadBatch r2, n_reads)}.
    """
    from ..io.bcl import LANE_ALL, BclReader
    from ..io.fastq import ReadBatch
    from .. import dna

    rd = BclReader(data_dir)
    segs = rd.segments
    nonidx = [i for i, sg in enumerate(segs) if not sg.is_index]
    idxseg = [i for i, sg in enumerate(segs) if sg.is_index]
    assert len(nonidx) >= 2, "need barcode and cDNA reads in RunInfo.xml"
    r1_i, r2_i = nonidx[0], nonidx[-1]

    per_sample: dict[str, list] = {e.sample: [] for e in entries}
    for lane in rd.layout.lanes:
        lr = rd.read_lane(lane)
        cands = [
            e for e in entries if e.lane == LANE_ALL or e.lane == lane
        ]
        if not cands:
            continue
        n = lr.n_pf
        idx_seq = None
        if idxseg:
            idx_mat = np.concatenate(
                [lr.segments[i][0] for i in idxseg], axis=1
            )
            idx_seq = [row.tobytes().decode() for row in idx_mat]
        for r in range(n):
            sample = None
            if idx_seq is None:
                if len(cands) == 1:
                    sample = cands[0].sample
            else:
                q = idx_seq[r]
                best, best_d = None, 2
                ambiguous = False
                for e in cands:
                    want = (e.index or "").replace("-", "")
                    d = _hamming(q, want[: len(q)])
                    if d < best_d:
                        best, best_d, ambiguous = e, d, False
                    elif d == best_d and best is not None:
                        ambiguous = True
                if best is not None and not ambiguous and best_d <= 1:
                    sample = best.sample
            if sample is None:
                continue
            per_sample[sample].append((lane, r))

    out = {}
    for e in entries:
        picks = per_sample[e.sample]
        out[e.sample] = (picks, r1_i, r2_i, rd)
    return out


def batches_from_bcl(picks, r1_i: int, r2_i: int, rd, lane_cache: dict):
    """Build (r1, r2) ReadBatches for one sample's (lane, row) picks."""
    import numpy as np

    from ..io.fastq import ReadBatch
    from .. import dna

    def get_lane(lane):
        if lane not in lane_cache:
            lane_cache[lane] = rd.read_lane(lane)
        return lane_cache[lane]

    def mk_batch(seg_i):
        seqs, quals, names = [], [], []
        for lane, r in picks:
            lr = get_lane(lane)
            seqs.append(lr.segments[seg_i][0][r])
            quals.append(lr.segments[seg_i][1][r])
            names.append(f"R{len(names):08d}:L{lane:03d}")
        if not seqs:
            return None
        seq = np.stack(seqs)
        qual = np.stack(quals)
        n, L = seq.shape
        codes = np.zeros((n, L), np.uint8)
        ambig = np.zeros((n, L), bool)
        for i in range(n):
            srow = seq[i].tobytes()
            codes[i] = dna.encode(srow)
            ambig[i] = dna.ambig_mask(srow)
        return ReadBatch(
            names=names, codes=codes,
            lengths=np.full(n, L, np.int32), quals=qual, ambig=ambig,
        )

    return mk_batch(r1_i), mk_batch(r2_i)


# --- cell calling (knee point + ambient rescue) -----------------------------

SCRNA_BOOTSTRAP_HIGH_INDEX = 30      # cell-counts.c:4370
SCRNA_BOOTSTRAP_SAMPLING_TIMES = 100
SCRNA_IDX_PRIME = 11218439
AMBIENT_RESCUE_MEDIAN_FRACTION = 0.01  # cell-counts.c:4331
MIN_UMIS_FOR_CANDIDATE_RESCUE = 500    # cell-counts.c:4330
MAX_CANDIDATE_CELLS = 20000


def call_cells(
    cell_umis: dict[int, int], umi_cutoff: float | None = None
) -> tuple[list[int], list[int], int]:
    """High-confidence cell calling + ambient-rescue candidates.

    Reference: cellCounts_merged_bootstrap_a_sample (cell-counts.c:4374):
    100 deterministic bootstrap resamples of the per-barcode UMI totals;
    each takes its 30th-highest count / 10 as a threshold and counts
    barcodes above it; the averaged count is the number of called cells
    (CellRanger's knee heuristic).  `--umiCutoff` overrides with a fixed
    threshold.  Ambient rescue (cellCounts_merged_ambient_rescure :4333):
    non-called barcodes with UMIs >= max(1% of the called-cell median, 500)
    become rescue candidates (<= 20000, top 45000 ranks only).

    Returns (called cell ids by descending UMIs, rescue candidates,
    umi_cutoff_used)."""
    order = sorted(cell_umis, key=lambda c: (-cell_umis[c], c))
    n = len(order)
    if n == 0:
        return [], [], 0
    umis_desc = [cell_umis[c] for c in order]

    if umi_cutoff is not None and umi_cutoff >= 0:
        called = [c for c in order if cell_umis[c] >= umi_cutoff - 0.1]
        last_umi = cell_umis[called[-1]] if called else 0
    else:
        total = 0
        seed = n // 2
        for _ in range(SCRNA_BOOTSTRAP_SAMPLING_TIMES):
            resampled = []
            for _x in range(n):
                seed %= n
                resampled.append(umis_desc[seed])
                seed += SCRNA_IDX_PRIME
            resampled.sort()
            hi_idx = max(len(resampled) - SCRNA_BOOTSTRAP_HIGH_INDEX, 0)
            thr = int(resampled[hi_idx] / 10.0 + 0.500000001)
            for v in reversed(resampled):
                if v >= thr:
                    total += 1
                else:
                    break
        n_called = int(total / SCRNA_BOOTSTRAP_SAMPLING_TIMES + 0.500000001)
        called = order[: min(n, n_called)]
        last_umi = cell_umis[called[-1]] if called else 0

    called_set = set(called)
    rescued: list[int] = []
    if called:
        median_umis = cell_umis[called[(len(called) - 1) // 2]]
        cut = int(median_umis * AMBIENT_RESCUE_MEDIAN_FRACTION + 0.500000001)
        for rank, c in enumerate(order):
            if c in called_set:
                continue
            v = cell_umis[c]
            if v < cut or v < MIN_UMIS_FOR_CANDIDATE_RESCUE or rank >= 45000:
                break
            if len(rescued) < MAX_CANDIDATE_CELLS:
                rescued.append(c)
    return called, rescued, last_umi


# --- vectorised batch paths (production-scale scRNA) -----------------------

def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """[n, L<=16] 2-bit codes -> uint32 keys (big-endian-first)."""
    n, L = codes.shape
    out = np.zeros(n, np.uint32)
    for j in range(L):
        out = (out << np.uint32(2)) | codes[:, j].astype(np.uint32)
    return out


class BatchBarcodeMatcher(BarcodeMatcher):
    """BarcodeMatcher's rule, vectorised: packed barcode keys against the
    sorted whitelist; a barcode with no exact hit looks up each of its
    3 x barcode_len single-base substitutions the same way and takes the
    whitelist entry when exactly one is there (BarcodeMatcher.match's
    unique hamming-1 rescue; every whitelist entry within hamming 1 shares
    a half with the barcode, so its half-keyed candidates hold them all).
    Builds no per-barcode dicts.  exact_hits: the exact matches of the
    last match_batch call."""

    exact_hits = 0

    def __init__(self, whitelist: list[str]):
        lens = {len(b) for b in whitelist}
        if len(lens) != 1 or max(lens) > 16:
            raise ValueError("cell barcodes must share one length of at most "
                             "16 bases (they pack into 32 bits)")
        self.barcode_len = lens.pop()
        self.barcodes = list(whitelist)
        self.half = self.barcode_len // 2
        m = np.full(256, 0, np.uint8)
        for i, b in enumerate(b"AGCT"):
            m[b] = i
        wl = np.frombuffer(
            "".join(self.barcodes).encode(), np.uint8
        ).reshape(len(self.barcodes), self.barcode_len)
        self._wl_keys = pack_codes_2bit(m[wl])
        self._wl_order = np.argsort(self._wl_keys)
        self._wl_sorted = self._wl_keys[self._wl_order]

    def match(self, bc: str) -> int:
        return int(self.match_batch(dna.encode(bc)[None, :])[0])

    def match_batch(self, bc_codes: np.ndarray) -> np.ndarray:
        """[n, barcode_len] 2-bit codes -> whitelist index or -1."""
        keys = pack_codes_2bit(bc_codes)
        srt = self._wl_sorted
        j = np.searchsorted(srt, keys)
        j = np.clip(j, 0, len(srt) - 1)
        hit = srt[j] == keys
        out = np.where(hit, self._wl_order[j], -1).astype(np.int32)
        self.exact_hits = int(hit.sum())
        miss = np.flatnonzero(~hit)
        if len(miss):
            L = self.barcode_len
            shift = 2 * (L - 1 - np.arange(L, dtype=np.uint32))
            flips = (np.arange(1, 4, dtype=np.uint32)[:, None] << shift).ravel()
            var = keys[miss, None] ^ flips[None, :]            # [M, 3L]
            lo = np.searchsorted(srt, var, "left")
            n_in = np.searchsorted(srt, var, "right") - lo
            one = n_in.sum(axis=1) == 1
            col = np.argmax(n_in[one] > 0, axis=1)
            out[miss[one]] = self._wl_order[lo[one, col]]
        return out


class AnnotationWeights:
    """Exonic-region candidate weighting (reference cell-counts.c:944-959
    bitmap build; :1535-1570 `cellCounts_calculate_pos_weight`): a
    candidate whose mapped span overlaps an annotated exon carries weight
    10,000,000; within +-100bp of an exon, 13; elsewhere, 10.  The final
    alignment score is matched*1e6/(1+mismatches) * weight
    (`cellCounts_explain_one_read`, cell-counts.c:2612-2620), so
    equal-vote repeat-copy ties deterministically resolve to the
    annotated copy — which is why the reference assigns reads inside
    segmental duplications that plain vote-tie-breaking loses.

    The reference's two 512MB 1-bit-per-base bitmaps become merged,
    sorted linear-coordinate interval arrays + a searchsorted overlap
    test — O(log F) per candidate, vectorised over the [R, K] candidate
    tables the aligner exports with cfg.multi_best > 1."""

    EXONIC = 10_000_000  # SCORING_MAX_QUALITY_MAPPING, cell-counts.c:1533
    NEAR = 13
    BASE = 10

    def __init__(self, ann, genome, chro_aliases=None, pad=100):
        aliases = chro_aliases or {}
        name_to_idx = {n: i for i, n in enumerate(genome.names)}
        starts, ends = [], []
        for i in range(len(ann.feat_start)):
            chro = ann.feat_chro[i]
            chro = aliases.get(chro, chro)
            ci = name_to_idx.get(chro)
            if ci is None:
                continue
            lin0 = genome.chro_to_linear(ci, 0)
            starts.append(lin0 + int(ann.feat_start[i]))
            ends.append(lin0 + int(ann.feat_end[i]))
        self.exon_lo, self.exon_hi = self._merge(starts, ends)
        self.near_lo, self.near_hi = self._merge(
            [s - pad for s in starts], [e + pad for e in ends]
        )

    @staticmethod
    def _merge(starts, ends):
        if not starts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        order = np.argsort(starts, kind="stable")
        s = np.asarray(starts, np.int64)[order]
        e = np.asarray(ends, np.int64)[order]
        lo, hi = [s[0]], [e[0]]
        for i in range(1, len(s)):
            if s[i] <= hi[-1] + 1:
                hi[-1] = max(hi[-1], e[i])
            else:
                lo.append(s[i])
                hi.append(e[i])
        return np.asarray(lo, np.int64), np.asarray(hi, np.int64)

    @staticmethod
    def _overlaps(lo, hi, a, b):
        if not len(lo):
            return np.zeros(np.shape(a), bool)
        idx = np.searchsorted(lo, b, side="right") - 1
        return (idx >= 0) & (hi[np.clip(idx, 0, len(hi) - 1)] >= a)

    def weight(self, a, b):
        """Weight of candidate spans [a, b] (linear, inclusive)."""
        w = np.full(np.shape(a), self.BASE, np.int64)
        w[self._overlaps(self.near_lo, self.near_hi, a, b)] = self.NEAR
        w[self._overlaps(self.exon_lo, self.exon_hi, a, b)] = self.EXONIC
        return w


class CellAnnotation:
    """What cellCounts reads of an annotation, built once: its gene names,
    the featureCounts interval view that assigns a read its gene
    (`assign_genes_batch`), and the exon weights that rescore candidates
    (`select_annotated_candidates`)."""

    def __init__(self, ann, genome, chro_aliases=None):
        from .featurecounts import FCOptions, FeatureCounter

        self.ann = ann
        self.gene_names = ann.gene_names
        self.fcview = FeatureCounter(ann, FCOptions(), chro_aliases=chro_aliases)
        self.weights = AnnotationWeights(ann, genome, chro_aliases=chro_aliases)


def select_annotated_candidates(res, lengths, weights: AnnotationWeights,
                                vote_diff: int = 2):
    """Re-pick each mapped read's reported alignment by the reference
    cellCounts score (`cellCounts_select_and_write_alignments`,
    cell-counts.c:2648-2698): every candidate within `vote_diff` votes of
    the top (maxDiffToTopVotes, default 2, cell-counts.c:524) scores
    matched*1e6/(1+mismatches) * annotation weight; the best score wins.
    Mutates res["pos"/"strand"/"multi"] in place and returns it.

    The reported position is only replaced when the winning candidate is
    a different locus (>64bp away) — same-locus refinements (soft-clip
    advance, junction split) from the main pipeline are kept."""
    if "alt_pos" not in res:
        return res
    SEN = np.uint32(0xFFFFFFFF)
    alt = np.asarray(res["alt_pos"])
    R, K = alt.shape
    mism = np.asarray(res["alt_mism"], np.int64)
    votes = np.asarray(res["alt_votes"], np.int64)
    clip = np.asarray(res["alt_clip"], np.int64)
    L = np.asarray(lengths, np.int64)[:R, None]
    valid = alt != SEN
    top_votes = np.max(np.where(valid, votes, 0), axis=1, keepdims=True)
    eligible = valid & (votes >= top_votes - vote_diff)
    matched = np.maximum(L - clip - mism, 0)
    base = matched * 1_000_000 // (1 + mism)
    lin = alt.astype(np.int64)
    w = weights.weight(lin + 1, lin + L)
    score = np.where(eligible, base * w, -1)
    best = np.argmax(score, axis=1)
    rows = np.arange(R)
    new_pos = alt[rows, best]
    mapped = np.asarray(res["mapped"], bool)[:R]
    cur = np.asarray(res["pos"])[:R].astype(np.int64)
    take = (
        mapped & eligible[rows, best]
        & (np.abs(new_pos.astype(np.int64) - cur) > 64)
    )
    pos = np.asarray(res["pos"]).copy()
    pos[:R][take] = new_pos[take]
    res["pos"] = pos
    strand = np.asarray(res["strand"]).copy()
    strand[:R][take] = np.asarray(res["alt_strand"])[rows, best][take]
    res["strand"] = strand
    timing.count("cellcounts.rescored", int(take.sum()))
    # a weight-resolved tie is unique in the reference's eyes (the
    # score sort leaves one top candidate)
    if "multi" in res:
        n_top = (score == score[rows, best][:, None]).sum(axis=1)
        multi = np.asarray(res["multi"], bool).copy()
        multi[:R][take & (n_top == 1)] = False
        res["multi"] = multi
    return res


def assign_genes_batch(fcview, chro_names, cidx: np.ndarray,
                       start: np.ndarray, end: np.ndarray,
                       mapped: np.ndarray, max_cand: int = 4) -> np.ndarray:
    """Vectorised single-interval gene assignment (the cellCounts read ->
    gene rule: exactly one overlapped gene, else -1).  cidx indexes
    chro_names; start/end are 1-based inclusive."""
    n = len(cidx)
    gene = np.full(n, -1, np.int32)
    for c in np.unique(cidx[mapped]).tolist():
        ci = fcview.by_chrom.get(chro_names[c])
        if ci is None:
            continue
        rows = np.flatnonzero(mapped & (cidx == c))
        if not len(rows):
            continue
        s, e = start[rows], end[rows]
        hi = np.searchsorted(ci.starts, e, side="right")
        n_hit = np.zeros(len(rows), np.int32)
        tgt = np.full(len(rows), -1, np.int64)
        overflow = np.zeros(len(rows), bool)
        for j in range(max_cand):
            cand = hi - 1 - j
            valid = cand >= 0
            cc = np.clip(cand, 0, len(ci.starts) - 1)
            alive = valid & (ci.prefix_max_end[cc] >= s)
            hitj = alive & (ci.ends[cc] >= s)
            t = fcview.feat_target[ci.feat_idx[cc]]
            new = hitj & (n_hit == 0)
            more = hitj & (n_hit > 0) & (t != tgt)
            tgt = np.where(new, t, tgt)
            n_hit = n_hit + new.astype(np.int32) + more.astype(np.int32)
            if j == max_cand - 1:
                overflow = alive & (ci.prefix_max_end[np.clip(cand - 1, 0, len(ci.starts) - 1)] >= s) & (cand - 1 >= 0)
        ok = (n_hit == 1) & ~overflow
        gene[rows[ok]] = tgt[ok].astype(np.int32)
        # overflow rows: fall back to the exact per-read query
        for r in np.flatnonzero(overflow):
            hits = {
                int(fcview.feat_target[int(ci.feat_idx[jj])])
                for jj in ci.query(int(s[r]), int(e[r]))
            }
            gene[rows[r]] = hits.pop() if len(hits) == 1 else -1
    return gene


class BatchCellCounter(CellCounter):
    """CellCounter with packed-array accumulation: each (cell, gene, UMI)
    triple is one key, deduped at finalise time.  The key holds the UMI's
    2 bits a base, the gene and the whitelist index in fields as wide as
    umi_len, the gene list and the whitelist need, in one uint64 where
    they fit and in two words (cell, gene and UMI) where they do not, so
    no two triples share a key.  A (cell, gene)'s UMIs merge in order of
    reads (descending), then of the UMI's 2-bit value (A < G < C < T);
    text_order=True breaks those ties by the UMI's text (A < C < G < T),
    as CellCounter's hamming1_umi_merge does."""

    def __init__(self, matcher, gene_names, umi_len: int = 10,
                 text_order: bool = False):
        super().__init__(matcher, gene_names, umi_len=umi_len)
        self._packed: list[np.ndarray] = []
        self.text_order = text_order
        self._ub = 2 * self.umi_len
        self._gb = max(len(gene_names) - 1, 1).bit_length()
        cell_bits = max(len(matcher.barcodes) - 1, 1).bit_length()
        self._wide = cell_bits + self._gb + self._ub > 64
        for k in ("barcode_exact", "barcode_rescued", "umis", "umi_merged"):
            self.stats[k] = 0

    def add_batch(self, r1_codes: np.ndarray, gene_idx: np.ndarray):
        """r1_codes [n, >= barcode_len+umi_len] 2-bit codes."""
        n = len(gene_idx)
        self.stats["reads"] += n
        bl = self.matcher.barcode_len
        cells = self.matcher.match_batch(r1_codes[:, :bl])
        okc = cells >= 0
        matched = int(okc.sum())
        exact = getattr(self.matcher, "exact_hits", matched)
        self.stats["barcode_matched"] += matched
        self.stats["barcode_exact"] += exact
        self.stats["barcode_rescued"] += matched - exact
        timing.count("cellcounts.barcode_exact", exact)
        timing.count("cellcounts.barcode_rescued", matched - exact)
        timing.count("cellcounts.barcode_unmatched", n - matched)
        ok = okc & (gene_idx >= 0)
        self.stats["assigned"] += int(ok.sum())
        if not ok.any():
            return
        umi = pack_codes_2bit(
            r1_codes[ok, bl : bl + self.umi_len]
        ).astype(np.uint64)
        lo = (gene_idx[ok].astype(np.uint64) << np.uint64(self._ub)) | umi
        cell = cells[ok].astype(np.uint64)
        if self._wide:
            packed = np.empty(len(lo), [("cell", np.uint64), ("lo", np.uint64)])
            packed["cell"], packed["lo"] = cell, lo
        else:
            packed = (cell << np.uint64(self._gb + self._ub)) | lo
        self._packed.append(packed)

    def _fields(self, keys: np.ndarray):
        """Keys -> (cell, gene, UMI) as int64, int64, uint64."""
        if keys.dtype.names:
            cell, lo = keys["cell"].astype(np.int64), keys["lo"]
        else:
            w = np.uint64(self._gb + self._ub)
            cell = (keys >> w).astype(np.int64)
            lo = keys & ((np.uint64(1) << w) - np.uint64(1))
        ub = np.uint64(self._ub)
        return (cell, (lo >> ub).astype(np.int64),
                lo & ((np.uint64(1) << ub) - np.uint64(1)))

    def finalise(self):
        """Array-native finalise: unique (cell,gene,umi) triples, per-group
        hamming<=1 UMI merging only where a group holds >1 unique UMI."""
        if self.table:
            # mixed scalar+batch use: push packed triples into the dict
            dec = "AGCT"
            for arr in self._packed:
                uniq, counts = np.unique(arr, return_counts=True)
                for c, g, u, n in zip(*self._fields(uniq), counts):
                    u = int(u)
                    us = "".join(
                        dec[(u >> (2 * (self.umi_len - 1 - j))) & 3]
                        for j in range(self.umi_len)
                    )
                    d = self.table.setdefault((int(c), int(g)), {})
                    d[us] = d.get(us, 0) + int(n)
            self._packed = []
            return super().finalise()
        if not self._packed:
            return np.zeros((0, 3), np.int64).reshape(-1, 3), []
        allp = np.concatenate(self._packed)
        uniq, counts = np.unique(allp, return_counts=True)
        cell, gene, umi = self._fields(uniq)
        new = np.concatenate(([True], (cell[1:] != cell[:-1])
                              | (gene[1:] != gene[:-1])))
        starts = np.flatnonzero(new)
        ends = np.concatenate((starts[1:], [len(uniq)]))
        sizes = ends - starts
        n_umis = sizes.copy()
        if self.text_order:
            # A G C T -> A C G T: swap the codes 1 and 2 of every base
            d = (umi ^ (umi >> np.uint64(1))) & np.uint64(0x5555555555555555)
            umi_order = umi ^ (d | (d << np.uint64(1)))
        else:
            umi_order = umi
        # hamming<=1 merge only in multi-UMI groups (the rare case)
        for gi in np.flatnonzero(sizes > 1):
            lo, hi = int(starts[gi]), int(ends[gi])
            us = umi[lo:hi]
            cs = counts[lo:hi]
            order = np.lexsort((umi_order[lo:hi], -cs))
            kept = []
            for i in order:
                u = int(us[i])
                merged = False
                for k in kept:
                    x = u ^ k
                    # hamming<=1 in base space: the XOR's set bits fit in
                    # ONE 2-bit group
                    grp = (x.bit_length() - 1) // 2 if x else 0
                    if x & ~(0b11 << (2 * grp)) == 0:
                        merged = True
                        break
                if not merged:
                    kept.append(u)
            n_umis[gi] = len(kept)
        self.stats["umis"] += len(uniq)
        self.stats["umi_merged"] += int(len(uniq) - n_umis.sum())
        timing.count("cellcounts.umis", len(uniq))
        timing.count("cellcounts.umi_groups_merged", int(len(uniq) - n_umis.sum()))
        cells_all = cell[starts]
        genes_all = gene[starts]
        cells, rank = np.unique(cells_all, return_inverse=True)
        entries = np.stack([
            genes_all,
            rank.astype(np.int64),
            n_umis.astype(np.int64),
        ], axis=1)
        return entries, cells.tolist()
