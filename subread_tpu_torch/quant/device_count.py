"""Copy of `subread_tpu/quant/device_count.py` (the host half), with the
device half ported to torch ops: the port imports nothing of the JAX package.

The host half is the JAX package's, only its imports changed: the span
tables and their sparse-table RMQ, and the section parsers
(`sections_from_sam`, `fragments_from_sam`, and `sections_from_file` /
`fragments_from_file` over the native record parser).

The device half (`_kernel`, `count`) runs on the counter's device, which
the caller names (`device`, default "cuda", refused when no card is
present).  The span and RMQ tables are uploaded once, at construction.
Per read section two `torch.searchsorted` calls find the range [lo, hi)
of disjoint spans it touches and six gathers fold the RMQ levels
floor(log2(hi - lo)) at lo and hi - 2**k; `device.floor_log2` stands in
for JAX's `31 - clz`.  Every table and section array is int32, as in the
JAX package, so the outputs match it in values and dtypes: counts
[n_genes], summary [5] and status [R], all int32, and overflow 0.

`count_sharded` splits the records over the devices of a mesh axis,
runs `_kernel` on each part with the tables uploaded once per distinct
device, and sums counts, summary and overflow on the mesh's first device:
the JAX package's `psum`.

Reference model: featureCounts walks each thread's reads through a
per-chromosome sorted feature table (binary search + scan-back,
readSummary.c:1592-1680) into per-thread count tables merged at the end
(`fc_thread_merge_results`, readSummary.c:5795).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ..device import floor_log2, resolve_device, upload
from ..parallel.mesh import axis_devices, mesh_devices, row_blocks

NONE = -1  # label: no feature covers this span

# per-read status codes (summary row order mirrors SUMMARY_CATEGORIES)
ST_ASSIGNED = 0
ST_UNMAPPED = 1
ST_MULTIMAPPING = 2
ST_NOFEATURES = 3
ST_AMBIGUITY = 4
ST_PAD = 5  # shard padding; dropped from the summary

STATUS_NAMES = [
    "Assigned",
    "Unassigned_Unmapped",
    "Unassigned_MultiMapping",
    "Unassigned_NoFeatures",
    "Unassigned_Ambiguity",
]

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def _merge_gene_intervals(ann):
    """Per-gene merged exon intervals: {(gene, chro): [(s, e), ...]}."""
    order = np.lexsort((ann.feat_start, ann.feat_gene))
    merged: dict[tuple[int, str], list[tuple[int, int]]] = {}
    for i in order:
        key = (int(ann.feat_gene[i]), ann.feat_chro[i])
        s, e = int(ann.feat_start[i]), int(ann.feat_end[i])
        ivs = merged.setdefault(key, [])
        if ivs and s <= ivs[-1][1] + 1:
            ivs[-1] = (ivs[-1][0], max(ivs[-1][1], e))
        else:
            ivs.append((s, e))
    return merged


def _build_spans_for_chrom(events):
    """Sweep one chromosome's (pos, delta, gene) events into disjoint
    spans [(start, end_inclusive, label)] where label is a gene index
    when exactly one gene covers the span, MULTI(-2 placeholder) when
    several do.  Zero-coverage gaps are not emitted."""
    events.sort()
    spans = []
    active: dict[int, int] = {}
    prev_pos = None
    i, n = 0, len(events)
    while i < n:
        pos = events[i][0]
        if active and prev_pos is not None and prev_pos <= pos - 1:
            label = next(iter(active)) if len(active) == 1 else -2
            spans.append((prev_pos, pos - 1, label))
        while i < n and events[i][0] == pos:
            _, delta, g = events[i]
            c = active.get(g, 0) + delta
            if c:
                active[g] = c
            else:
                active.pop(g, None)
            i += 1
        prev_pos = pos
    # coalesce adjacent same-label spans (keeps the per-section span
    # window W small)
    out = []
    for s, e, lab in spans:
        if out and out[-1][2] == lab and out[-1][1] + 1 == s:
            out[-1] = (out[-1][0], e, lab)
        else:
            out.append((s, e, lab))
    return out


@dataclass
class _ChromWindow:
    offset: int     # global coordinate of local position 0
    max_end: int    # largest annotated end on this chromosome (local)


class DeviceCounter:
    """Device-side gene-level read counter over a fixed annotation.

    ``W`` bounds how many disjoint spans one read section may touch; the
    kernel reports an overflow count so the host can fall back for the
    (annotation, read-length) combinations that exceed it.
    """

    def __init__(self, annotation, strand: int = 0, w: int = 16,
                 max_sections: int = 10, device="cuda"):
        self.device = resolve_device(device)
        self.ann = annotation
        self.strand = int(strand)
        self.w = int(w)
        self.max_sections = int(max_sections)
        self.n_genes = len(annotation.gene_names)
        self.multi = self.n_genes  # sentinel label: >=2 genes cover span

        # fragment strand must match the feature strand unless the
        # feature is unstranded ('.').  With -s we build one span table
        # per fragment strand from the matching feature subset.
        n_tables = 1 if self.strand == 0 else 2
        self._tables = []
        self._windows: list[dict[str, _ChromWindow]] = []
        for t in range(n_tables):
            if self.strand == 0:
                keep = np.ones(annotation.n_features, dtype=bool)
            else:
                fs = annotation.feat_strand
                keep = (fs == t) | (fs == 2)
            self._tables.append(self._build_table(keep))
        # sparse-table RMQ over each span-label array: range min / max /
        # contains-multi answered with 2 gathers per section instead of a
        # W-wide label gather ([R,S,W] was ~96M gathered elements per 1M
        # records — the whole kernel cost) and with NO width cap, so the
        # overflow path disappears
        self._rmq = [self._build_rmq(t[2]) for t in self._tables]
        # uploaded once: (span starts, span ends, RMQ min, max, is-multi)
        self._dev_tables = [
            tuple(upload(np.ascontiguousarray(a), self.device)
                  for a in (t[0], t[1], *r[:3]))
            for t, r in zip(self._tables, self._rmq)
        ]
        # keyed by the device with a card's index explicit, as a mesh names it
        self._tables_by_device = {mesh_devices([self.device])[0]: self._dev_tables}

    def _build_table(self, keep: np.ndarray):
        ann = self.ann
        merged = _merge_gene_intervals(_AnnView(ann, keep))
        by_chrom: dict[str, list] = {}
        for (g, chro), ivs in merged.items():
            ev = by_chrom.setdefault(chro, [])
            for s, e in ivs:
                ev.append((s, 1, g))
                ev.append((e + 1, -1, g))
        chroms = sorted(by_chrom)
        starts, ends, labels = [], [], []
        windows: dict[str, _ChromWindow] = {}
        offset = 0
        for chro in chroms:
            spans = _build_spans_for_chrom(by_chrom[chro])
            if not spans:
                continue
            max_end = max(e for _, e, _ in spans)
            win = _ChromWindow(offset=offset, max_end=max_end)
            # fuzzy aliases as in FeatureCounter (chr prefix, case)
            aliases = {chro, chro.lower(),
                       chro[3:] if chro.lower().startswith("chr")
                       else "chr" + chro}
            for a in aliases:
                windows.setdefault(a, win)
            windows[chro] = win
            for s, e, lab in spans:
                starts.append(offset + s)
                ends.append(offset + e)
                labels.append(self.multi if lab == -2 else lab)
            offset += max_end + 2
        if offset >= 2**31:
            raise ValueError("annotation coordinate space exceeds int32")
        self._windows.append(windows)
        return (
            np.asarray(starts, dtype=np.int32),
            np.asarray(ends, dtype=np.int32),
            np.asarray(labels, dtype=np.int32),
        )

    # ------------------------------------------------------------------
    # host-side read preparation

    def sections_from_sam(self, path: str):
        """Parse a SAM file into the kernel's input arrays.

        Returns (sec_start[R,S], sec_end[R,S], gate[R]) int32 arrays in
        *global* coordinates.  gate pre-resolves the host-side gates:
        0 ok, ST_UNMAPPED, ST_MULTIMAPPING.  Sections on chromosomes
        absent from the annotation are dropped (NoFeatures when none
        remain, matching readSummary.c's unmatched-chromosome warning
        path)."""
        S = self.max_sections
        starts, ends, gates, strands = [], [], [], []
        with open(path) as f:
            for line in f:
                if line.startswith("@"):
                    continue
                fds = line.rstrip("\n").split("\t")
                flag = int(fds[1])
                # each record is its own SE fragment, exactly as the
                # host FeatureCounter streams them (count_sam)
                if flag & 0x4 or fds[5] == "*":
                    starts.append([0] * S)
                    ends.append([-1] * S)
                    gates.append(ST_UNMAPPED)
                    strands.append(0)
                    continue
                nh = 1
                for t in fds[11:]:
                    if t.startswith("NH:i:"):
                        nh = int(t[5:])
                        break
                if nh > 1:
                    starts.append([0] * S)
                    ends.append([-1] * S)
                    gates.append(ST_MULTIMAPPING)
                    strands.append(0)
                    continue
                secs = self._cigar_sections(int(fds[3]), fds[5])
                strand_bit = 1 if (flag & 0x10) else 0
                tbl = 0
                if self.strand:
                    tbl = strand_bit if self.strand == 1 else strand_bit ^ 1
                win = self._windows[tbl]
                row_s, row_e = [], []
                cw = win.get(fds[2])
                if cw is not None:
                    for s, e in secs[:S]:
                        if s > cw.max_end:
                            continue
                        row_s.append(cw.offset + s)
                        row_e.append(cw.offset + min(e, cw.max_end))
                row_s += [0] * (S - len(row_s))
                row_e += [-1] * (S - len(row_e))
                starts.append(row_s)
                ends.append(row_e)
                gates.append(0)
                strands.append(tbl)
        return (
            np.asarray(starts, dtype=np.int32).reshape(-1, S),
            np.asarray(ends, dtype=np.int32).reshape(-1, S),
            np.asarray(gates, dtype=np.int32),
            np.asarray(strands, dtype=np.int32),
        )

    def fragments_from_sam(self, path: str):
        """PE variant of sections_from_sam: records pair by QNAME (orphan
        hash, arbitrary order) and each FRAGMENT contributes the union of
        both ends' sections — the default `-p --countReadPairs` fragment
        semantics (readSummary.c:2924 PE path, default gates).  Secondary/
        supplementary records are skipped like the host counter's default
        path.  Returns the same arrays as sections_from_sam with one row
        per fragment."""
        S = self.max_sections
        pending: dict[str, tuple] = {}
        starts, ends, gates, strands = [], [], [], []

        def emit(r1, r2):
            # r = (mapped, nh, chro, secs, strand_bit) or None for a
            # missing mate (orphan flushed at EOF)
            ms = [r for r in (r1, r2) if r is not None]
            if not any(r[0] for r in ms):
                starts.append([0] * S)
                ends.append([-1] * S)
                gates.append(ST_UNMAPPED)
                strands.append(0)
                return
            if any(r[0] and r[1] > 1 for r in ms):
                starts.append([0] * S)
                ends.append([-1] * S)
                gates.append(ST_MULTIMAPPING)
                strands.append(0)
                return
            tbl = 0
            first = next(r for r in ms if r[0])
            if self.strand:
                tbl = first[4] if self.strand == 1 else first[4] ^ 1
            win = self._windows[tbl]
            row_s, row_e = [], []
            for r in ms:
                if not r[0]:
                    continue
                cw = win.get(r[2])
                if cw is None:
                    continue
                for s, e in r[3]:
                    if s > cw.max_end or len(row_s) >= S:
                        continue
                    row_s.append(cw.offset + s)
                    row_e.append(cw.offset + min(e, cw.max_end))
            row_s += [0] * (S - len(row_s))
            row_e += [-1] * (S - len(row_e))
            starts.append(row_s)
            ends.append(row_e)
            gates.append(0)
            strands.append(tbl)

        with open(path) as f:
            for line in f:
                if line.startswith("@"):
                    continue
                fds = line.rstrip("\n").split("\t")
                flag = int(fds[1])
                if flag & 0x900:       # secondary/supplementary
                    continue
                mapped = not (flag & 0x4) and fds[5] != "*"
                nh = 1
                for t in fds[11:]:
                    if t.startswith("NH:i:"):
                        nh = int(t[5:])
                        break
                secs = (
                    self._cigar_sections(int(fds[3]), fds[5]) if mapped else []
                )
                rec = (mapped, nh, fds[2], secs, 1 if (flag & 0x10) else 0)
                other = pending.pop(fds[0], None)
                if other is None:
                    pending[fds[0]] = rec
                else:
                    emit(other, rec)
        for rec in pending.values():
            emit(rec, None)
        return (
            np.asarray(starts, dtype=np.int32).reshape(-1, S),
            np.asarray(ends, dtype=np.int32).reshape(-1, S),
            np.asarray(gates, dtype=np.int32),
            np.asarray(strands, dtype=np.int32),
        )

    def _cigar_sections(self, pos: int, cigar: str):
        """Mirror of featurecounts._sections (same max_mop / D / N
        semantics) on (pos, cigar) directly."""
        secs = []
        p = pos
        sec_start = None
        n_m = 0
        for ln, op in _CIG_RE.findall(cigar):
            ln = int(ln)
            if op in "M=X":
                n_m += 1
                if n_m > self.max_sections:
                    break
                if sec_start is None:
                    sec_start = p
                p += ln
            elif op == "D":
                p += ln
            elif op == "N":
                if sec_start is not None:
                    secs.append((sec_start, p - 1))
                    sec_start = None
                p += ln
        if sec_start is not None:
            secs.append((sec_start, p - 1))
        return secs

    def _build_rmq(self, labels: np.ndarray):
        """Sparse tables over span labels: (min, max, is-multi max), each
        flattened [K*G] so the kernel gathers level k at k*G + i.  Level k
        row i covers spans [i, i + 2**k); a range [lo, hi) is the fold of
        levels floor(log2(hi-lo)) at lo and hi - 2**k."""
        G = len(labels)
        if G == 0:
            z = np.zeros(1, np.int32)
            return z, z.copy(), z.copy(), 1, 1
        K = max(1, int(G).bit_length())
        rmin = np.empty((K, G), np.int32)
        rmax = np.empty((K, G), np.int32)
        rmul = np.empty((K, G), np.int32)
        rmin[0] = labels
        rmax[0] = labels
        rmul[0] = (labels == self.multi).astype(np.int32)
        idx = np.arange(G)
        for k in range(1, K):
            h = 1 << (k - 1)
            j = np.minimum(idx + h, G - 1)
            rmin[k] = np.minimum(rmin[k - 1], rmin[k - 1][j])
            rmax[k] = np.maximum(rmax[k - 1], rmax[k - 1][j])
            rmul[k] = np.maximum(rmul[k - 1], rmul[k - 1][j])
        return rmin.reshape(-1), rmax.reshape(-1), rmul.reshape(-1), K, G

    # ------------------------------------------------------------------
    # device kernel

    def _tables_on(self, device):
        """The span and RMQ tables on `device`, uploaded once per device."""
        device = mesh_devices([device])[0]
        if device not in self._tables_by_device:
            self._tables_by_device[device] = [
                tuple(t.to(device) for t in tbl) for tbl in self._dev_tables]
        return self._tables_by_device[device]

    def _kernel(self, sec_start, sec_end, gate, strand_tbl, tables=None):
        """Global-coord sections -> (counts, summary, status, overflow), as
        int32 tensors on the counter's device, or on the device of
        `tables` (`_tables_on`) when given (overflow a Python 0).

        Per-section gene evidence (range min / max / contains-multi over
        the covering spans [lo, hi)) comes from sparse-table RMQ lookups:
        6 gathers per section, exact for any span-run width."""
        valid = sec_end >= sec_start  # invalid rows use (0, -1)
        i32 = torch.int32

        def one_table(tbl_idx):
            span_s, span_e, d_min, d_max, d_mul = (
                tables or self._dev_tables)[tbl_idx]
            G = self._rmq[tbl_idx][4]
            lo = torch.searchsorted(span_e, sec_start, out_int32=True)
            hi = torch.searchsorted(span_s, sec_end, right=True,
                                    out_int32=True)
            n = hi - lo
            ok = valid & (n > 0)
            k = floor_log2(n.clamp_min(1))        # < the RMQ's levels
            # an empty table (G = 0) has one padding entry: index 0
            top = max(G - 1, 0)
            i1 = lo.clamp(0, top)
            i2 = (hi - (1 << k)).clamp(0, top)
            kG = k.long() * G
            j1, j2 = kG + i1, kG + i2
            vmin = torch.minimum(d_min[j1], d_min[j2])
            vmax = torch.maximum(d_max[j1], d_max[j2])
            mul = torch.maximum(d_mul[j1], d_mul[j2])
            vmin = torch.where(ok, vmin, 1 << 30)
            vmax = torch.where(ok, vmax, -1)
            mul = torch.where(ok, mul, 0)
            return vmin, vmax, mul

        if len(tables or self._dev_tables) == 1:
            vmin_s, vmax_s, mul_s = one_table(0)
        else:
            a0 = one_table(0)
            a1 = one_table(1)
            pick = strand_tbl[:, None].bool()
            vmin_s = torch.where(pick, a1[0], a0[0])
            vmax_s = torch.where(pick, a1[1], a0[1])
            mul_s = torch.where(pick, a1[2], a0[2])

        overflow = 0  # RMQ is width-exact; no cap remains
        vmax = vmax_s.amax(dim=1)
        vmin = vmin_s.amin(dim=1)
        any_valid = vmax >= 0
        n_distinct = torch.where(
            any_valid, 1 + (vmax != vmin).to(i32), 0
        )
        has_multi = (mul_s > 0).any(dim=1)
        gene = vmax

        status = torch.full_like(gate, ST_ASSIGNED)
        status = torch.where(n_distinct == 0, ST_NOFEATURES, status)
        status = torch.where(has_multi | (n_distinct >= 2), ST_AMBIGUITY,
                             status)
        status = torch.where(gate > 0, gate, status)
        assigned = status == ST_ASSIGNED
        counts = torch.zeros(self.n_genes, dtype=i32, device=gate.device)
        if self.n_genes:
            # integer adds: exact whatever order the atomics take
            counts.index_add_(0, torch.where(assigned, gene, 0).long(),
                              assigned.to(i32))
        # ST_PAD (5) is counted in slot 5 and dropped
        summary = torch.bincount(status.long(), minlength=6)[:5].to(i32)
        return counts, summary, status, overflow

    # ------------------------------------------------------------------
    # native-parsed fast input path

    def _chrom_universe(self):
        u = []
        seen = set()
        for win in self._windows:
            for n in win:
                if n not in seen:
                    seen.add(n)
                    u.append(n)
        return u

    def _window_arrays(self, chrom_names):
        """Per-table (offset, max_end) vectors over the chrom universe
        (offset -1 = chromosome absent from that table)."""
        outs = []
        for win in self._windows:
            off = np.full(len(chrom_names) + 1, -1, np.int64)
            me = np.zeros(len(chrom_names) + 1, np.int64)
            for i, n in enumerate(chrom_names):
                cw = win.get(n)
                if cw is not None:
                    off[i] = cw.offset
                    me[i] = cw.max_end
            outs.append((off, me))
        return outs

    def _map_sections(self, ci, nsec, ss, se, tbl, offs):
        """Local 1-based sections -> global window coordinates (empty
        slots become (0, -1); sections past the table's max_end drop)."""
        R, S = ss.shape
        ci_s = np.where(ci >= 0, ci, len(offs[0][0]) - 1)
        off = np.stack([o[ci_s] for o, _ in offs])     # [T, R]
        me = np.stack([m[ci_s] for _, m in offs])      # [T, R]
        off_r = np.take_along_axis(off, tbl[None, :], axis=0)[0]
        me_r = np.take_along_axis(me, tbl[None, :], axis=0)[0]
        slot = np.arange(S, dtype=np.int32)[None, :]
        ok = (
            (slot < nsec[:, None]) & (off_r[:, None] >= 0)
            & (ss <= me_r[:, None])
        )
        g_s = np.where(ok, ss + off_r[:, None], 0).astype(np.int32)
        g_e = np.where(
            ok, np.minimum(se, me_r[:, None]) + off_r[:, None], -1
        ).astype(np.int32)
        return g_s, g_e

    def sections_from_file(self, path: str):
        """SE sections via the native record parser (SAM text, BAM, or
        BGZF-compressed BAM; fc_read_sections_sam/_bam) with vectorised
        window mapping — the end-to-end fast path for --deviceCounts.
        Falls back to sections_from_sam when the native library is
        unavailable (SAM only).  Gate note: a flag-mapped record with
        CIGAR '*' gates as NoFeatures here (the slow path says
        Unassigned_Unmapped); such records are malformed SAM."""
        arrays = self._native_records(path)
        if arrays is None:
            return self.sections_from_sam(path)
        ci, nsec, ss, se, flag, nh, _qh = arrays
        chroms = self._chrom_universe()
        offs = self._window_arrays(chroms)
        R = len(ci)
        # trim the padded section width to this batch's real maximum
        # (bucketed so the kernel compiles a handful of shapes): typical
        # BAMs are S=1-2, not the max_sections=10 pad — 5-10x less
        # mapping/upload/kernel work
        s_eff = int(nsec.max()) if R else 1
        for b in (1, 2, 4, 6, self.max_sections):
            if s_eff <= b:
                s_eff = b
                break
        ss = np.ascontiguousarray(ss[:, :s_eff])
        se = np.ascontiguousarray(se[:, :s_eff])
        strand_bit = ((flag >> 4) & 1).astype(np.int32)
        tbl = np.zeros(R, dtype=np.int32)
        if self.strand:
            tbl = strand_bit if self.strand == 1 else strand_bit ^ 1
        gate = np.zeros(R, dtype=np.int32)
        unmapped = (flag & 4) != 0
        gate[unmapped] = ST_UNMAPPED
        gate[~unmapped & (nh > 1)] = ST_MULTIMAPPING
        live = gate == 0
        nsec = np.where(live, nsec, 0)
        tbl = np.where(live, tbl, 0)       # gated rows report table 0
        g_s, g_e = self._map_sections(ci, nsec, ss, se, tbl, offs)
        return g_s, g_e, gate, tbl

    def fragments_from_file(self, path: str):
        """PE fragments via the native record parser: records pair by
        qname hash (sorted by (hash, arrival), consecutive pairs — the
        orphan-hash pop order of fragments_from_sam), each fragment
        unioning both ends' sections up to max_sections."""
        arrays = self._native_records(path)
        if arrays is None:
            return self.fragments_from_sam(path)
        ci, nsec, ss, se, flag, nh, qh = arrays
        # input-width trim (see sections_from_file); the fragment union
        # of two ends needs up to twice the per-record width
        s_in = int(nsec.max()) if len(ci) else 1
        for b in (1, 2, 4, 6, self.max_sections):
            if s_in <= b:
                s_in = b
                break
        ss = np.ascontiguousarray(ss[:, :s_in])
        se = np.ascontiguousarray(se[:, :s_in])
        S = min(self.max_sections, 2 * s_in)
        keep = (flag & 0x900) == 0          # drop secondary/supplementary
        ci, nsec, ss, se = ci[keep], nsec[keep], ss[keep], se[keep]
        flag, nh, qh = flag[keep], nh[keep], qh[keep]
        R = len(ci)
        order = np.argsort(qh, kind="stable")
        runs = np.concatenate([[True], qh[order][1:] != qh[order][:-1]])
        run_id = np.cumsum(runs) - 1
        # rank within run
        run_start = np.zeros(len(runs), np.int64)
        first_of_run = np.flatnonzero(runs)
        pos_in_sorted = np.arange(R)
        rank = pos_in_sorted - first_of_run[run_id]
        frag_of_sorted = np.cumsum(rank % 2 == 0) - 1
        F = int(frag_of_sorted[-1]) + 1 if R else 0
        is_first = (rank % 2) == 0

        mapped = ((flag & 4) == 0)
        # fragment gates (emit(), fragments_from_sam)
        any_mapped = np.zeros(F, bool)
        any_multi = np.zeros(F, bool)
        np.logical_or.at(any_mapped, frag_of_sorted, mapped[order])
        np.logical_or.at(
            any_multi, frag_of_sorted, mapped[order] & (nh[order] > 1)
        )
        gate = np.where(
            ~any_mapped, ST_UNMAPPED, np.where(any_multi, ST_MULTIMAPPING, 0)
        ).astype(np.int32)

        # fragment strand table = first mapped end in arrival order:
        # prefer the first-arrival record when mapped, else the second
        strand_bit = ((flag >> 4) & 1).astype(np.int32)
        tbl = np.zeros(F, np.int32)
        if self.strand:
            sb = np.full(F, -1, np.int32)
            # second arrival first, then first arrival overwrites if mapped
            sel2 = ~is_first & mapped[order]
            sb[frag_of_sorted[sel2]] = strand_bit[order][sel2]
            sel1 = is_first & mapped[order]
            sb[frag_of_sorted[sel1]] = strand_bit[order][sel1]
            sb = np.maximum(sb, 0)
            tbl = sb if self.strand == 1 else sb ^ 1
            tbl = np.where(gate == 0, tbl, 0)

        # map each record's sections with its OWN chromosome but the
        # FRAGMENT's strand table (emit() does exactly this per end),
        # then union into the fragment row: first arrival's sections lead
        chroms = self._chrom_universe()
        offs = self._window_arrays(chroms)
        live = gate == 0
        tbl_rec = tbl[frag_of_sorted]
        nsec_k = np.where(live[frag_of_sorted] & mapped[order],
                          nsec[order], 0).astype(np.int64)
        g_s_rec, g_e_rec = self._map_sections(
            ci[order], nsec_k.astype(np.int32), ss[order], se[order],
            tbl_rec, offs
        )
        # dropped sections (past max_end / absent chrom) leave empty
        # slots; compact the survivor count per record
        slot_ok = g_e_rec >= g_s_rec
        n1 = np.zeros(F, np.int64)
        np.add.at(n1, frag_of_sorted[is_first], slot_ok[is_first].sum(1))
        base = np.where(is_first, 0, n1[frag_of_sorted])
        out_s = np.zeros((F, S), np.int32)
        out_e = np.full((F, S), -1, np.int32)
        rows_k, slots_k = np.nonzero(slot_ok)
        within = (
            np.cumsum(slot_ok.reshape(-1))
            .reshape(slot_ok.shape)[rows_k, slots_k]
        )
        first_flat = np.zeros(R, np.int64)
        if R:
            row_counts = slot_ok.sum(1)
            first_flat[1:] = np.cumsum(row_counts)[:-1]
        within = within - 1 - first_flat[rows_k]
        dst = base[rows_k] + within
        ok = dst < S
        out_s[frag_of_sorted[rows_k[ok]], dst[ok]] = g_s_rec[rows_k[ok], slots_k[ok]]
        out_e[frag_of_sorted[rows_k[ok]], dst[ok]] = g_e_rec[rows_k[ok], slots_k[ok]]
        return out_s, out_e, gate, tbl

    def _native_records(self, path: str):
        from .. import native

        S = self.max_sections
        with open(path, "rb") as f:
            head = f.read(4)
        chroms = self._chrom_universe()
        if head[:2] == b"\x1f\x8b" or head == b"BAM\x01":
            from ..io.bam import BamReader

            rd = BamReader(path)
            name_to_ci = {n: i for i, n in enumerate(chroms)}
            ref2chrom = np.asarray(
                [name_to_ci.get(n, -1) for n in rd.ref_names], np.int32
            )
            return native.fc_read_sections_bam(
                rd._data, ref2chrom, S, start=rd._off
            )
        return native.fc_read_sections_sam(
            open(path, "rb").read(), chroms, S
        )

    def count(self, sec_start, sec_end, gate, strand_tbl=None):
        """Count on the counter's device.  Takes the int32 numpy arrays of
        sections_from_* and returns numpy (counts[n_genes], summary[5],
        status[R], overflow), as the JAX package's count does."""
        if strand_tbl is None:
            strand_tbl = np.zeros(sec_start.shape[0], dtype=np.int32)
        dev = self.device
        up = lambda a: upload(np.ascontiguousarray(a, dtype=np.int32), dev)
        c, s, st, ov = self._kernel(
            up(sec_start), up(sec_end), up(gate), up(strand_tbl)
        )
        return (c.cpu().numpy(), s.cpu().numpy(), st.cpu().numpy(), int(ov))

    def count_sharded(self, mesh, sec_start, sec_end, gate,
                      strand_tbl=None, axis: str = "reads"):
        """Multi-device counting: records split over the devices of mesh
        axis `axis` (padded as the JAX package pads: ST_PAD gates and -1
        section ends), `_kernel` on each part, every part launched before
        any is summed, and the per-part counts, summary and overflow
        summed on the mesh's first device (fc_thread_merge_results's
        equivalent).  Returns the same tuple as :meth:`count` minus the
        per-read status."""
        devs = axis_devices(mesh, axis)
        n = len(devs)
        R = sec_start.shape[0]
        pad = (-R) % n
        if strand_tbl is None:
            strand_tbl = np.zeros(R, dtype=np.int32)
        if pad:
            sec_start = np.pad(sec_start, ((0, pad), (0, 0)))
            sec_end = np.pad(
                sec_end, ((0, pad), (0, 0)), constant_values=-1
            )
            gate = np.pad(gate, (0, pad), constant_values=ST_PAD)
            strand_tbl = np.pad(strand_tbl, (0, pad))
        parts = []
        for d, sl in zip(devs, row_blocks(R + pad, n)):
            up = lambda a: upload(np.ascontiguousarray(a[sl], dtype=np.int32), d)
            parts.append(self._kernel(up(sec_start), up(sec_end), up(gate),
                                      up(strand_tbl), tables=self._tables_on(d)))
        home = devs[0]
        c = sum(p[0].to(home) for p in parts)
        s = sum(p[1].to(home) for p in parts)
        ov = sum(int(p[3]) for p in parts)
        return c.cpu().numpy(), s.cpu().numpy(), ov


class _AnnView:
    """Annotation restricted to a feature mask (for stranded tables)."""

    def __init__(self, ann, keep):
        idx = np.flatnonzero(keep)
        self.feat_start = ann.feat_start[idx]
        self.feat_end = ann.feat_end[idx]
        self.feat_gene = ann.feat_gene[idx]
        self.feat_chro = [ann.feat_chro[i] for i in idx]
