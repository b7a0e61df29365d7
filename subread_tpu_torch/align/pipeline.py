"""subread-align and subjunc in PyTorch, single-end and paired-end: port of
subread_tpu/align/pipeline.py.

The device steps (vote, scan-2 scoring, single-end and paired-end
selection, the saturation rescue tiers, and with junction detection the
junction split scans, the stored-candidate event seeds and the event-table
rescue step) run as torch ops on the Aligner's device, with the hit gather
in the CUDA kernel `ops.probe.probe_hits` on a card.  Each chunk is split
into `batch_reads` sub-batches; `submit_batch`/`submit_batch_pe` queue
every sub-batch's work and `collect_batch`/`collect_batch_pe` read the
results back.

align_file and align_file_pe share one chunk loop, `_align_chunks`, which
queues chunk N+1 before it reads chunk N back, runs the chunk's host step
(`_host_step_se`, `_host_step_pe`: indel-event placement, multi-indel
refinement, the long-indel rescue for -I > 16, the junction tables, the
event-table rescue, junction chaining, fusion breakpoints, then the
records) and keeps what chunks share in one `_ChunkTables` per call.  The
host side follows the JAX package's rules without importing it; its
outputs are held byte-equal to the JAX package's by the `*_matches_jax`
tests, over several chunks by tests/test_torch_chunks.py.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import dna, timing
from ..config import AlignConfig
from ..device import SENTINEL, resolve_device, u32, upload
from ..index.device import to_device
from ..index.genome import Genome
from ..io import sam as samio
from ..io.bam import cigar_ops
from ..io.fastq import FastqReader, ReadBatch
from ..ops.extend import oriented_read, place_single_indel, ref_clip_stats
from ..ops.junction import (
    big_margin_ambiguous, junction_rescue, junction_split_scan,
    pick_junction_pair, pick_stored_seed_junctions,
)
from ..ops.vote import (
    VoteParams, VoteResult, merge_vote_results, static_offsets, vote_batch,
)
# indelevent's functions are called through the module, so that a wrapper
# set on one of its attributes (the benchmark's spans, a test's spy) runs
from . import indelevent
from .fusion import accumulate_breakpoints, detect_fusion_pairs, write_breakpoints_vcf
from .longindel import assemble_insertion_piles, rescue_long_indels

# collect_batch hands the host the dict the JAX pipeline's collect_batch
# does.  There, a sub-batch's probe_kv rows travel compacted: the rows of
# reads flagged for host indel placement (indel != 0 or multi_indel), the
# rest SENTINEL, or the whole table when more than PKV_CAP rows are flagged.
PKV_CAP = 2048

_SEEDS = ("seed", "seed2", "seed3")      # the stored-candidate event seeds

_U32_KEYS = (                            # uint32 on the host
    "pos", "alt_pos", "probe_kv", "alt2_pos", "vk_pos",
    *(f"{p}_{e}" for p in _SEEDS for e in ("left", "right")),
)

# the narrowing the JAX pipeline applies to a result before the host reads
# it (its _PACK_CAST): _select_pe leaves these at the candidate tables'
# int32, and the host dict holds them as int16
_PACK_CAST = {"mism": np.int16, "clip_l": np.int16, "clip_r": np.int16}


def _host(key: str, t: torch.Tensor) -> np.ndarray:
    """A result tensor as the numpy array the JAX pipeline hands the host."""
    a = t.cpu().numpy()
    return a.astype(np.uint32) if key in _U32_KEYS else a


def _host_part(res: dict, keep_best_k: bool = False) -> dict[str, np.ndarray]:
    """One sub-batch's result on the host: every key (best_k only when
    `keep_best_k`: fusion detection reads it), narrowed by _PACK_CAST, and
    probe_kv only when some read is flagged for host indel placement
    (indel != 0 or multi_indel): the flagged rows with the rest SENTINEL,
    or the whole table past PKV_CAP flagged rows."""
    drop = ("probe_kv",) if keep_best_k else ("probe_kv", "best_k")
    d = {k: _host(k, v) for k, v in res.items() if k not in drop}
    for k, dt in _PACK_CAST.items():
        if k in d:
            d[k] = d[k].astype(dt, copy=False)
    if "probe_kv" in res:
        flag = d["indel"] != 0
        if "multi_indel" in d:
            flag = flag | d["multi_indel"]
        nf = int(flag.sum())
        if nf > 0:
            pkv = _host("probe_kv", res["probe_kv"])
            d["probe_kv"] = pkv if nf > PKV_CAP else np.where(
                flag[:, None], pkv, np.uint32(SENTINEL)
            )
    return d


def _merge_parts(parts: list[dict], R: int, pkv_fill: int) -> dict:
    """Concatenate the sub-batches' host dicts and cut to the R real reads;
    sub-batches without probe_kv rows get rows of `pkv_fill` (the JAX
    pipeline's single-end collect uses 0, its paired-end collect SENTINEL)."""
    out = {k: np.concatenate([p[k] for p in parts])[:R]
           for k in parts[0] if k != "probe_kv"}
    have = [p["probe_kv"] for p in parts if "probe_kv" in p]
    if have:
        P = have[0].shape[1]
        out["probe_kv"] = np.concatenate([
            p.get("probe_kv", np.full((len(p["pos"]), P), pkv_fill, np.uint32))
            for p in parts
        ])[:R]
    return out


@dataclass
class AlignSummary:
    total: int = 0
    mapped: int = 0
    unique: int = 0
    multi: int = 0
    unmapped: int = 0
    indels: int = 0

    def as_dict(self):
        return self.__dict__.copy()


def write_indel_vcf(path: str, genome: Genome, indels: dict) -> None:
    """Write {output}.indel.vcf (reference core-indel.c:2233-2254).
    indels: (contig_idx, pos0_anchor, indel_len) -> (support, inserted_seq)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write('##INFO=<ID=INDEL,Number=0,Type=Flag,Description="Indicates that the variant is an INDEL.">\n')
        f.write('##INFO=<ID=SR,Number=1,Type=Integer,Description="Number of supporting reads">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for (cidx, pos0, ilen), (sup, ins_seq) in sorted(indels.items()):
            lin = genome.chro_to_linear(cidx, pos0)
            if ilen > 0:  # deletion
                ref_s = dna.decode(genome.codes[lin : lin + ilen + 1])
                alt_s = ref_s[0]
            else:
                ref_s = dna.decode(genome.codes[lin : lin + 1])
                alt_s = ref_s + ins_seq
            f.write(
                f"{genome.names[cidx]}\t{pos0 + 1}\t.\t{ref_s}\t{alt_s}"
                f"\t.\t.\tINDEL;SR={sup}\n"
            )


# The junction-table helpers below, collect_junctions to
# write_junction_bed, follow the JAX package's host functions rule for rule.

def collect_junctions(res: dict, batch, genome, table: dict,
                      mask: np.ndarray | None = None) -> dict | None:
    """Accumulate junction events from a result batch into the shared
    event table; also returns {(left_lin, right_lin): donor_strand}.

    mask: only count these rows.  The reference's junction.bed holds
    exactly the junctions of its REPORTED records (its bed and SAM
    junction sets are identical on the subjunc PE test) — final-table
    calls pass the emit predicate so unreported (multi-mapping /
    out-of-range) reads and unconfirmed seeds never add support."""
    if "junc" not in res:
        return None
    donor_of = {}
    junc = np.asarray(res["junc"], bool)
    if mask is not None:
        junc = junc & np.asarray(mask, bool)
        # chained (cigar_override) rows: res["pos"] was moved to the chain
        # start while split/junc_gap kept their pre-chain values, so a key
        # built here would mix frames and mint a phantom junction.  Their
        # junctions (head/tail events + the primary, all in consistent
        # frames) are counted by chain_clipped_junctions itself.
        for i in (res.get("cigar_override") or {}):
            if i < len(junc):
                junc[i] = False
    sel = np.flatnonzero(junc)
    if len(sel) == 0:
        return donor_of
    lin = res["pos"].astype(np.int64)
    cidx, coff = genome.linear_to_chro(lin)
    for i in sel:
        split = int(res["split"][i])
        gap = int(res["junc_gap"][i])
        L = int(batch.lengths[i])
        p0 = int(coff[i])
        left_edge = p0 + split - 1
        right_edge = p0 + split + gap
        key = (
            genome.names[int(cidx[i])], left_edge, right_edge,
            int(res["junc_donor_strand"][i]),
        )
        jcl = int(res["clip_l"][i]) if "clip_l" in res else 0
        jcr = int(res["clip_r"][i]) if "clip_r" in res else 0
        sup, ml, mr = table.get(key, (0, 0, 0))
        table[key] = (sup + 1, max(ml, split), max(mr, L - jcl - split - jcr))
        donor_of[(int(lin[i]) + split - 1, int(lin[i]) + split + gap)] = int(
            res["junc_donor_strand"][i]
        )
    return donor_of


def collect_seed_junctions(res: dict, genome, table: dict,
                           pending: dict | None = None,
                           min_proposers: int = 1) -> None:
    """Seed-only junction events (find_new_junctions seeding once per
    stored candidate result, core.c:3249-3278 + core-junction.c:3836,
    gated by the 3-slot big-margin record :789): entered with support 0
    so they drive scan-2 rescue but only reach .junction.bed once a
    supporter is counted — exactly the reference's event lifecycle
    (events exist from scan 1; write_junction_final_results only emits
    final_counted_reads >= 1)."""
    if pending is None:
        pending = {}
    for pfx in ("seed", "seed2", "seed3"):
        if f"{pfx}_ok" not in res:
            continue
        sel = np.flatnonzero(np.asarray(res[f"{pfx}_ok"], bool))
        if len(sel) == 0:
            continue
        lin_l = np.asarray(res[f"{pfx}_left"], np.int64)
        lin_r = np.asarray(res[f"{pfx}_right"], np.int64)
        donor = np.asarray(res[f"{pfx}_donor"], np.int64)
        cidx, coff_l = genome.linear_to_chro(lin_l)
        cidx_r, coff_r = genome.linear_to_chro(lin_r)
        for i in sel:
            # events are bounded within one chromosome (the reference
            # keys them by a single chro); a pair straddling a contig
            # boundary would seed a bogus cross-contig event
            if int(cidx[i]) != int(cidx_r[i]):
                continue
            key = (
                genome.names[int(cidx[i])], int(coff_l[i]), int(coff_r[i]),
                int(donor[i]),
            )
            n = pending.get(key, 0) + 1
            pending[key] = n
            if n >= min_proposers:
                table.setdefault(key, (0, 0, 0))


def known_junctions_from_annotation(ann) -> dict:
    """-a exon annotation -> preloaded junction events
    (load_known_junctions, core-indel.c:1313 + add_annotation_to_junctions
    :1163): per (gene, chromosome), exons sorted by start; a junction spans
    from the running max exon end to the next exon's start.  Keys use the
    pipeline's (chro, left_edge0, right_edge0, donor_strand) format with
    support 0 — they seed the scan-2 rescue event table but only appear in
    .junction.bed once reads actually support them."""
    out: dict = {}
    by_gene: dict[tuple[int, str], list[tuple[int, int, int]]] = {}
    for i in range(ann.n_features):
        key = (int(ann.feat_gene[i]), ann.feat_chro[i])
        by_gene.setdefault(key, []).append(
            (int(ann.feat_start[i]), int(ann.feat_end[i]),
             int(ann.feat_strand[i]))
        )
    for (_g, chro), exons in by_gene.items():
        exons.sort()
        large_end = -1
        for start, end, strand in exons:
            if 0 < large_end < start:
                # left edge = last exon base, right = first next-exon base
                out[(chro, large_end - 1, start - 1, 1 if strand == 1 else 0)] \
                    = (0, 0, 0)
            large_end = max(large_end, end)
    return out


def junction_event_arrays(
    genome, table: dict
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Sorted (left, right) linear-coordinate arrays for the device
    rescue kernel, plus (left,right)->donor map."""
    lefts, rights, donor = [], [], {}
    name_to_idx = {n: i for i, n in enumerate(genome.names)}
    for (chro, le, re_, ds) in table:
        c = name_to_idx.get(chro)
        if c is None:
            continue
        ll = int(genome.chro_to_linear(c, le))
        rl = int(genome.chro_to_linear(c, re_))
        lefts.append(ll)
        rights.append(rl)
        donor[(ll, rl)] = ds
    if not lefts:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), donor
    order = np.argsort(lefts)
    return (
        np.asarray(lefts, np.uint32)[order],
        np.asarray(rights, np.uint32)[order],
        donor,
    )


def write_junction_bed(path: str, junctions: dict) -> None:
    """Write the .junction.bed table (write_junction_final_results,
    core-junction.c:4286): BED12-ish rows with flanking block sizes;
    key = (chro, left_edge0, right_edge0, donor_strand), value =
    (n_support, max_left_flank, max_right_flank)."""
    rows = sorted(junctions.items())
    with open(path, "w") as f:
        f.write(
            "#Chr, StartLeftBlock, EndRightBlock, Junction_Name, nSupport, "
            "Strand, StartLeftBlock, EndRightBlock, Color, nBlocks, "
            "BlockSizes, BlockStarts\n"
        )
        for n, ((chro, le, re, dstrand), (sup, ml, mr)) in enumerate(rows, 1):
            start = le - ml + 1
            end = re + mr
            strand = "-" if dstrand else "+"
            color = "0,255,255" if dstrand else "255,0,0"
            f.write(
                f"{chro}\t{start}\t{end}\tJUNC{n:08d}\t{sup}\t{strand}"
                f"\t{start}\t{end}\t{color}\t2\t{ml},{mr}\t0,{re - start}\n"
            )


def applied_mismatch_limit(max_mismatches: int, lens: torch.Tensor) -> torch.Tensor:
    """The reference's length-scaled mismatch cap: -M applies per 100bp
    for reads beyond EXON_LONG_READ_LENGTH=160
    (core-junction.c:3359-3362: ((L+1)<<16)/100 * M >> 16)."""
    L = lens.to(torch.int32)
    scaled = ((((L + 1) << 16) // 100) * max_mismatches) >> 16
    return torch.where(L > 160, scaled, max_mismatches).to(torch.int32)


def _emit_span(emit):
    """An emit method (self, writer, ...) in the emit span of one chunk's
    records.  While the profiler records, a BAM writer's packing time
    summed over the records is counted as bam.pack_ns, and the records
    packed by the native encoder and by BamWriter.add_sam_fields as
    bam.records_native and bam.records_python."""

    @functools.wraps(emit)
    def spanned(self, writer, *args, **kw):
        bam = getattr(writer, "bam", None)
        with timing.span("emit"):
            if bam is None or not timing.recording():
                return emit(self, writer, *args, **kw)
            bam.pack_ns = bam.records_native = bam.records_python = 0
            try:
                return emit(self, writer, *args, **kw)
            finally:
                timing.count("bam.pack_ns", bam.pack_ns)
                timing.count("bam.records_native", bam.records_native)
                timing.count("bam.records_python", bam.records_python)
                bam.pack_ns = None

    return spanned


def _add_indel_event(indel_events: dict | None, batch, res: dict, i: int,
                     iv: int, ci, co) -> None:
    """Count row i's indel of iv bases (insertion < 0) at contig ci, 0-based
    offset co, in indel_events: (contig, last base before the indel, iv) ->
    (reads, inserted bases of the first).  Rows whose events the
    event-placement pass recorded are left out."""
    if indel_events is None or i in (res.get("_events_done") or ()):
        return
    sp = int(res["split"][i])
    seq, _ = _seq_qual(batch, i, int(res["strand"][i]) == 1)
    ins_seq = seq[sp : sp - iv] if iv < 0 else ""
    _count_events(indel_events, [((int(ci), int(co) + sp - 1, iv), (1, ins_seq))])


def _count_events(indel_events: dict, events) -> None:
    """Add events, (key, (reads, inserted bases)) pairs keyed (contig, last
    base before the indel, length), to indel_events; a key keeps the
    inserted bases it was first counted with."""
    for k, (sup, ins) in events:
        s0, p0 = indel_events.get(k, (0, ins))
        indel_events[k] = (s0 + sup, p0)


def _seq_qual(batch, i: int, reverse: bool) -> tuple[str, str]:
    """Read i's SEQ and QUAL text as its record gives them: the read's own,
    or reverse-complemented and reversed for a reverse-strand record."""
    L = int(batch.lengths[i])
    codes = batch.codes[i, :L]
    qual = batch.quals[i, :L].tobytes().decode()
    if reverse:
        return dna.decode(dna.revcomp(codes)), qual[::-1]
    return dna.decode(codes), qual


def _cigar_text(L: int, clip_l: int, clip_r: int, split: int, indel: int,
                gap: int | None) -> str:
    """A record's CIGAR from its row: soft clips around a junction (gap not
    None: split bases, then the gap, counted from the clipped head), a
    deletion (indel > 0) or an insertion (indel < 0) after the split-th base
    of the read, or one match run."""
    if gap is not None:
        mid = f"{split}M{gap}N{L - clip_l - split - clip_r}M"
    elif indel > 0:
        mid = f"{split - clip_l}M{indel}D{L - split - clip_r}M"
    elif indel < 0:
        mid = f"{split - clip_l}M{-indel}I{L - split + indel - clip_r}M"
    else:
        mid = f"{L - clip_l - clip_r}M"
    return (f"{clip_l}S" if clip_l else "") + mid + (f"{clip_r}S" if clip_r else "")


def _merge_overrides(res: dict, ov: dict, keep_earlier: bool) -> None:
    """Merge a host rescue's records, {row: (cigar, mismatches, nm)}, into
    res["cigar_override"] (over earlier ones, or under them with
    keep_earlier) and take their mismatches into res["mism"]."""
    cur = res.get("cigar_override") or {}
    for i, v in ov.items():
        if keep_earlier:
            cur.setdefault(i, v)
        else:
            cur[i] = v
    res["cigar_override"] = cur
    res["mism"] = np.asarray(res["mism"], np.int32).copy()
    for i, (_c, mm, _nm) in ov.items():
        res["mism"][i] = mm


@dataclass
class _ChunkTables:
    """What the chunks of one align_file or align_file_pe call share, made
    afresh for each call: the junction table (subjunc, --sv; else None)
    with the seed junctions pending support, the fusion breakpoints
    (--allJunctions; else None), the indel events and the long-insertion
    piles (-I > 16)."""
    junctions: dict | None
    breakpoints: dict | None
    seed_pending: dict = field(default_factory=dict)
    indel_events: dict = field(default_factory=dict)
    ins_piles: dict = field(default_factory=dict)


def uniform_length(lens: np.ndarray) -> int | None:
    """The common read length when every (real) read shares it, else None
    — a static hint that turns reverse-complementing into a static flip."""
    nz = lens[lens > 0]
    if len(nz) and (nz == nz[0]).all():
        return int(nz[0])
    return None


class Aligner:
    """Single-end and paired-end aligner (subread-align, subjunc) on one
    device."""

    def __init__(self, genome: Genome, index, cfg: AlignConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        # index: a HashIndex or a list of position-range blocks (-M)
        self.blocks = list(index) if isinstance(index, (list, tuple)) else [index]
        self.genome = genome
        self.index = self.blocks[0]
        self.cfg = cfg
        # -a's known junctions (the CLI sets them): with the junctions found
        # so far, the event table of subjunc's rescue
        self.annot_junctions: dict | None = None
        # vote, rescue-width and rescue-tier parameters exactly as the JAX
        # Aligner (subread_tpu/align/pipeline.py:350-439), whose comments
        # give the measurements behind each value
        self.vote_params = VoteParams(
            total_subreads=cfg.total_subreads,
            max_hits=cfg.max_hits_per_probe,
            indel_tolerance=max(min(cfg.max_indel, 16), 1),
            top_k=cfg.top_k,
            index_gap=self.index.index_gap,
            compact=160,
            window=16,
        )
        max_run = max(getattr(b, "max_run", 0) for b in self.blocks)
        # strictly wider than the longest run, so a full-width run cannot
        # re-trip the truncation flag inside the rescue pass itself
        self.rescue_hits = max(64, -(-(max_run + 1) // 16) * 16)
        self.rescue_vote_params = self.vote_params._replace(
            max_hits=self.rescue_hits,
            window=max(self.vote_params.window, 40),
            compact=0,
        )
        # device-side rescue fold: saturated reads are compacted and
        # re-aligned through wider passes in the same submit chain; zero
        # tiers when the narrow window covers every run
        self.rescue_fold_cap = (
            0 if max_run < cfg.max_hits_per_probe
            else min(4096, cfg.batch_reads)
        )
        self.rescue_tiers = []
        if self.rescue_fold_cap:
            # mixed-width tier: the narrow window on every probe plus up to
            # 8 wide windows on the saturated probes
            self.rescue_tiers.append((
                self.vote_params._replace(
                    wide_slots=8, wide_hits=self.rescue_hits, window=32,
                    compact=512,
                ),
                self.rescue_fold_cap,
            ))
            # full-wide tier for reads the mixed tier leaves saturated
            self.rescue_tiers.append((
                self.rescue_vote_params._replace(compact=1024),
                max(self.rescue_fold_cap // 8, 256),
            ))
        with timing.span("index.upload"):
            self.dev_index = to_device(self.blocks, genome, self.device)

    # --- device step -------------------------------------------------------

    def _device_align(self, codes, ambig, lens, uniform_len=None,
                      rescue=False, vp=None):
        """Votes + scan-2 selection for one sub-batch; rescue=True re-votes
        with the wide gather (rescue_vote_params, or an explicit vp)."""
        if vp is None:
            vp = self.rescue_vote_params if rescue else self.vote_params
        v = None
        for blk in self.dev_index.blocks:
            vb = vote_batch(
                codes, ambig, lens, blk.bucket_start, blk.comb,
                blk.bucket_bits, vp, static_len=uniform_len,
                sub_base=blk.sub_base, sub_lo=blk.sub_lo,
                sub_bits=blk.sub_bits, search_steps=blk.search_steps,
            )
            v = vb if v is None else merge_vote_results(v, vb, self.vote_params)
        res = self._scan2(codes, ambig, lens, v, uniform_len)
        res["saturated"] = v.saturated
        if not rescue and self.rescue_fold_cap:
            res = self._rescue_fold(codes, ambig, lens, res, uniform_len)
        return res

    def _rescue_fold(self, codes, ambig, lens, res, uniform_len,
                     align_rows=None):
        """Compact the saturated reads (up to each tier's capacity),
        re-align them through the tier's wider pass and scatter the results
        back; rows past a capacity keep their flag for the host pass.
        `align_rows` runs one tier's pass (default `_device_align`; the
        mesh step passes one that splits the rows over its devices)."""
        align_rows = align_rows or self._device_align
        for vp, cap in self.rescue_tiers:
            rb = min(cap, codes.shape[0])
            idx_r, valid_r, codes_r, ambig_r, lens_r = self._sat_compact(
                res["saturated"], codes, ambig, lens, rb
            )
            res_r = align_rows(
                codes_r, ambig_r, lens_r, uniform_len=uniform_len,
                rescue=True, vp=vp,
            )
            res = self._sat_scatter(res, res_r, idx_r, valid_r)
        return res

    @staticmethod
    def _sat_compact(sat, codes, ambig, lens, rb):
        order = torch.argsort(
            (~sat).to(torch.uint8), stable=True
        )[:rb]
        return order, sat[order], codes[order], ambig[order], lens[order]

    @staticmethod
    def _sat_scatter(res, res_r, idx_r, valid_r):
        out = {}
        for k, a in res.items():
            r = res_r.get(k)
            if r is None:
                out[k] = a
                continue
            vr = valid_r.reshape(-1, *([1] * (r.dim() - 1)))
            a = a.clone()
            a[idx_r] = torch.where(vr, r.to(a.dtype), a[idx_r])
            out[k] = a
        return out

    def _score_candidates(self, codes, ambig, lens, v: VoteResult,
                          min_votes: int | None = None,
                          uniform_len: int | None = None):
        """Realignment scoring of every top-K candidate: mismatches via the
        single-indel split scan, plus the reference's integer score
        (core.c:2731-2739).  Returns per-candidate [R, K] tensors."""
        cfg = self.cfg
        R, L = codes.shape
        K = v.pos.shape[1]
        fwd = codes
        rev = oriented_read(
            codes, lens, torch.ones(R, dtype=torch.int32, device=codes.device),
            uniform_len,
        )
        si = min(cfg.max_indel, 16)
        pos_k, strand_k = v.pos, v.strand
        d = u32(v.tail - v.pos)                 # uint32 -> int32 wrap
        indel_k = torch.clamp(
            torch.where(d >= 1 << 31, d - (1 << 32), d), -si, si
        ).to(torch.int32)
        if uniform_len is not None and uniform_len < L:
            fwd, rev = fwd[:, :uniform_len], rev[:, :uniform_len]
        oriented_k = torch.where(
            strand_k[:, :, None] == 1, rev[:, None, :], fwd[:, None, :]
        )
        flat = lambda a: a.reshape(R * K, *a.shape[2:])
        lens_f = lens[:, None].expand(R, K).reshape(-1)
        indel_f = flat(indel_k)
        split_f, _, mm_head_f, mm_tail_f = place_single_indel(
            self.dev_index.genome_words, flat(oriented_k), lens_f, flat(pos_k),
            indel_f, max_indel_static=si,
        )
        head_f, tail_f, mism_f, match_f = ref_clip_stats(
            mm_head_f, mm_tail_f, lens_f, split_f, indel_f,
            flat(v.cov_start), flat(v.cov_end),
            show_clip=cfg.show_soft_clipping,
        )
        mism_k = mism_f.reshape(R, K)
        match_k = match_f.reshape(R, K)
        votes_k = v.votes
        mv = cfg.min_votes if min_votes is None else min_votes
        valid_k = (votes_k >= mv) & (pos_k != SENTINEL)
        # DNA score = match*100000 + (10000 - mismatch) (core.c:2731-2739)
        score_k = torch.where(valid_k, match_k * 100000 + (10000 - mism_k), -1)
        return dict(
            pos_k=pos_k, strand_k=strand_k, indel_k=indel_k,
            split_k=split_f.reshape(R, K), mism_k=mism_k, match_k=match_k,
            votes_k=votes_k, valid_k=valid_k, score_k=score_k,
            probe_kv_k=v.probe_kv, anchor_k=v.anchor,
            clip_l_k=head_f.reshape(R, K), clip_r_k=tail_f.reshape(R, K),
            cov_s_k=v.cov_start, cov_e_k=v.cov_end,
        )

    @staticmethod
    def _anchor_set(sc, min_first: int, max_simples: int = 3,
                    multi_best: int = 3):
        """The reference's scan-2 anchor set from the vote table
        (process_voting_junction_PE_topK, core-junction.c:2199; see the
        JAX method).  Returns (anchor bool [R, K], n_anchors int [R])."""
        votes_k, pos_k = sc["votes_k"], sc["pos_k"]
        apos_k = sc.get("anchor_k", pos_k)
        has = (votes_k >= 1) & (pos_k != SENTINEL)
        vmax = votes_k[:, :1]
        newval = torch.cat(
            [torch.zeros_like(votes_k[:, :1]),
             (votes_k[:, 1:] != votes_k[:, :-1]).to(votes_k.dtype)], dim=1,
        )
        tier = torch.cumsum(newval, 1)
        allowed = has & (tier <= 2) & (votes_k >= vmax - 2)
        slot = torch.cumsum(allowed.to(torch.int32), 1)
        anchor = allowed & (slot <= max_simples) & (votes_k >= min_first)
        K = votes_k.shape[1]
        eqpos = apos_k[:, :, None] == apos_k[:, None, :]
        ar = torch.arange(K, device=votes_k.device)
        earlier = ar[None, :, None] > ar[None, None, :]
        dup = (eqpos & earlier & anchor[:, None, :]).any(2) & anchor
        anchor = anchor & ~dup
        rank = torch.cumsum(anchor.to(torch.int32), 1)
        anchor = anchor & (rank <= multi_best)
        return anchor, anchor.to(torch.int32).sum(1)

    def _select_se(self, lens, sc):
        """Single-end best-candidate selection + MAPQ (see the JAX method).
        Output dtypes are the ones the JAX pipeline hands the host."""
        cfg = self.cfg
        score_k = sc["score_k"]
        anchor_k, n_anchors = self._anchor_set(sc, cfg.min_votes)
        mlim = applied_mismatch_limit(cfg.max_mismatches, lens)[:, None]
        cand_ok = anchor_k & (sc["mism_k"] <= mlim) & (sc["match_k"] >= 1)
        score_m = torch.where(cand_ok, score_k, -1)
        best = torch.argmax(score_m, dim=1)       # first maximum, as JAX
        take = lambda a: torch.gather(a, 1, best[:, None])[:, 0]
        b_pos, b_strand = take(sc["pos_k"]), take(sc["strand_k"])
        b_indel, b_split = take(sc["indel_k"]), take(sc["split_k"])
        b_mism, b_votes = take(sc["mism_k"]), take(sc["votes_k"])
        b_score, b_valid = take(score_m), take(cand_ok)
        pkv_k = sc["probe_kv_k"]
        b_pkv2 = torch.gather(
            pkv_k, 1, best[:, None, None].expand(-1, 1, pkv_k.shape[2])
        )[:, 0]
        # the member table covers both strand scans' probes; host event
        # placement wants the winner's own scan
        P0 = b_pkv2.shape[1] // 2
        b_pkv = torch.where(b_strand[:, None] == 1, b_pkv2[:, P0:], b_pkv2[:, :P0])

        mapped = b_valid
        # break-even: a distinct (pos, cigar) alignment ties the best score
        cl_k, cr_k = sc["clip_l_k"], sc["clip_r_k"]
        b_cl, b_cr = take(cl_k), take(cr_k)
        same_aln = (
            (sc["pos_k"] == b_pos[:, None])
            & (sc["strand_k"] == b_strand[:, None])
            & (sc["indel_k"] == b_indel[:, None])
            & (sc["split_k"] == b_split[:, None])
            & (cl_k == b_cl[:, None])
            & (cr_k == b_cr[:, None])
        )
        n_best = 1 + ((score_m == b_score[:, None]) & cand_ok & ~same_aln).sum(1)
        breakeven = mapped & (n_best > 1)
        mapq = torch.where(
            breakeven, 0,
            cfg.mapq_unique // torch.clamp(n_anchors + b_mism, min=1),
        )
        if not cfg.report_multi_mapping and cfg.multi_best <= 1:
            mapped = mapped & ~breakeven
        b_pos0 = b_pos
        cl_w = torch.where(mapped, b_cl, 0)
        cr_w = torch.where(mapped, b_cr, 0)
        b_pos = torch.where(mapped, u32(b_pos + cl_w), b_pos)
        n_best = torch.where(breakeven, n_best, 1)
        i8, i16 = torch.int8, torch.int16
        out = dict(
            clip_l=cl_w.to(i16), clip_r=cr_w.to(i16),
            pos=b_pos, strand=b_strand.to(i8),
            indel=b_indel.to(i8), split=b_split.to(i16),
            mism=torch.clamp(b_mism, max=999).to(i16),
            votes=b_votes.to(i8), mapped=mapped, multi=n_best > 1,
            mapq=mapq.to(i8),
            n_anchors=n_anchors.to(i8), best_k=best.to(i8),
            cov_start=take(sc["cov_s_k"]).to(i16),
            cov_end=take(sc["cov_e_k"]).to(i16),
        )
        # multi-indel flag: >= 3 distinct probe deltas in the winner
        anchored = (b_pos0 != SENTINEL) & (b_votes >= cfg.min_votes)
        validp = (b_pkv != SENTINEL) & anchored[:, None]
        delta = torch.where(validp, u32(b_pkv - b_pos0[:, None]), SENTINEL)
        ds = torch.sort(delta, dim=1).values
        nvalid = validp.sum(1)
        j = torch.arange(1, b_pkv.shape[1], device=lens.device)[None, :]
        trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
        n_distinct = (nvalid > 0).to(torch.int64) + trans.sum(1)
        out["multi_indel"] = (n_distinct >= 3) & anchored
        out["probe_kv"] = b_pkv
        if cfg.multi_best > 1:
            # -B N: the equal-best candidate set for secondary records
            N = min(cfg.multi_best, score_k.shape[1])
            eq = (score_m == b_score[:, None]) & cand_ok
            ordk = torch.argsort(-score_m, dim=1, stable=True)[:, :N]
            takek = lambda a: torch.gather(a, 1, ordk)
            out["alt_pos"] = takek(sc["pos_k"])
            out["alt_strand"] = takek(sc["strand_k"]).to(i8)
            out["alt_mism"] = torch.clamp(takek(sc["mism_k"]), max=255).to(torch.uint8)
            out["alt_indel"] = takek(sc["indel_k"]).to(i8)
            out["alt_split"] = takek(sc["split_k"]).to(i16)
            out["alt_eq"] = takek(eq)
            out["alt_votes"] = takek(sc["votes_k"]).to(i8)
            out["alt_clip"] = torch.clamp(takek(cl_k) + takek(cr_k), max=255).to(torch.uint8)
        return out

    def _scan2(self, codes, ambig, lens, v: VoteResult, uniform_len=None):
        sc = self._score_candidates(codes, ambig, lens, v, uniform_len=uniform_len)
        if self.cfg.detect_junctions:
            return self._select_se_junc(codes, lens, v, sc, uniform_len)
        return self._select_se(lens, sc)

    def _select_se_junc(self, codes, lens, v: VoteResult, sc, uniform_len=None):
        """Single-end selection plus junction discovery (subjunc, --sv):
        a junction (head cluster, tail cluster, donor-motif split) replaces
        the plain alignment when it explains the read at a lower cost in
        matched-bases space and the best candidate is not vote-ambiguous
        (the 3-slot big-margin record); then the stored-candidate event
        seeds, the alternate anchor and, with --allJunctions, the vote
        clusters (see the JAX method)."""
        cfg = self.cfg
        base = self._select_se(lens, sc)
        pair = pick_junction_pair(v, sc, cfg.max_indel, read_len=lens)
        jr = self._split_scan(codes, lens, base["strand"], pair, uniform_len)
        plain_cost = (base["clip_l"].to(torch.int32) + base["clip_r"]
                      + base["mism"].to(torch.int32))
        junc_cost = jr["mism"] + jr["clip_l"] + jr["clip_r"]
        amb_k = big_margin_ambiguous(v, lens, cfg.min_votes_second)
        best_k_j = torch.argmax(sc["score_k"], dim=1)
        not_ambiguous = ~torch.gather(amb_k, 1, best_k_j[:, None])[:, 0]
        use = pair["valid"] & jr["ok"] & (junc_cost < plain_cost) & (
            jr["mism"] <= cfg.max_mismatches
        ) & not_ambiguous
        out = self._junction_fold(base, pair, jr, use)
        self._junction_exports(codes, lens, v, sc, base, out, uniform_len,
                               cfg.min_votes, 3)
        return out

    def _pe_junction_update(self, codes, lens, v: VoteResult, sc, res,
                            uniform_len=None):
        """Per-mate junction detection on the paired path: the
        pair-selected candidate anchors the head/tail search, otherwise as
        _select_se_junc (see the JAX method)."""
        cfg = self.cfg
        pair = pick_junction_pair(v, sc, cfg.max_indel, best=res["best_k"],
                                  read_len=lens)
        jr = self._split_scan(codes, lens, res["strand"], pair, uniform_len)
        plain_cost = torch.where(res["indel"] == 0,
                                 res["clip_l"] + res["clip_r"] + res["mism"],
                                 res["mism"])
        junc_cost = jr["mism"] + jr["clip_l"] + jr["clip_r"]
        use = pair["valid"] & jr["ok"] & (junc_cost < plain_cost) & (
            jr["mism"] <= cfg.max_mismatches
        ) & ~pair["ambiguous"]
        out = self._junction_fold(res, pair, jr, use)
        # the paired simple list is uncapped at this K (max_vote_simples=64)
        self._junction_exports(codes, lens, v, sc, res, out, uniform_len,
                               cfg.min_votes_second, 64)
        return out

    def _split_scan(self, codes, lens, strand, pair, uniform_len):
        """junction_split_scan of the read oriented by `strand` across a
        (head, tail) pair of pick_junction_pair or one stored-seed slot."""
        oriented = oriented_read(codes, lens, strand, uniform_len)
        return junction_split_scan(
            self.dev_index.genome_words, oriented, lens, pair["head_pos"],
            pair["gap"], pair["valid"], pair["guess_lo"], pair["guess_hi"],
        )

    @staticmethod
    def _junction_fold(res, pair, jr, use):
        """res with the junction explanation where `use`: pos at the first
        aligned base (head_pos + clip), split relative to the clipped
        region, so the CIGAR is clS splitM gapN (L-cl-split-cr)M crS."""
        out = dict(res)
        out["pos"] = torch.where(use, u32(pair["head_pos"] + jr["clip_l"]),
                                 res["pos"])
        out["mism"] = torch.where(use, jr["mism"], res["mism"])
        out["mapped"] = res["mapped"] | use
        out["indel"] = torch.where(use, 0, res["indel"])
        out["split"] = torch.where(use, jr["split"] - jr["clip_l"], res["split"])
        out["junc"] = use
        out["junc_gap"] = torch.where(use, pair["gap"], 0)
        out["junc_donor_strand"] = jr["donor_strand"]
        out["clip_l"] = torch.where(use, jr["clip_l"], res["clip_l"])
        out["clip_r"] = torch.where(use, jr["clip_r"], res["clip_r"])
        return out

    def _junction_exports(self, codes, lens, v, sc, res, out, uniform_len,
                          min_votes: int, max_simples: int) -> None:
        """Into `out`: the event seed of each stored candidate (seed*_ok,
        _left, _right, _donor), the alternate anchor for the event-table
        rescue (the best same-strand candidate at another position:
        alt2_pos, alt2_ok) and, with --allJunctions, the vote clusters for
        host fusion detection (vk_*).  `res` is the selection before the
        junction fold."""
        cfg = self.cfg
        seed = pick_stored_seed_junctions(
            v, sc, cfg.max_indel, lens, sc["valid_k"], min_votes=min_votes,
            min_votes_second=cfg.min_votes_second, max_simples=max_simples,
        )
        for s, pfx in enumerate(_SEEDS):
            slot = {k: seed[k][:, s] for k in
                    ("head_pos", "gap", "valid", "guess_lo", "guess_hi")}
            jr_s = self._split_scan(codes, lens, seed["strand"][:, s], slot,
                                    uniform_len)
            s_left = u32(slot["head_pos"] + jr_s["split"] - 1)
            out[f"{pfx}_ok"] = slot["valid"] & jr_s["ok"] & (
                jr_s["mism"] <= cfg.max_mismatches
            )
            out[f"{pfx}_left"] = s_left
            out[f"{pfx}_right"] = u32(s_left + slot["gap"] + 1)
            out[f"{pfx}_donor"] = jr_s["donor_strand"].to(torch.int8)
        mlim = applied_mismatch_limit(cfg.max_mismatches, lens)
        pos_k, strand_k = sc["pos_k"], sc["strand_k"]
        K = pos_k.shape[1]
        not_best = (torch.arange(K, device=lens.device)[None, :]
                    != res["best_k"].to(torch.int64)[:, None])
        alt_valid = (
            sc["valid_k"] & not_best & (pos_k != res["pos"][:, None])
            & (strand_k == res["strand"][:, None])
            & (sc["mism_k"] <= mlim[:, None])
        )
        alt_score = torch.where(alt_valid, sc["score_k"], -1)
        k2 = torch.argmax(alt_score, dim=1)[:, None]
        out["alt2_pos"] = torch.gather(pos_k, 1, k2)[:, 0]
        out["alt2_ok"] = torch.gather(alt_score, 1, k2)[:, 0] >= 0
        if cfg.all_junctions:
            out["vk_pos"] = v.pos
            out["vk_strand"] = v.strand
            out["vk_votes"] = v.votes
            out["vk_cov_s"] = v.cov_start
            out["vk_cov_e"] = v.cov_end

    def _select_pe(self, lens1, lens2, sc1, sc2, expected_tlen: int):
        """Paired-end selection (see the JAX method for the reference's
        semantics): scan-1 combos of the two ends' candidates weighted by
        fragment distance, their top 3 as the anchor sets, scan-2 pair
        scoring over the anchor pairs with the storage-order tie rule, the
        break-even test, and single-end fallbacks when an end has no
        successful realignment.  Returns one dict per mate, in the JAX
        method's dtypes (mapq int32, n_anchors int8, cov_* int16, the
        other fields the candidate tables' own), best_k included."""
        cfg = self.cfg
        R, K = sc1["votes_k"].shape
        dev = lens1.device
        v1, v2 = sc1["votes_k"], sc2["votes_k"]
        p1, p2 = sc1["pos_k"], sc2["pos_k"]
        ar = torch.arange(K, device=dev)

        def tier_filter(v, p):
            # the simple-list vote-tier gate: top 3 distinct vote values,
            # within 2 of the end's max, votes >= min_second
            has = (v >= cfg.min_votes_second) & (p != SENTINEL)
            newval = torch.cat(
                [torch.zeros_like(v[:, :1]), (v[:, 1:] != v[:, :-1]).to(v.dtype)],
                dim=1,
            )
            tier = torch.cumsum(newval, 1)
            return has & (tier <= 2) & (v >= v[:, :1] - 2)

        val1, val2 = tier_filter(v1, p1), tier_filter(v2, p2)
        starts = self.dev_index.contig_starts
        cid1 = torch.searchsorted(starts, p1.contiguous(), right=True)
        cid2 = torch.searchsorted(starts, p2.contiguous(), right=True)

        P1, P2 = p1[:, :, None], p2[:, None, :]                 # int64
        V1 = v1[:, :, None].to(torch.int32)
        V2 = v2[:, None, :].to(torch.int32)
        L1 = lens1[:, None, None].to(torch.int64)
        L2 = lens2[:, None, None].to(torch.int64)
        same = cid1[:, :, None] == cid2[:, None, :]
        bothv = val1[:, :, None] & val2[:, None, :]

        # scan-1 combos: every candidate pair weighted (V1+V2)*w
        tl_vote = (P1 - P2).abs() + torch.where(P1 > P2, L1, L2)
        pe_vote = same & (tl_vote >= cfg.min_fragment) & (
            tl_vote <= cfg.max_fragment
        )
        eligible = bothv & (torch.maximum(V1, V2) >= cfg.min_votes) & (
            pe_vote | (torch.minimum(V1, V2) >= cfg.min_votes)
        )
        w_vote = torch.where(pe_vote, 1300, torch.where(same, 1000, 800))
        adjusted = torch.where(eligible, (V1 + V2) * w_vote, -1)
        # top 3 combos by (weight, earlier k1-major entry): valid keys are
        # unique, every invalid key is -1, and top_ok gates every use of an
        # index, so the order topk gives tied -1 keys never matters
        KK = K * K
        flat_adj = adjusted.reshape(R, KK)
        fidx = torch.arange(KK, device=dev)[None, :]
        key = torch.where(flat_adj >= 0, flat_adj * KK + (KK - 1 - fidx), -1)
        top_key, top_i = torch.topk(key, 3, dim=1)
        top_ok = top_key >= 0
        tk1, tk2 = top_i // K, top_i % K
        any_combo = top_ok.any(1)

        # per-end anchor sets: the top combos' candidates, else the
        # single-end anchor rule
        def combo_anchor(tk):
            onehot = (ar[None, None, :] == tk[:, :, None]) & top_ok[:, :, None]
            return onehot.any(1)

        a1_se, _ = self._anchor_set(sc1, cfg.min_votes)
        a2_se, _ = self._anchor_set(sc2, cfg.min_votes)
        anchor1 = torch.where(any_combo[:, None], combo_anchor(tk1), a1_se)
        anchor2 = torch.where(any_combo[:, None], combo_anchor(tk2), a2_se)

        # MAPQ divisor: distinct anchor positions (at most 3), 0 when the
        # end's best anchor has fewer than min_votes
        earlier = ar[None, :, None] > ar[None, None, :]

        def distinct_pos_count(anchor, pos):
            eq = pos[:, :, None] == pos[:, None, :]
            dup = (eq & earlier & anchor[:, None, :]).any(2) & anchor
            return (anchor & ~dup).to(torch.int32).sum(1)

        def n_anchors(anchor, pos, v):
            n = torch.clamp(distinct_pos_count(anchor, pos), max=3)
            vmax = torch.where(anchor, v, 0).amax(1)
            return torch.where(vmax >= cfg.min_votes, n, 0)

        n_anch1 = n_anchors(anchor1, p1, v1)
        n_anch2 = n_anchors(anchor2, p2, v2)

        # realignment success per candidate
        def realigned(sc, anchor, lens):
            mlim = applied_mismatch_limit(cfg.max_mismatches, lens)[:, None]
            return anchor & (sc["mism_k"] <= mlim) & (sc["match_k"] >= 1)

        ok1 = realigned(sc1, anchor1, lens1)
        ok2 = realigned(sc2, anchor2, lens2)
        has1, has2 = ok1.any(1), ok2.any(1)

        # ---- scan-2 pair scoring over anchor pairs -----------------------
        M1 = sc1["match_k"][:, :, None].to(torch.int32)
        M2 = sc2["match_k"][:, None, :].to(torch.int32)
        MM1 = sc1["mism_k"][:, :, None].to(torch.int32)
        MM2 = sc2["mism_k"][:, None, :].to(torch.int32)

        def spans(sc, lens):
            # chromosomal span end (leading S + M + D) and deleted bases
            ind = sc["indel_k"].to(torch.int64)
            dele = torch.clamp(ind, min=0)
            ins = torch.clamp(-ind, min=0)
            end = (sc["pos_k"] + lens[:, None].to(torch.int64) - ins
                   - sc["clip_r_k"].to(torch.int64) + dele)
            return end, dele

        end1, skip1 = spans(sc1, lens1)
        end2, skip2 = spans(sc2, lens2)
        tl2 = torch.maximum(end1[:, :, None], end2[:, None, :]) - torch.minimum(P1, P2)
        sk = skip1[:, :, None] + skip2[:, None, :]
        tl2 = torch.where(tl2 > sk, tl2 - sk, tl2)
        pe2 = same & (tl2 >= cfg.min_fragment) & (tl2 <= cfg.max_fragment)
        w2 = torch.where(pe2, 120, torch.where(same, 100, 80))
        primary = (w2 * (M1 + M2)) * 1000 - MM1 - MM2
        d_tl = (tl2 - expected_tlen).abs()
        tl_sc = torch.where(pe2 & (d_tl <= 999), 999 - d_tl, 0)
        if cfg.multi_best > 1:
            tl_sc = torch.zeros_like(tl_sc)      # no TLEN preference with -B
        pair_ok = ok1[:, :, None] & ok2[:, None, :]
        primary = torch.where(pair_ok, primary, -1)

        def storage_rank(tk, okc_all, pos):
            # rank of each candidate in the per-end bigtable, stored in
            # combo order with position dedup; 9 = not stored
            BIGR = 9
            rank = torch.full(pos.shape, BIGR, dtype=torch.int32, device=dev)
            cursor = torch.zeros(pos.shape[0], dtype=torch.int32, device=dev)
            seen = []
            for c in range(tk.shape[1]):
                kc, okc = tk[:, c], okc_all[:, c]
                pc = torch.gather(pos, 1, kc[:, None])[:, 0]
                dup = torch.zeros_like(okc)
                for pp, oo in seen:
                    dup = dup | ((pp == pc) & oo)
                new = okc & ~dup
                assign = (ar[None, :] == kc[:, None]) & new[:, None] & (rank == BIGR)
                rank = torch.where(assign, cursor[:, None], rank)
                cursor = cursor + new.to(torch.int32)
                seen.append((pc, okc))
            return rank

        # bigtable storage order: among tied combos the last generated is
        # stored first, so the top-3 columns are re-sorted by (score desc,
        # generation desc) before ranking (the JAX method's default branch;
        # its SUBREAD_PE_TIE_FWD switch is not ported)
        score_c = top_key // KK
        gen_c = (KK - 1) - (top_key % KK)
        colkey = torch.where(top_ok, score_c * KK + gen_c, -1)
        perm = torch.argsort(-colkey, dim=1, stable=True)
        tk1_s, tk2_s = torch.gather(tk1, 1, perm), torch.gather(tk2, 1, perm)
        ok_s = torch.gather(top_ok, 1, perm)
        kcol = ar[None, :].to(torch.int32)
        # single-end fallback anchors rank in candidate order
        r1_rank = torch.where(any_combo[:, None], storage_rank(tk1_s, ok_s, p1), kcol)
        r2_rank = torch.where(any_combo[:, None], storage_rank(tk2_s, ok_s, p2), kcol)
        # lexicographic max of (primary, tl_sc), then the first pair in
        # storage order
        best_p = primary.reshape(R, KK).amax(1)
        at_p = primary == best_p[:, None, None]
        tl_m = torch.where(at_p, tl_sc, -1)
        best_t = tl_m.reshape(R, KK).amax(1)
        at_best = at_p & (tl_m == best_t[:, None, None])
        rp = r1_rank[:, :, None] * 16 + r2_rank[:, None, :]
        rp_m = torch.where(at_best, rp, 0x7FFF)
        bi = torch.argmin(rp_m.reshape(R, KK), dim=1)  # first minimum, as JAX
        bk1, bk2 = bi // K, bi % K
        paired = has1 & has2 & (best_p >= 0)

        # break-even: a distinct (pos, cigar) pair ties the best
        def same_as_best(sc, kbest):
            eqs = None
            for f in ("pos_k", "strand_k", "indel_k", "split_k",
                      "clip_l_k", "clip_r_k"):
                e = sc[f] == torch.gather(sc[f], 1, kbest[:, None])
                eqs = e if eqs is None else (eqs & e)
            return eqs                                     # [R, K]

        distinct = ~(same_as_best(sc1, bk1)[:, :, None]
                     & same_as_best(sc2, bk2)[:, None, :])
        n_eq = 1 + (at_best & distinct).reshape(R, KK).sum(1)
        breakeven = paired & (n_eq > 1)

        # ---- single-end fallbacks (one or both ends unexplained) ---------
        def se_best(sc, ok):
            score_m = torch.where(ok, sc["score_k"], -1)
            kbest = torch.argmax(score_m, dim=1)
            b_s = torch.gather(score_m, 1, kbest[:, None])
            be = ((score_m == b_s) & ok & ~same_as_best(sc, kbest)).sum(1) > 0
            return kbest, be

        se_k1, se_be1 = se_best(sc1, ok1)
        se_k2, se_be2 = se_best(sc2, ok2)
        k1 = torch.where(paired, bk1, se_k1)
        k2 = torch.where(paired, bk2, se_k2)
        be1 = torch.where(paired, breakeven, se_be1)
        be2 = torch.where(paired, breakeven, se_be2)

        def pick(sc, kk, ok, has, n_anch, be):
            take = lambda a: torch.gather(a, 1, kk[:, None])[:, 0]
            b_mism, b_pos = take(sc["mism_k"]), take(sc["pos_k"])
            b_cl, b_cr = take(sc["clip_l_k"]), take(sc["clip_r_k"])
            b_strand, b_votes = take(sc["strand_k"]), take(sc["votes_k"])
            mapped = take(ok) & has
            mapq = torch.where(
                be, 0,
                cfg.mapq_unique // torch.clamp(
                    n_anch + b_mism.to(torch.int32), min=1),
            ).to(torch.int32)
            if not cfg.report_multi_mapping:
                mapped = mapped & ~be
            cl_w = torch.where(mapped, b_cl, 0)
            cr_w = torch.where(mapped, b_cr, 0)
            out = dict(
                clip_l=cl_w, clip_r=cr_w,
                pos=torch.where(mapped, u32(b_pos + cl_w), b_pos),
                strand=b_strand, indel=take(sc["indel_k"]),
                split=take(sc["split_k"]), mism=b_mism, votes=b_votes,
                mapped=mapped, multi=be, mapq=mapq,
                n_anchors=n_anch.to(torch.int8),
                cov_start=take(sc["cov_s_k"]).to(torch.int16),
                cov_end=take(sc["cov_e_k"]).to(torch.int16),
                best_k=kk.to(torch.int32),
            )
            # the chosen candidate's per-probe kv, of its own strand scan,
            # and the multi-indel flag (gated by min_votes_second here)
            pkv_k = sc["probe_kv_k"]
            b_pkv2 = torch.gather(
                pkv_k, 1, kk[:, None, None].expand(-1, 1, pkv_k.shape[2])
            )[:, 0]
            P0 = b_pkv2.shape[1] // 2
            b_pkv = torch.where(b_strand[:, None] == 1, b_pkv2[:, P0:], b_pkv2[:, :P0])
            anchored = (b_pos != SENTINEL) & (b_votes >= cfg.min_votes_second)
            validp = (b_pkv != SENTINEL) & anchored[:, None]
            delta = torch.where(validp, u32(b_pkv - b_pos[:, None]), SENTINEL)
            ds = torch.sort(delta, dim=1).values
            nvalid = validp.sum(1)
            j = torch.arange(1, P0, device=dev)[None, :]
            trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
            n_distinct = (nvalid > 0).to(torch.int64) + trans.sum(1)
            out["multi_indel"] = (n_distinct >= 3) & anchored
            out["probe_kv"] = b_pkv
            return out

        return (pick(sc1, k1, ok1, has1, n_anch1, be1),
                pick(sc2, k2, ok2, has2, n_anch2, be2))

    def _device_align_pe(self, c1, a1, l1, c2, a2, l2, ul1=None, ul2=None,
                         rescue=False, vp=None):
        """Paired-end votes, scan-2 scoring of both ends and pair selection
        for one sub-batch, with the paired rescue fold unless `rescue`.
        As in the JAX method, both ends vote against index block 0 only."""
        cfg = self.cfg
        if vp is None:
            vp = self.rescue_vote_params if rescue else self.vote_params
        # the reference's paired-end candidate lists are longer than a
        # single-end top-K: at least 8 per end
        if vp.top_k < 8:
            vp = vp._replace(top_k=8)
        blk = self.dev_index.blocks[0]

        def vote(c, a, l, ul):
            return vote_batch(
                c, a, l, blk.bucket_start, blk.comb, blk.bucket_bits, vp,
                static_len=ul, sub_base=blk.sub_base, sub_lo=blk.sub_lo,
                sub_bits=blk.sub_bits, search_steps=blk.search_steps,
            )

        v1, v2 = vote(c1, a1, l1, ul1), vote(c2, a2, l2, ul2)
        # both ends' candidate lists use min_votes_second; min_votes gates
        # combos and anchors inside _select_pe
        sc1 = self._score_candidates(c1, a1, l1, v1, cfg.min_votes_second, ul1)
        sc2 = self._score_candidates(c2, a2, l2, v2, cfg.min_votes_second, ul2)
        r1, r2 = self._select_pe(
            l1, l2, sc1, sc2, (cfg.min_fragment + cfg.max_fragment) // 2
        )
        if cfg.detect_junctions:
            r1 = self._pe_junction_update(c1, l1, v1, sc1, r1, ul1)
            r2 = self._pe_junction_update(c2, l2, v2, sc2, r2, ul2)
        if not cfg.all_junctions:      # fusion detection reads best_k
            r1.pop("best_k")
            r2.pop("best_k")
        r1["saturated"] = v1.saturated
        r2["saturated"] = v2.saturated
        if not rescue and self.rescue_fold_cap:
            r1, r2 = self._rescue_fold_pe(c1, a1, l1, c2, a2, l2, r1, r2, ul1, ul2)
        return r1, r2

    def _rescue_fold_pe(self, c1, a1, l1, c2, a2, l2, r1, r2, ul1, ul2):
        """The paired rescue fold: pairs where either end saturated go
        through each tier's wider pass (pair selection mixes both ends'
        tables, so both records are rescattered); a pair stays flagged
        between tiers while either end's tier vote re-saturated."""
        r1["saturated"] = r1["saturated"] | r2["saturated"]
        r2["saturated"] = r1["saturated"]
        for vp, cap in self.rescue_tiers:
            sat = r1["saturated"] | r2["saturated"]
            rb = min(cap, c1.shape[0])
            idx_r, valid_r, c1r, a1r, l1r = self._sat_compact(sat, c1, a1, l1, rb)
            r1r, r2r = self._device_align_pe(
                c1r, a1r, l1r, c2[idx_r], a2[idx_r], l2[idx_r],
                ul1=ul1, ul2=ul2, rescue=True, vp=vp,
            )
            r1["saturated"] = sat
            r2["saturated"] = sat
            r1 = self._sat_scatter(r1, r1r, idx_r, valid_r)
            r2 = self._sat_scatter(r2, r2r, idx_r, valid_r)
        return r1, r2

    # --- host orchestration -------------------------------------------------

    def _pad_batch(self, batch: ReadBatch):
        cfg = self.cfg
        R = len(batch)
        Rp = -(-R // cfg.batch_reads) * cfg.batch_reads if R else cfg.batch_reads
        Lp = max(cfg.pad_read_len, batch.max_len)
        if R == Rp and batch.max_len == Lp:
            return (
                np.ascontiguousarray(batch.codes),
                np.ascontiguousarray(batch.ambig),
                batch.lengths.astype(np.int32, copy=False),
                R,
            )
        codes = np.zeros((Rp, Lp), np.uint8)
        ambig = np.zeros((Rp, Lp), bool)
        lens = np.zeros(Rp, np.int32)
        codes[:R, : batch.max_len] = batch.codes
        ambig[:R, : batch.max_len] = batch.ambig
        lens[:R] = batch.lengths
        return codes, ambig, lens, R

    def _upload_reads(self, codes, ambig, lens):
        """Pack on the host, upload, unpack on the device: the 2-bit words
        move a fifth of the bytes of the codes and mask."""
        words, amask = dna.pack_reads_host(codes, ambig)
        dev = self.device
        d_amask = upload(amask.view(np.int32), dev) if ambig.any() else None
        dc, da = dna.unpack_reads_device(
            upload(words.view(np.int32), dev), d_amask, codes.shape[1]
        )
        return dc, da, upload(np.ascontiguousarray(lens, dtype=np.int32), dev)

    def align_batch(self, batch: ReadBatch) -> dict[str, np.ndarray]:
        return self.collect_batch(self.submit_batch(batch))

    @timing.span("submit")
    def submit_batch(self, batch: ReadBatch):
        """Upload and queue every sub-batch of a chunk; nothing here waits
        for the device."""
        codes, ambig, lens, R = self._pad_batch(batch)
        ul = uniform_length(lens[:R])
        bs = self.cfg.batch_reads
        pending = []
        for j in range(len(lens) // bs):
            sl = slice(j * bs, (j + 1) * bs)
            with timing.span("submit.upload"):
                dc, da, dl = self._upload_reads(codes[sl], ambig[sl], lens[sl])
            with timing.span("submit.launch"):
                pending.append(self._device_align(dc, da, dl, uniform_len=ul))
        return pending, R, batch

    @timing.span("collect")
    def collect_batch(self, state) -> dict[str, np.ndarray]:
        """Read a chunk's results back as the dict the JAX pipeline's
        collect_batch gives the host: the same keys and numpy dtypes; best_k
        left out but with --allJunctions; probe_kv present only when some
        sub-batch has a read flagged for host indel placement, with the
        rows PKV_CAP describes and zero rows for sub-batches without
        flags."""
        pending, R, batch = state
        keep = self.cfg.all_junctions
        out = _merge_parts([_host_part(res, keep) for res in pending], R, 0)
        self._rescue_saturated(batch, out)
        return out

    def _rescue_rows(self, batch: ReadBatch, ii: np.ndarray, RB: int):
        """Rows `ii` of a batch padded to RB reads, on the device, for the
        host rescue: (codes, ambig, lens, uniform length)."""
        Lp = max(self.cfg.pad_read_len, batch.max_len)
        codes = np.zeros((RB, Lp), np.uint8)
        ambig = np.zeros((RB, Lp), bool)
        lens = np.zeros(RB, np.int32)
        codes[: len(ii), : batch.max_len] = batch.codes[ii]
        ambig[: len(ii), : batch.max_len] = batch.ambig[ii]
        lens[: len(ii)] = batch.lengths[ii]
        return (*self._upload_reads(codes, ambig, lens),
                uniform_length(lens[: len(ii)]))

    def _escalate(self, align, still, n: int):
        """align(vp) with the rescue vote parameters, then again with the
        cluster window doubled (up to 256) while still(result) flags one of
        the first n rows; returns the last result."""
        vp = self.rescue_vote_params
        res = align(vp)
        while vp.window < 256 and still(res)[:n].any().item():
            vp = vp._replace(window=min(vp.window * 2, 256))
            res = align(vp)
        return res

    @timing.span("rescue")
    def _rescue_saturated(self, batch: ReadBatch, out: dict) -> None:
        """Re-align the reads still saturated after the device tiers through
        the uncut wide pass, doubling the cluster window (to 256) while the
        span-overflow guard still flags them, and overwrite their records."""
        sat = out.get("saturated")
        if sat is None or not sat.any():
            return
        idx = np.flatnonzero(sat)
        RB = min(self.cfg.batch_reads, 256)
        if "probe_kv" in out:
            P = out["probe_kv"].shape[1]
        else:
            P = self.vote_params.total_subreads * max(self.index.index_gap, 1)
        for s in range(0, len(idx), RB):
            ii = idx[s : s + RB]
            dc, da, dl, ul = self._rescue_rows(batch, ii, RB)
            res = self._escalate(
                lambda vp: self._device_align(
                    dc, da, dl, uniform_len=ul, rescue=True, vp=vp
                ),
                lambda r: r["saturated"], len(ii),
            )
            got_indel = False
            for k, v in res.items():
                if k == "probe_kv":
                    continue
                a = _host(k, v)
                if k in out:
                    out[k][ii] = a[: len(ii)]
                if k == "indel" and (a[: len(ii)] != 0).any():
                    got_indel = True
            if "probe_kv" in res and (got_indel or "probe_kv" in out):
                if "probe_kv" not in out:
                    out["probe_kv"] = np.full(
                        (len(out["pos"]), P), 0xFFFFFFFF, np.uint32
                    )
                out["probe_kv"][ii] = _host("probe_kv", res["probe_kv"])[: len(ii)]

    # --- paired-end host orchestration ---------------------------------------

    def align_batch_pe(self, b1: ReadBatch, b2: ReadBatch):
        return self.collect_batch_pe(self.submit_batch_pe(b1, b2))

    @timing.span("submit")
    def submit_batch_pe(self, b1: ReadBatch, b2: ReadBatch):
        """Upload and queue every sub-batch of a chunk of pairs; nothing
        here waits for the device."""
        c1, a1, l1, R = self._pad_batch(b1)
        c2, a2, l2, _ = self._pad_batch(b2)
        ul1, ul2 = uniform_length(l1[:R]), uniform_length(l2[:R])
        bs = self.cfg.batch_reads
        pending = []
        for j in range(len(l1) // bs):
            sl = slice(j * bs, (j + 1) * bs)
            with timing.span("submit.upload"):
                m1 = self._upload_reads(c1[sl], a1[sl], l1[sl])
                m2 = self._upload_reads(c2[sl], a2[sl], l2[sl])
            with timing.span("submit.launch"):
                pending.append(self._device_align_pe(*m1, *m2, ul1=ul1, ul2=ul2))
        return pending, R, b1, b2

    @timing.span("collect")
    def collect_batch_pe(self, state):
        """Read a chunk's paired results back as the two dicts the JAX
        pipeline's collect_batch_pe gives the host: the same keys and numpy
        dtypes (mism, clip_l, clip_r narrowed to int16), best_k left out
        but with --allJunctions, probe_kv as collect_batch gives it but
        with SENTINEL rows for sub-batches without flags; then the host
        paired rescue."""
        pending, R, b1, b2 = state
        keep = self.cfg.all_junctions
        out1, out2 = (
            _merge_parts([_host_part(pair[m], keep) for pair in pending], R,
                         0xFFFFFFFF)
            for m in (0, 1)
        )
        self._rescue_saturated_pe(b1, b2, out1, out2)
        return out1, out2

    @timing.span("rescue")
    def _rescue_saturated_pe(self, b1, b2, out1: dict, out2: dict) -> None:
        """Paired twin of _rescue_saturated: re-align the pairs where either
        end is still saturated, with the same window escalation, and
        overwrite every key of both records except probe_kv, which the JAX
        pipeline's paired rescue leaves as the main pass wrote it."""
        sat1, sat2 = out1.get("saturated"), out2.get("saturated")
        if sat1 is None or sat2 is None:
            return
        sat = sat1 | sat2
        if not sat.any():
            return
        idx = np.flatnonzero(sat)
        RB = min(self.cfg.batch_reads, 256)
        for s in range(0, len(idx), RB):
            ii = idx[s : s + RB]
            dc1, da1, dl1, ul1 = self._rescue_rows(b1, ii, RB)
            dc2, da2, dl2, ul2 = self._rescue_rows(b2, ii, RB)
            r1, r2 = self._escalate(
                lambda vp: self._device_align_pe(
                    dc1, da1, dl1, dc2, da2, dl2, ul1=ul1, ul2=ul2,
                    rescue=True, vp=vp,
                ),
                lambda r: r[0]["saturated"] | r[1]["saturated"], len(ii),
            )
            for res, out in ((r1, out1), (r2, out2)):
                for k, v in res.items():
                    if k != "probe_kv" and k in out:
                        out[k][ii] = _host(k, v)[: len(ii)]

    # --- junction event-table rescue and chaining ----------------------------

    def _junction_rescue_step(self, codes, lens, pos, strand, ev_left,
                              ev_right) -> dict[str, np.ndarray]:
        """One sub-batch of the event-table rescue on the device (numpy
        rows in, the JAX step's numpy dict out: pos uint32, ok bool, the
        rest int32)."""
        dev = self.device
        lens_d = upload(np.ascontiguousarray(lens), dev)
        oriented = oriented_read(
            upload(np.ascontiguousarray(codes), dev), lens_d,
            upload(np.ascontiguousarray(strand), dev),
        )
        rj = junction_rescue(
            self.dev_index.genome_words, oriented, lens_d,
            upload(np.ascontiguousarray(pos).astype(np.int64), dev),
            ev_left, ev_right,
        )
        return {k: _host(k, t) for k, t in rj.items()}

    # The host methods below, rescue_with_events to chain_clipped_junctions,
    # follow the JAX package's rule for rule; the rescue's device step is
    # _junction_rescue_step.

    @timing.span("junction")
    def rescue_with_events(self, batch: ReadBatch, res: dict,
                           ev_left: np.ndarray, ev_right: np.ndarray,
                           ev_donor: dict | None = None) -> dict:
        """Scan-2 event-table sharing (explain_read, core-junction.c:2617):
        re-explain every anchored read against the global junction table;
        a table junction that explains the read with fewer mismatches (or
        rescues an unmapped read) replaces the plain alignment.  ev_donor,
        {(left, right): donor strand} of the table's events, gives a
        rescued read its donor strand."""
        cfg = self.cfg
        if len(ev_left) == 0 or "junc" not in res:
            return res
        # pad the event table to a power of two: the clamp at E-1 in
        # junction_rescue then repeats a padding event
        E = 1 << max(4, int(np.ceil(np.log2(len(ev_left)))))
        pad = np.full(E - len(ev_left), 0xFFFFFFFF, np.uint32)
        d_left = upload(np.concatenate([ev_left, pad]).astype(np.int64),
                        self.device)
        d_right = upload(np.concatenate([ev_right, pad]).astype(np.int64),
                         self.device)

        codes, ambig, lens, R = self._pad_batch(batch)
        n = len(lens)
        pos_p = np.full(n, 0xFFFFFFFF, np.uint32)
        # the rescue anchors at the position of the read's FIRST base:
        # a soft-clipped alignment's pos was shifted by clip_l, undo it
        clip_l = np.asarray(res.get("clip_l", np.zeros(R, np.int32)))
        clip_r = np.asarray(res.get("clip_r", np.zeros(R, np.int32)))
        pos_p[:R] = np.where(
            res["pos"] != np.uint32(0xFFFFFFFF),
            res["pos"] - clip_l.astype(np.uint32), res["pos"],
        )
        # vote-tied repeat copies: an unanchored read with a valid alt2
        # funnels the alt anchor into arm 1 (otherwise it has no anchor at
        # all); anchored reads keep their own anchor for arm 1 and try the
        # alternate copy in arm 2 — the event table decides which copy
        # explains the read, exactly like the reference's per-candidate
        # scan-2 explain_read (no smaller-copy preference)
        if "alt2_pos" in res:
            tied0 = (
                np.asarray(res["alt2_ok"], bool)
                & (pos_p[:R] == np.uint32(0xFFFFFFFF))
                & (res["alt2_pos"] != np.uint32(0xFFFFFFFF))
            )
            pos_p[:R] = np.where(tied0, res["alt2_pos"], pos_p[:R])
            res = dict(res)
            res["alt2_pos"] = np.where(
                tied0, np.uint32(0xFFFFFFFF), res["alt2_pos"]
            )
        strand_p = np.zeros(n, np.int32)
        strand_p[:R] = res["strand"]
        bs = cfg.batch_reads
        parts = []
        for i in range(0, n, bs):
            sl = slice(i, i + bs)
            parts.append(self._junction_rescue_step(
                codes[sl], lens[sl], pos_p[sl], strand_p[sl], d_left, d_right,
            ))
        rj = {k: np.concatenate([p[k] for p in parts])[:R] for k in parts[0]}

        # anchored on the FUNNELED anchor: an unanchored read whose valid
        # alt2 was funneled into pos_p is rescuable at that anchor (the
        # original res["pos"] is the sentinel for those reads)
        anchored = pos_p[:R] != np.uint32(0xFFFFFFFF)
        # costs in matched-bases space: clipped bases are unmatched
        plain_cost = np.asarray(res["mism"]).astype(np.int64) + clip_l + clip_r
        rj_cost = (
            np.asarray(rj["mism"]).astype(np.int64)
            + np.asarray(rj["clip_l"]) + np.asarray(rj["clip_r"])
        )
        accept = (
            rj["ok"] & anchored & ~res["junc"].astype(bool)
            & (rj["mism"] <= cfg.max_mismatches)
            & ((rj_cost + 1 < plain_cost) | ~res["mapped"].astype(bool))
        )
        # second arm: break-even repeat copies re-explained at the OTHER
        # tied location (the reference's scan-2 explain_read runs per
        # candidate; the copy holding the seeded event wins uniquely)
        if "alt2_pos" in res:
            alt_ok = np.asarray(res["alt2_ok"], bool)
            tied = alt_ok & (
                ~np.asarray(res["mapped"], bool)
                | np.asarray(res.get("multi", np.zeros(R, bool)), bool)
            ) & ~np.asarray(res["junc"], bool)
            if tied.any():
                pos2 = np.full(n, 0xFFFFFFFF, np.uint32)
                pos2[:R] = np.where(tied, res["alt2_pos"], np.uint32(0xFFFFFFFF))
                parts2 = []
                for i in range(0, n, bs):
                    sl = slice(i, i + bs)
                    parts2.append(self._junction_rescue_step(
                        codes[sl], lens[sl], pos2[sl], strand_p[sl],
                        d_left, d_right,
                    ))
                rj2 = {k: np.concatenate([p[k] for p in parts2])[:R]
                       for k in parts2[0]}
                rj2_cost = (
                    np.asarray(rj2["mism"]).astype(np.int64)
                    + np.asarray(rj2["clip_l"]) + np.asarray(rj2["clip_r"])
                )
                accept2 = (
                    rj2["ok"] & tied & ~accept
                    & (rj2["mism"] <= cfg.max_mismatches)
                    & ((rj2_cost + 1 < plain_cost)
                       | ~res["mapped"].astype(bool))
                )
                for k in ("mism", "split", "gap", "pos", "ok",
                          "clip_l", "clip_r"):
                    rj[k] = np.where(accept2, rj2[k], rj[k])
                # break-even across repeat copies: when BOTH tied anchors
                # explain the read through table events at EQUAL cost and
                # distinct positions, the reference's scan-2 keeps both
                # equal-best candidates and break-even suppresses the read
                # (highest_score_occurence >= 2, core.c:2760) — a segdup
                # twin region where both copies carry seeded events maps
                # nothing.  Revoke the arm-1 acceptance for those rows.
                be = (
                    accept & tied & np.asarray(rj2["ok"], bool)
                    & (rj2["mism"] <= cfg.max_mismatches)
                    & (rj2_cost == (
                        np.asarray(rj["mism"]).astype(np.int64)
                        + np.asarray(rj["clip_l"]) + np.asarray(rj["clip_r"])
                    ))
                    & (np.asarray(rj2["pos"]) != np.asarray(rj["pos"]))
                    # symmetric twin events only (same intron length at
                    # both copies): the segdup signature where the two
                    # explanations are structurally identical and the
                    # reference's equal scores provably tie; asymmetric
                    # pairs break the tie through MATCH/penalty detail
                    & (np.asarray(rj2["gap"]) == np.asarray(rj["gap"]))
                    # and only for reads with NO own anchor quality at all
                    # (pre-rescue unmapped): a multi-flagged read that the
                    # PE weighting still anchored keeps its arm-1 rescue,
                    # matching the reference's PE-weighted combination
                    # scores which break these ties (core-junction.c:2336)
                    & ~np.asarray(res["mapped"], bool)
                )
                accept = (accept | accept2) & ~be
        out = dict(res)
        # an event-table explanation resolves a vote-level tie: only the
        # copy holding the seeded event explains the read, so the read is
        # unique after scan 2 (reference MAPQ = 40/(Nc+Nmm),
        # doc/SubreadUsersGuide.tex:580-592 — Nc counts the candidates)
        was_tied = np.asarray(res.get("multi", np.zeros(R, bool)), bool)
        untied = accept & (was_tied | ~res["mapped"].astype(bool))
        if "multi" in res:
            out["multi"] = np.where(accept, False, was_tied)
        if "mapq" in res and "n_anchors" in res:
            nc = np.asarray(res["n_anchors"], np.int64)
            out["mapq"] = np.where(
                untied,
                cfg.mapq_unique // np.maximum(nc + rj["mism"], 1),
                res["mapq"],
            ).astype(res["mapq"].dtype)
        out["junc"] = np.where(accept, True, res["junc"]).astype(bool)
        out["split"] = np.where(accept, rj["split"], res["split"])
        out["junc_gap"] = np.where(accept, rj["gap"], res["junc_gap"])
        out["mism"] = np.where(accept, rj["mism"], res["mism"])
        out["indel"] = np.where(accept, 0, res["indel"])
        out["mapped"] = res["mapped"] | accept
        # rescued junction records: pos advances past the noisy clipped
        # head (the CIGAR is clS (split-cl)M gapN ... crS) and split is
        # stored relative to the clipped region, like the direct path
        out["pos"] = np.where(
            accept,
            np.asarray(rj["pos"]) + np.asarray(rj["clip_l"]).astype(np.uint32),
            res["pos"],
        )
        out["split"] = np.where(
            accept, rj["split"] - rj["clip_l"], out["split"]
        )
        if "clip_l" in res:
            out["clip_l"] = np.where(accept, rj["clip_l"], res["clip_l"])
            out["clip_r"] = np.where(accept, rj["clip_r"], res["clip_r"])
        # donor strand of a rescued read comes from the event table
        if "junc_donor_strand" in res and ev_donor is not None:
            le = out["pos"].astype(np.int64) + out["split"].astype(np.int64) - 1
            re_ = le + out["junc_gap"].astype(np.int64) + 1
            ds = out["junc_donor_strand"].copy()
            for i in np.flatnonzero(accept):
                ds[i] = ev_donor.get((int(le[i]), int(re_[i])), 0)
            out["junc_donor_strand"] = ds
        return out

    def _reported_mask(self, res) -> np.ndarray:
        """The emit predicate: rows whose record reaches the output as a
        mapped alignment (mapped, in-contig-range, and not suppressed as
        multi-mapping).  Junction-support counting is gated on this so the
        .junction.bed matches the reported records exactly, like the
        reference's write_junction_final_results (core-junction.c:4286)."""
        lin = np.asarray(res["pos"]).astype(np.int64)
        cidx, coff = self.genome.linear_to_chro(lin)
        ok = (
            np.asarray(res["mapped"], bool)
            & (coff >= 0) & (coff < self.genome.lengths[cidx])
        )
        if not self.cfg.report_multi_mapping and "multi" in res:
            ok = ok & ~np.asarray(res["multi"], bool)
        return ok

    @timing.span("junction")
    def chain_clipped_junctions(self, batch: ReadBatch, res: dict,
                                junctions: dict, events: dict | None = None,
                                count_primary: bool = True,
                                mask: np.ndarray | None = None) -> dict:
        """Multi-junction CIGARs (e.g. the reference's 8M98N74M168N19M):
        a junction read whose clipped end is explained by ANOTHER table
        junction genome-adjacent to its aligned span gets a second N op
        (explain_read walks up to MAX_EVENTS_IN_READ=8 events,
        core-junction.c:2617; here: one extra event per clipped side).
        Host pass over the (rare) clipped junction reads."""
        if events is None:
            events = junctions
        if "junc" not in res or not events:
            return res
        junc = np.asarray(res["junc"], bool)
        if mask is not None:
            junc = junc & np.asarray(mask, bool)
        R = len(junc)
        zeros = np.zeros(R, np.int32)
        cl = np.asarray(res.get("clip_l", zeros))
        cr = np.asarray(res.get("clip_r", zeros))
        cand = np.flatnonzero(junc & ((cl >= 6) | (cr >= 6)))
        if len(cand) == 0:
            return res

        g = self.genome
        name_to_idx = {n: i for i, n in enumerate(g.names)}
        by_right: dict[int, tuple[int, int]] = {}
        by_left: dict[int, tuple[int, int]] = {}
        for (chro, le, re_, ds) in events:
            c = name_to_idx.get(chro)
            if c is None:
                continue
            ll = g.chro_to_linear(c, le)
            rl = g.chro_to_linear(c, re_)
            by_right[rl] = (ll, ds)
            by_left[ll] = (rl, ds)
        overrides = res.get("cigar_override") or {}
        pos_arr = np.asarray(res["pos"]).copy()
        mism_arr = np.asarray(res["mism"], np.int32).copy()
        changed = False
        for i in cand:
            L = int(batch.lengths[i])
            o = batch.codes[i, :L]
            if int(res["strand"][i]):
                o = 3 - o[::-1]
            p0 = int(pos_arr[i])
            ci, cli, cri = int(res["split"][i]), int(cl[i]), int(cr[i])
            gap = int(res["junc_gap"][i])
            tail_m = L - cli - ci - cri
            ci0 = ci  # pre-chain split (the primary junction's geometry)
            mm_add = 0
            new_pos = p0
            head_cig = tail_cig = None
            if cli >= 6:
                # slack d: the clipped boundary may sit a couple of bases
                # past the true exon edge (the clip bound is heuristic)
                for d in (0, 1, 2):
                    if p0 + d not in by_right or ci - d < 8:
                        continue
                    le2, ds2 = by_right[p0 + d]
                    pre = cli + d
                    s2 = le2 - pre + 1
                    if s2 < 0:
                        continue
                    seg = g.codes[s2 : s2 + pre]
                    mm = int(np.sum(seg != o[:pre]))
                    if mm <= 2:
                        head_cig = (pre, (p0 + d) - le2 - 1)
                        ci -= d
                        new_pos = s2
                        mm_add += mm
                        cidx, coff = g.linear_to_chro(np.asarray([le2]))
                        # key uses contig coords of (le, re)
                        key = (g.names[int(cidx[0])], int(coff[0]),
                               int(coff[0]) + ((p0 + d) - le2), ds2)
                        sup, ml, mr = junctions.get(key, (0, 0, 0))
                        junctions[key] = (sup + 1, max(ml, pre), max(mr, ci))
                        break
            last_base = p0 + ci0 + gap + tail_m - 1
            if cri >= 8 and (last_base in by_left):
                re2, ds2 = by_left[last_base]
                seg = g.codes[re2 : re2 + cri]
                if len(seg) == cri:
                    mm = int(np.sum(seg != o[L - cri:]))
                    if mm <= 2:
                        tail_cig = (re2 - last_base - 1, cri)
                        mm_add += mm
                        cidx, coff = g.linear_to_chro(np.asarray([last_base]))
                        key = (g.names[int(cidx[0])], int(coff[0]),
                               int(coff[0]) + (re2 - last_base), ds2)
                        sup, ml, mr = junctions.get(key, (0, 0, 0))
                        junctions[key] = (sup + 1, max(ml, tail_m), max(mr, cri))
            if head_cig is None and tail_cig is None:
                continue
            if count_primary:
                # the SE emitter skips override reads, so count the read's
                # PRIMARY junction here (it would otherwise lose this
                # support); the PE path counts primaries via
                # collect_junctions instead
                cidx0, coff0 = g.linear_to_chro(np.asarray([p0]))
                key0 = (g.names[int(cidx0[0])], int(coff0[0]) + ci0 - 1,
                        int(coff0[0]) + ci0 + gap,
                        int(res["junc_donor_strand"][i]))
                sup, ml, mr = junctions.get(key0, (0, 0, 0))
                junctions[key0] = (sup + 1, max(ml, ci), max(mr, tail_m))
            cig = ""
            if head_cig is not None:
                cig += f"{head_cig[0]}M{head_cig[1]}N"
            elif cli:
                cig += f"{cli}S"
            cig += f"{ci}M{gap}N{tail_m}M"
            if tail_cig is not None:
                cig += f"{tail_cig[0]}N{tail_cig[1]}M"
            elif cri:
                cig += f"{cri}S"
            mism_arr[i] += mm_add
            pos_arr[i] = new_pos
            overrides[int(i)] = (cig, int(mism_arr[i]), int(mism_arr[i]))
            changed = True
        if not changed:
            return res
        out = dict(res)
        out["pos"] = pos_arr
        out["mism"] = mism_arr
        out["cigar_override"] = overrides
        return out

    @_emit_span
    def _emit_sam(
        self,
        writer: samio.SamWriter,
        batch: ReadBatch,
        res: dict[str, np.ndarray],
        summary: AlignSummary,
        junctions: dict | None = None,
        indel_events: dict | None = None,
    ):
        # fast path: the native record formatter or BAM encoder
        if junctions is None and self._emit_se_native(
            writer, batch, res, summary, indel_events
        ):
            return
        self._emit_sam_python(writer, batch, res, summary, junctions, indel_events)

    def _emit_multi_read(self, writer, batch, res, i, cidx, coff):
        """-B N multi-best reporting: primary + secondary records with
        HI/NH tags (write_realignments_for_fragment's multi_mapping loop,
        core.c:2383; MAPQ 0, secondaries flagged 0x100)."""
        g = self.genome
        L = int(batch.lengths[i])
        cands = []
        seen = set()
        N = res["alt_pos"].shape[1]
        for j in range(N):
            if not bool(res["alt_eq"][i, j]):
                continue
            lin = int(res["alt_pos"][i, j])
            st = int(res["alt_strand"][i, j])
            if (lin, st) in seen:
                continue
            seen.add((lin, st))
            cands.append((lin, st, int(res["alt_indel"][i, j]),
                          int(res["alt_split"][i, j]),
                          int(res["alt_mism"][i, j])))
        nh = len(cands)
        recs = []
        for hi, (lin, st, indel, split, mism) in enumerate(cands):
            ci2, off2 = g.linear_to_chro(np.asarray([lin], dtype=np.int64))
            off_i = int(off2[0])
            if off_i < 0 or off_i >= int(g.lengths[int(ci2[0])]):
                continue
            seq, qual = _seq_qual(batch, i, st == 1)
            cigar = _cigar_text(L, 0, 0, split, indel, None)
            flag = (samio.FLAG_REVERSE if st else 0) | (0x100 if hi else 0)
            recs.append(samio.SamRecord(
                batch.names[i], flag, g.names[int(ci2[0])], off_i + 1,
                0, cigar, seq=seq, qual=qual,
                tags=[f"HI:i:{hi + 1}", f"NH:i:{nh}",
                      f"NM:i:{mism + abs(indel)}"],
            ))
        for r in recs:
            writer.write(r)
        return len(recs) > 0

    def _se_columns(self, batch, res, drop_multi: bool) -> tuple[dict, np.ndarray]:
        """One single-end chunk's record columns for _write_records, and
        the multi-mapping reads among the mapped ones; drop_multi reports
        multi-mapping reads unmapped."""
        g = self.genome
        n = len(batch)
        cidx, coff = g.linear_to_chro(res["pos"].astype(np.int64))
        mapped = (np.asarray(res["mapped"], bool)
                  & (coff >= 0) & (coff < g.lengths[cidx]))
        multi = np.asarray(res["multi"], bool)
        if drop_multi:
            mapped &= ~multi
        z = np.zeros(n, np.int32)
        junc = res.get("junc")
        junc = mapped & (np.asarray(junc, bool) if junc is not None else False)
        indel = np.where(mapped, res["indel"], 0).astype(np.int32)
        strand = np.asarray(res["strand"], np.int32)
        cols = dict(
            names=batch.names, codes=batch.codes, quals=batch.quals,
            lens=batch.lengths.astype(np.int32),
            flags=np.where(mapped, np.where(strand == 1, samio.FLAG_REVERSE, 0),
                           samio.FLAG_UNMAPPED).astype(np.int32),
            mapped=mapped, cidx=cidx.astype(np.int32), coff=coff,
            mapq=np.asarray(res["mapq"], np.int32), indel=indel,
            split=np.asarray(res["split"], np.int32),
            junc=junc, junc_gap=np.where(junc, res.get("junc_gap", z), 0),
            clip_l=np.asarray(res.get("clip_l", z), np.int32),
            clip_r=np.asarray(res.get("clip_r", z), np.int32),
            nm=np.asarray(res["mism"], np.int32) + np.abs(indel),
            hi=np.ones(n, np.int32), nh=mapped.astype(np.int32),  # SE: tags iff mapped
        )
        return cols, multi & mapped

    def _write_records(self, writer, cols, skip=None, cigars=None) -> bool:
        """Write one emit's records from their columns in one native call,
        one a row in row order but for the rows skip marks: SAM text to a
        SamWriter, BAM records to a BamRecordWriter's BAM.  cols: names,
        codes, quals, lens, flags, mapped, cidx and coff (contig and 0-based
        offset), mapq, indel, split, junc_gap, clip_l, clip_r, nm, hi, nh
        (HI/NH tags where nh > 0) and, for pairs, rnext (-1 "*", -2 "=",
        else a contig), pnext (1-based, 0 for none) and tlen.  cigars, BAM
        only: the CIGAR strings of chosen mapped rows.  The BAM encoding's
        time, from these columns on, counts as packing.  False, with
        nothing written, when the library is missing or refuses a row."""
        from .. import native

        c = cols
        if isinstance(writer, samio.SamWriter):
            blob = native.format_sam_records(
                c["names"], c["codes"], c["quals"], c["lens"], c["flags"],
                c["cidx"], c["coff"] + 1, c["mapq"], c["indel"], c["split"],
                c["junc_gap"], c["clip_l"], c["clip_r"], c["mapped"], c["nm"],
                self.genome.names, suppress=skip, rnext_cidx=c.get("rnext"),
                pnext=c.get("pnext"), tlen=c.get("tlen"), hi=c["hi"], nh=c["nh"],
            )
            if blob is None:
                return False
            writer.write_bytes(blob)
            return True
        bam = writer.bam
        t0 = time.perf_counter_ns()
        ref_of = bam.ref_ids([*self.genome.names, "*"])
        ref_of, star = ref_of[:-1], ref_of[-1]
        mapped = np.asarray(c["mapped"], bool)
        ref_id = np.where(mapped, ref_of[np.where(mapped, c["cidx"], 0)], star)
        n = len(mapped)
        if "rnext" in c:
            rn = np.asarray(c["rnext"])
            next_ref = np.where(rn == -2, ref_id,
                                np.where(rn == -1, star, ref_of[np.maximum(rn, 0)]))
            next_pos, tlen = np.asarray(c["pnext"]) - 1, c["tlen"]
        else:
            next_ref, next_pos, tlen = np.full(n, star), np.full(n, -1), np.zeros(n)
        got = native.format_bam_records(
            c["names"], c["codes"], c["quals"], c["lens"], c["flags"], ref_id,
            np.where(mapped, c["coff"], -1), np.where(mapped, c["mapq"], 0),
            next_ref, next_pos, tlen, mapped, c["indel"], c["split"],
            c["junc_gap"], c["clip_l"], c["clip_r"], c["nm"], c["hi"], c["nh"],
            skip=skip,
            cigars={i: cigar_ops(s) for i, s in (cigars or {}).items()},
        )
        if got is None:
            return False
        bam.add_records(*got, pack_ns=time.perf_counter_ns() - t0)
        return True

    def _emit_se_native(self, writer, batch, res, summary, indel_events) -> bool:
        """One single-end chunk's records through _write_records, and the
        summary and indel events _emit_sam_python gives.  SAM text writes
        the host rescues' CIGARs and -B multi-best records after the
        chunk; BAM keeps input order, with the rescues' CIGARs in place.
        False, with nothing written, where _emit_sam_python alone covers
        the chunk: another writer, read groups, --minMappedLength, for SAM
        text -R's dropped unmapped reads, for BAM --minMappedFraction, -B
        multi-best records, junction rows without a gap, or no library."""
        cfg = self.cfg
        sam = isinstance(writer, samio.SamWriter)
        if (cfg.rg_id or cfg.min_mapped_length > 0
                or not (sam or isinstance(writer, samio.BamRecordWriter))
                or (cfg.ignore_unmapped if sam else cfg.min_mapped_fraction > 0)):
            return False
        n = len(batch)
        # -u reports multi-mapping reads unmapped (-B N overrides); the SAM
        # text path keeps those a host rescue mapped, as the JAX package's
        # does (PERF.md section 7)
        cols, multi = self._se_columns(
            batch, res, drop_multi=not sam and not cfg.report_multi_mapping
            and cfg.multi_best <= 1)
        mapped = cols["mapped"]
        overrides = res.get("cigar_override") or {}
        multi_out = (multi if cfg.multi_best > 1 and "alt_pos" in res
                     else np.zeros(n, bool))
        if sam:
            skip = None
            if overrides or multi_out.any():
                skip = multi_out.astype(np.uint8)
                skip[list(overrides)] = 1
            if not self._write_records(writer, cols, skip):
                return False
            for i in np.flatnonzero(multi_out):
                self._emit_multi_read(writer, batch, res, int(i),
                                      cols["cidx"], cols["coff"])
            for i, (cigar, _mism, nm_i) in sorted(overrides.items()):
                if multi_out[i]:
                    continue
                seq, qual = _seq_qual(batch, i, int(res["strand"][i]) == 1)
                writer.write(samio.SamRecord(
                    batch.names[i], int(cols["flags"][i]),
                    self.genome.names[int(cols["cidx"][i])],
                    int(cols["coff"][i]) + 1, int(res["mapq"][i]), cigar,
                    seq=seq, qual=qual,
                    tags=["HI:i:1", "NH:i:1", f"NM:i:{nm_i}"],
                ))
        else:
            if multi_out.any() or (cols["junc"] & (cols["junc_gap"] <= 0)).any():
                return False   # records the encoder does not build
            overrides = {i: ov for i, ov in overrides.items()
                         if i < n and mapped[i]}
            for i, (_cigar, _mism, nm_i) in overrides.items():
                # the python path's override record has NM alone
                cols["nm"][i], cols["nh"][i] = nm_i, 0
            if not self._write_records(
                writer, cols, skip=~mapped if cfg.ignore_unmapped else None,
                cigars={i: ov[0] for i, ov in overrides.items()},
            ):
                return False
        summary.total += n
        n_mapped = int(mapped.sum())
        summary.mapped += n_mapped
        summary.unmapped += n - n_mapped
        summary.multi += int(multi.sum())
        summary.unique += n_mapped - int(multi.sum())
        plain = mapped & (cols["indel"] != 0)
        plain[list(overrides)] = False   # their producer recorded the events
        summary.indels += int((plain & ~cols["junc"]).sum()) + sum(
            "I" in ov[0] or "D" in ov[0] for ov in overrides.values())
        for i in np.flatnonzero(plain):
            _add_indel_event(indel_events, batch, res, i, int(cols["indel"][i]),
                             cols["cidx"][i], cols["coff"][i])
        return True

    def _emit_sam_python(
        self,
        writer: samio.SamWriter,
        batch: ReadBatch,
        res: dict[str, np.ndarray],
        summary: AlignSummary,
        junctions: dict | None = None,
        indel_events: dict | None = None,
    ):
        g = self.genome
        lin = res["pos"].astype(np.int64)
        cidx, coff = g.linear_to_chro(lin)
        in_contig = (coff >= 0) & (coff < g.lengths[cidx])
        mapped = res["mapped"] & in_contig
        if not self.cfg.report_multi_mapping and self.cfg.multi_best <= 1:
            # -u: multi-mapping reads are reported unmapped (-B N overrides)
            mapped = mapped & ~np.asarray(res["multi"], bool)
        z = np.zeros(len(batch), np.int32)
        clip_l, clip_r = res.get("clip_l", z), res.get("clip_r", z)
        junc = np.asarray(res.get("junc", z), bool)
        for i, name in enumerate(batch.names):
            L = int(batch.lengths[i])
            strand = int(res["strand"][i])
            seq, qual = _seq_qual(batch, i, strand == 1 and mapped[i])
            summary.total += 1
            if not mapped[i]:
                summary.unmapped += 1
                if not self.cfg.ignore_unmapped:
                    writer.write(
                        samio.SamRecord(name, samio.FLAG_UNMAPPED, "*", 0, 0,
                                        "*", seq=seq, qual=qual)
                    )
                continue
            summary.mapped += 1
            if res["multi"][i]:
                summary.multi += 1
                if self.cfg.multi_best > 1 and "alt_pos" in res:
                    # -B N: full multi-best record set (HI/NH tags)
                    if self._emit_multi_read(writer, batch, res, i, cidx,
                                             coff):
                        continue
            else:
                summary.unique += 1
            indel = int(res["indel"][i])
            split = int(res["split"][i])
            override = (res.get("cigar_override") or {}).get(i)
            if override is not None:
                cigar, mism_i, nm_i = override
                if "I" in cigar or "D" in cigar:
                    summary.indels += 1
                writer.write(
                    samio.SamRecord(
                        name, samio.FLAG_REVERSE if strand else 0,
                        g.names[int(cidx[i])], int(coff[i]) + 1,
                        int(res["mapq"][i]), cigar, seq=seq, qual=qual,
                        tags=[f"NM:i:{nm_i}"],
                    )
                )
                continue
            cl, cr = int(clip_l[i]), int(clip_r[i])
            gap = int(res["junc_gap"][i]) if junc[i] else None
            if gap is not None:
                if junctions is not None:
                    # the single-end junction count: (contig, left edge,
                    # right edge, donor strand) -> (reads, flanks)
                    p0 = int(coff[i])  # 0-based contig pos
                    key = (
                        g.names[int(cidx[i])], p0 + split - 1, p0 + split + gap,
                        int(res["junc_donor_strand"][i]),
                    )
                    sup, ml, mr = junctions.get(key, (0, 0, 0))
                    junctions[key] = (
                        sup + 1, max(ml, split), max(mr, L - cl - split - cr)
                    )
            elif indel != 0:
                summary.indels += 1
            elif (0 < self.cfg.min_mapped_length > L - cl - cr) or (
                0 < self.cfg.min_mapped_fraction
                and (L - cl - cr) * 100 < self.cfg.min_mapped_fraction * L
            ):
                # --minMappedLength / --minMappedFraction:
                # too few mapped bases -> unmapped
                summary.mapped -= 1
                summary.unmapped += 1
                if res["multi"][i]:
                    summary.multi -= 1
                else:
                    summary.unique -= 1
                if not self.cfg.ignore_unmapped:
                    writer.write(
                        samio.SamRecord(name, samio.FLAG_UNMAPPED, "*", 0,
                                        0, "*", seq=seq, qual=qual)
                    )
                continue
            cigar = _cigar_text(L, cl, cr, split, indel, gap)
            if indel != 0:
                _add_indel_event(indel_events, batch, res, i, indel,
                                 cidx[i], coff[i])
            flag = samio.FLAG_REVERSE if strand else 0
            nm = int(res["mism"][i]) + abs(indel)
            tags = ["HI:i:1", "NH:i:1"]
            if self.cfg.rg_id:
                tags.append(f"RG:Z:{self.cfg.rg_id}")
            tags.append(f"NM:i:{nm}")
            writer.write(
                samio.SamRecord(
                    name, flag, g.names[int(cidx[i])], int(coff[i]) + 1,
                    int(res["mapq"][i]), cigar, seq=seq, qual=qual,
                    tags=tags,
                )
            )

    # The paired-end host methods below, _pe_record_fields to _emit_sam_pe,
    # and _calc_tlen_cigar follow the JAX package's
    # (subread_tpu/align/pipeline.py) rule for rule.

    def _pe_record_fields(self, b1, b2, res1, res2):
        """Vectorised per-record PE fields shared by the native formatter
        and the python fallback emitter: FLAG/RNEXT/PNEXT/TLEN/proper-pair
        semantics of the reference's calc_flags/calc_tlen
        (core.c:1659-1683,1718)."""
        g = self.genome
        R = len(b1.names)
        z = np.zeros(R, np.int32)

        def prep(res, batch):
            lin = res["pos"].astype(np.int64)
            cidx, coff = g.linear_to_chro(lin)
            ok = (
                np.asarray(res["mapped"], bool)
                & (coff >= 0) & (coff < g.lengths[cidx])
            )
            if not self.cfg.report_multi_mapping:
                ok = ok & ~np.asarray(res["multi"], bool)
            return cidx.astype(np.int32), coff.astype(np.int64), ok

        c1, o1, ok1 = prep(res1, b1)
        c2, o2, ok2 = prep(res2, b2)
        L1 = b1.lengths.astype(np.int64)
        L2 = b2.lengths.astype(np.int64)
        s1 = np.asarray(res1["strand"], np.int32)
        s2 = np.asarray(res2["strand"], np.int32)

        # ---- calc_tlen (core.c:1718): signed fragment length from the
        # smaller-POS record's CIGAR walk.  Exact closed form for our
        # single-event CIGAR shapes [clS] aM [event] bM [crS]: in the
        # reference walk S consumes BOTH chro and read cursors, so the
        # first section boundary sits at POS + cl + a; if it reaches the
        # larger record's head, TLEN = consumed_read + Pbig - section_end
        # + L_larger, else the walk runs to the end (section_end =
        # POS + Lsm - insertions + deletions + junction gap) and the
        # never-hit fallback equals the end-boundary value.
        def tlen_walk():
            P1p = o1 + 1
            P2p = o2 + 1
            r1_small = P1p <= P2p
            Ps = np.where(r1_small, P1p, P2p)
            Pb = np.where(r1_small, P2p, P1p)
            Lsm = np.where(r1_small, L1, L2)
            Lbig = np.where(r1_small, L2, L1)
            pick = lambda a1, a2: np.where(
                r1_small, np.asarray(a1, np.int64), np.asarray(a2, np.int64)
            )
            ind_s = pick(res1["indel"], res2["indel"])
            spl_s = pick(res1["split"], res2["split"])
            cl_s = pick(res1.get("clip_l", z), res2.get("clip_l", z))
            junc_s = pick(
                res1.get("junc", z), res2.get("junc", z)
            ).astype(bool)
            gap_s = np.zeros(R, np.int64)
            if "junc_gap" in res1:
                gap_s = np.where(
                    junc_s,
                    pick(res1["junc_gap"], res2["junc_gap"]), 0,
                )
            has_event = (ind_s != 0) | (gap_s > 0)
            ins = np.maximum(-ind_s, 0)
            dele = np.maximum(ind_s, 0)
            gap_dn = gap_s + dele
            sec1_end = Ps + cl_s + spl_s
            hit1 = has_event & (sec1_end >= Pb)
            t_hit1 = (cl_s + spl_s) + (Pb - sec1_end) + Lbig
            sec_final = Ps + Lsm - ins + gap_dn
            t_final = Lsm + (Pb - sec_final) + Lbig
            t = np.where(hit1, t_hit1, t_final)
            t = np.where(P1p == P2p, np.maximum(L1, L2), t)
            # multi-event CIGARs (host overrides) get the literal walk
            for res_x, other_first in ((res1, True), (res2, False)):
                ov = res_x.get("cigar_override") or {}
                for i, cig in ov.items():
                    if i >= R:
                        continue
                    small_is_x = (P1p[i] <= P2p[i]) == other_first
                    if not small_is_x:
                        continue
                    t[i] = _calc_tlen_cigar(
                        str(cig), int(Ps[i]), int(Pb[i]), int(Lbig[i]),
                        int(Lsm[i]),
                    )
            # sign: smaller-POS record positive; tie -> R1's strand decides
            tie = P1p == P2p
            neg1 = np.where(tie, s1 == 1, P1p > P2p)
            t1 = np.where(neg1, -t, t)
            t2 = np.where(
                tie, np.where(s1 == 1, t, -t), np.where(P2p > P1p, -t, t)
            )
            return t1.astype(np.int64), t2.astype(np.int64)

        both = ok1 & ok2
        samec = both & (c1 == c2)
        t1_all, t2_all = tlen_walk()
        t1 = np.where(samec, t1_all, 0)
        t2 = np.where(samec, t2_all, 0)
        # proper pair (calc_flags core.c:1659-1683): same chro, |TLEN| in
        # [min,max], SAM strands opposite, forward read leftmost (fr)
        tl_in = (np.abs(t1) >= self.cfg.min_fragment) & (
            np.abs(t1) <= self.cfg.max_fragment
        )
        opp = s1 != s2
        fwd_pos = np.where(s1 == 0, o1, o2)
        rev_pos = np.where(s1 == 0, o2, o1)
        arranged = fwd_pos <= rev_pos
        proper = samec & tl_in & opp & arranged

        def mate_arrays(res, batch, cidx, coff, ok, strand,
                        mok, mcidx, mcoff, mstrand, L_self, L_mate, first,
                        tlen_signed):
            flags = np.full(R, samio.FLAG_PAIRED
                            | (samio.FLAG_FIRST if first else samio.FLAG_SECOND),
                            np.int32)
            flags = np.where(ok, flags, flags | samio.FLAG_UNMAPPED)
            flags = np.where(ok & (strand == 1),
                             flags | samio.FLAG_REVERSE, flags)
            flags = np.where(ok & proper, flags | samio.FLAG_PROPER_PAIR, flags)
            flags = np.where(~mok, flags | samio.FLAG_MATE_UNMAPPED, flags)
            # mate-reverse reflects the mate's strand even when this end is
            # unmapped (reference flag 101/133 records)
            flags = np.where(mok & (mstrand == 1),
                             flags | samio.FLAG_MATE_REVERSE, flags)
            # RNEXT/PNEXT (write_single_fragment core.c:2125-2136):
            # mate unmapped → "*" / 0; both mapped same chro → "=";
            # this end unmapped, mate mapped → mate chro NAME (the "*"
            # pointer differs from the mate's)
            rnext = np.where(
                ~mok, -1,
                np.where(ok & (cidx == mcidx), -2, mcidx),
            ).astype(np.int32)
            pnext = np.where(mok, mcoff + 1, 0).astype(np.int32)
            tlen = np.where(both, tlen_signed, 0).astype(np.int64)
            indel = np.where(ok, np.asarray(res["indel"], np.int32), 0)
            split = np.asarray(res["split"], np.int32)
            cl = np.where(ok, np.asarray(res.get("clip_l", z), np.int32), 0)
            cr = np.where(ok, np.asarray(res.get("clip_r", z), np.int32), 0)
            nm = np.asarray(res["mism"], np.int32) + np.abs(indel)
            mapq = np.asarray(res["mapq"], np.int32)
            junc = (
                np.where(ok, np.asarray(res["junc_gap"], np.int32), 0)
                if "junc_gap" in res else z
            )
            return flags, rnext, pnext, tlen, indel, split, cl, cr, nm, mapq, junc

        m1 = mate_arrays(res1, b1, c1, o1, ok1, s1, ok2, c2, o2, s2,
                         L1, L2, True, t1)
        m2 = mate_arrays(res2, b2, c2, o2, ok2, s2, ok1, c1, o1, s1,
                         L2, L1, False, t2)
        return dict(c1=c1, o1=o1, ok1=ok1, c2=c2, o2=o2, ok2=ok2,
                    m1=m1, m2=m2)

    def _emit_sam_pe_native(self, writer, b1, b2, res1, res2,
                            summary: AlignSummary,
                            indel_events: dict | None = None) -> bool:
        """Vectorised PE record emission through _write_records (mate
        columns added to the single-end ones); to BAM with the host
        rescues' CIGARs in place, to SAM text only for chunks without
        them (it would write them out of order).  The python fallback
        below formats the same shared fields."""
        if self.cfg.rg_id:
            return False
        to_bam = isinstance(writer, samio.BamRecordWriter)
        if not to_bam and (
            not isinstance(writer, samio.SamWriter)
            or res1.get("cigar_override") or res2.get("cigar_override")
        ):
            return False
        R = len(b1.names)
        if R == 0:
            return True
        Lmax = max(b1.codes.shape[1], b2.codes.shape[1])
        fl = self._pe_record_fields(b1, b2, res1, res2)
        c1, o1, ok1 = fl["c1"], fl["o1"], fl["ok1"]
        c2, o2, ok2 = fl["c2"], fl["o2"], fl["ok2"]
        m1, m2 = fl["m1"], fl["m2"]

        def interleave(a, b, dtype=None):
            out = np.empty(2 * R, dtype or a.dtype)
            out[0::2] = a
            out[1::2] = b
            return out

        codes = np.zeros((2 * R, Lmax), np.uint8)
        quals = np.zeros((2 * R, Lmax), np.uint8)
        codes[0::2, : b1.codes.shape[1]] = b1.codes
        codes[1::2, : b2.codes.shape[1]] = b2.codes
        quals[0::2, : b1.quals.shape[1]] = b1.quals
        quals[1::2, : b2.quals.shape[1]] = b2.quals
        okA = interleave(ok1.astype(np.uint8), ok2.astype(np.uint8))
        # HI/NH whenever EITHER end of the fragment mapped
        # (write_single_fragment core.c:2047)
        any_ok = (ok1 | ok2).astype(np.int32)
        cols = dict(
            codes=codes, quals=quals,
            lens=interleave(b1.lengths.astype(np.int32), b2.lengths.astype(np.int32)),
            mapped=okA, cidx=interleave(c1, c2), coff=interleave(o1, o2),
            hi=np.ones(2 * R, np.int32), nh=interleave(any_ok, any_ok),
        )
        for k, col in enumerate(("flags", "rnext", "pnext", "tlen", "indel",
                                 "split", "clip_l", "clip_r", "nm", "mapq",
                                 "junc_gap")):
            cols[col] = interleave(m1[k], m2[k])
        skip = (okA == 0) if self.cfg.ignore_unmapped else None
        cigars = None
        if to_bam:
            # the python emitter names both ends by the first's read
            cols["names"] = [x for x in b1.names for _ in (0, 1)]
            # an override replaces the CIGAR alone: NM and the tags stay
            cigars = {
                2 * i + mate: ov[0]
                for mate, (res, ok) in enumerate(((res1, ok1), (res2, ok2)))
                for i, ov in (res.get("cigar_override") or {}).items()
                if i < R and ok[i]
            }
        else:
            cols["names"] = [x for pair in zip(b1.names, b2.names) for x in pair]
        if not self._write_records(writer, cols, skip, cigars):
            return False
        summary.total += 2 * R
        n_ok = int(ok1.sum()) + int(ok2.sum())
        summary.mapped += n_ok
        summary.unmapped += 2 * R - n_ok
        multi = int((np.asarray(res1["multi"], bool) & ok1).sum()) + int(
            (np.asarray(res2["multi"], bool) & ok2).sum()
        )
        summary.multi += multi
        summary.unique += n_ok - multi
        summary.indels += int((ok1 & (m1[4] != 0)).sum()) + int(
            (ok2 & (m2[4] != 0)).sum()
        )
        mates = ((b1, res1, c1, o1, m1[4]), (b2, res2, c2, o2, m2[4]))
        rows = [(i, mate) for mate, ok in enumerate((ok1, ok2))
                for i in np.flatnonzero(ok & (mates[mate][4] != 0))]
        if to_bam:
            rows.sort()   # the python emitter's order: by pair, then mate
        for i, mate in rows:
            batch, res, cidx, coff, ind = mates[mate]
            _add_indel_event(indel_events, batch, res, i, int(ind[i]),
                             cidx[i], coff[i])
        return True

    @_emit_span
    def _emit_sam_pe(self, writer, b1, b2, res1, res2, summary: AlignSummary,
                     indel_events: dict | None = None):
        if self._emit_sam_pe_native(writer, b1, b2, res1, res2, summary,
                                    indel_events):
            return
        g = self.genome
        fl = self._pe_record_fields(b1, b2, res1, res2)
        for i, name in enumerate(b1.names):
            recs = []
            for mate, (batch, res, cidx, coff, ok, m) in enumerate(
                (
                    (b1, res1, fl["c1"], fl["o1"], fl["ok1"], fl["m1"]),
                    (b2, res2, fl["c2"], fl["o2"], fl["ok2"], fl["m2"]),
                )
            ):
                (flags_a, rnext_a, pnext_a, tlen_a, indel_a, split_a,
                 cl_a, cr_a, nm_a, mapq_a, junc_a) = m
                flag = int(flags_a[i])
                L = int(batch.lengths[i])
                # an unmapped end has no reverse flag
                seq, qual = _seq_qual(batch, i, bool(flag & samio.FLAG_REVERSE))
                summary.total += 1
                # RNEXT column (codes: -1 "*", -2 "=", else contig index);
                # printed for unmapped ends too (core.c:2140-2164)
                rn = int(rnext_a[i])
                rnext = "*" if rn == -1 else ("=" if rn == -2 else g.names[rn])
                pnext, tlen = int(pnext_a[i]), int(tlen_a[i])
                # HI/NH whenever EITHER end of the fragment mapped
                # (write_single_fragment core.c:2047)
                any_ok = bool(fl["ok1"][i]) or bool(fl["ok2"][i])
                hi_nh = ["HI:i:1", "NH:i:1"] if any_ok else []
                if not ok[i]:
                    summary.unmapped += 1
                    if self.cfg.ignore_unmapped:
                        continue
                    recs.append(
                        samio.SamRecord(name, flag, "*", 0, 0, "*",
                                        rnext=rnext, pnext=pnext, tlen=tlen,
                                        seq=seq, qual=qual, tags=hi_nh)
                    )
                    continue
                summary.mapped += 1
                if res["multi"][i]:
                    summary.multi += 1
                else:
                    summary.unique += 1
                indel = int(indel_a[i])
                override = (res.get("cigar_override") or {}).get(i)
                gap = int(junc_a[i])
                cigar = override[0] if override is not None else _cigar_text(
                    L, int(cl_a[i]), int(cr_a[i]), int(split_a[i]), indel,
                    gap if gap > 0 else None)
                if indel != 0:
                    summary.indels += 1
                    _add_indel_event(indel_events, batch, res, i, indel,
                                     cidx[i], coff[i])
                recs.append(
                    samio.SamRecord(
                        name, flag, g.names[int(cidx[i])], int(coff[i]) + 1,
                        int(mapq_a[i]), cigar, rnext=rnext, pnext=pnext,
                        tlen=tlen, seq=seq, qual=qual,
                        tags=hi_nh + [f"NM:i:{int(nm_a[i])}"],
                    )
                )
            for r in recs:
                writer.write(r)

    def align_file_pe(
        self, fq1: str, fq2: str, out_sam: str, chunk_reads: int = 1 << 20,
        readers=None,
    ) -> AlignSummary:
        """Paired-end align_file, as the JAX method; mate files of
        different lengths raise ValueError where the JAX method asserts."""
        rd1, rd2 = readers if readers else (FastqReader(fq1), FastqReader(fq2))

        def read_pair():
            b1 = rd1.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            b2 = rd2.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            if b1 is None or b2 is None:
                return None
            if len(b1) != len(b2):
                raise ValueError("mate files out of sync")
            return b1, b2

        return self._align_chunks(out_sam, read_pair, (rd1, rd2), paired=True)

    def align_file(
        self, fastq_path: str, out_sam: str, chunk_reads: int = 1 << 20,
        reader=None,
    ) -> AlignSummary:
        reader = reader if reader is not None else FastqReader(fastq_path)

        def read():
            batch = reader.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            return None if batch is None else (batch,)

        return self._align_chunks(out_sam, read, (reader,), paired=False)

    def _align_chunks(self, out_sam: str, read, readers, paired: bool) -> AlignSummary:
        """The chunk loop of align_file (paired False) and align_file_pe:
        read() gives a chunk's batches, (batch,) or (mate 1, mate 2), or
        None at the end.  Depth 1: chunk N+1 is read and submitted before
        chunk N is collected, so its device work runs under chunk N's host
        step.  Closes the readers and the writer, then writes the side
        files: .junction.bed, .breakpoints.vcf, .indel.vcf."""
        cfg = self.cfg
        summary = AlignSummary()
        tables = _ChunkTables(junctions={} if cfg.detect_junctions else None,
                              breakpoints={} if cfg.all_junctions else None)
        writer = samio.make_writer(
            out_sam, self.genome.names, [int(x) for x in self.genome.lengths],
            sam_output=cfg.sam_output or out_sam.endswith(".sam"),
            sort_by_coordinates=cfg.sort_by_coordinates,
            rg_id=cfg.rg_id, rg_extra=list(cfg.rg_extra) or None,
        )
        submit = self.submit_batch_pe if paired else self.submit_batch
        collect = self.collect_batch_pe if paired else self.collect_batch
        step = self._host_step_pe if paired else self._host_step_se
        chunk = 0
        try:
            timing.set_chunk(chunk)
            cur = read()
            state = submit(*cur) if cur is not None else None
            while cur is not None:
                timing.set_chunk(chunk + 1)
                nxt = read()
                nxt_state = submit(*nxt) if nxt is not None else None
                timing.set_chunk(chunk)
                step(writer, cur, collect(state), summary, tables)
                cur, state, chunk = nxt, nxt_state, chunk + 1
        finally:
            for r in readers:
                r.close()
            writer.close()
            timing.set_chunk(-1)
        if tables.junctions is not None:
            write_junction_bed(out_sam + ".junction.bed", tables.junctions)
        if tables.breakpoints is not None:
            write_breakpoints_vcf(out_sam + ".breakpoints.vcf", self.genome,
                                  tables.breakpoints)
        if tables.ins_piles:
            # cross-read reassembly of insertions longer than any single
            # read's clip (finalise_long_insertions, core-indel.c:4389)
            _count_events(tables.indel_events, assemble_insertion_piles(
                self.genome, tables.ins_piles, cfg.max_indel).items())
        write_indel_vcf(out_sam + ".indel.vcf", self.genome, tables.indel_events)
        return summary

    def _host_step_se(self, writer, chunk, res: dict, summary: AlignSummary,
                      t: _ChunkTables) -> None:
        """One single-end chunk's host step after collect_batch, then its
        records: without junction detection, event-table indel placement,
        multi-indel refinement and (-I > 16) the long-indel rescue; with
        it, the event-table rescue and junction chaining; the fusion
        breakpoints (--allJunctions)."""
        (batch,) = chunk
        cfg = self.cfg
        if t.junctions is None and "probe_kv" in res:
            # event-table indel placement: the reference derives every
            # indel CIGAR from a SHARED event found by its banded DP
            # (find_new_indels core-indel.c:1831); our per-read
            # min-mismatch split ties differently inside homopolymers
            self._place_events(batch, res, t)
            ov = refine_multi_indels(
                self.genome, batch, res, cfg.max_indel, self.vote_params,
                cfg.max_mismatches, cfg.min_votes,
            )
            if ov:
                _merge_overrides(res, ov, keep_earlier=False)
                res["mapped"] = np.asarray(res["mapped"], bool).copy()
                res["mapq"] = np.asarray(res["mapq"], np.int32).copy()
                for i, (_c, mm, _nm) in ov.items():
                    res["mapped"][i] = True
                    if res["mapq"][i] <= 0:
                        res["mapq"][i] = cfg.mapq_unique // (1 + mm)
        if t.junctions is None and cfg.max_indel > 16:
            # iteration three: long indels via soft-clip re-anchoring
            ov2, ev2, _ = rescue_long_indels(
                self.genome, batch, res, cfg.max_indel, piles=t.ins_piles,
            )
            if ov2:
                _merge_overrides(res, ov2, keep_earlier=True)
                _count_events(t.indel_events, ev2.items())
        if t.junctions is not None:
            # scan-2 event-table sharing: junctions discovered in this
            # chunk (plus all earlier chunks, plus -a annotated junctions)
            # rescue reads without their own minor cluster
            prelim, events = self._event_table(((batch, res),), t)
            res = self.rescue_with_events(batch, res, *events)
            # chain lookups use the full event set (prelim) but support
            # counts land in the output table (junctions)
            res = self.chain_clipped_junctions(
                batch, res, t.junctions, events=prelim,
                mask=self._reported_mask(res),
            )
        self._add_breakpoints(batch, res, t)
        self._emit_sam(writer, batch, res, summary,
                       junctions=t.junctions, indel_events=t.indel_events)

    def _host_step_pe(self, writer, chunk, res, summary: AlignSummary,
                      t: _ChunkTables) -> None:
        """One paired chunk's host step after collect_batch_pe, then its
        records: without junction detection, event-table indel placement
        per end, the clipped mates' rescue against both ends' events and
        the unmapped mates' rescue; with it, the event-table rescue,
        junction chaining and the junction count per end; the fusion
        breakpoints (--allJunctions)."""
        (b1, b2), (r1, r2) = chunk, res
        ends = ((b1, r1), (b2, r2))
        if t.junctions is None:
            # event-table indel placement per end (the single-end step's
            # shared-event rule)
            chunk_events: dict = {}
            for bb, rr in ends:
                if "probe_kv" in rr:
                    for (ss, elen), v in self._place_events(bb, rr, t).items():
                        chunk_events[(int(ss), int(elen))] = v
            # record-carried events of BOTH ends also share: a mate clipped
            # at its partner's indel boundary gets the event-crossing CIGAR
            # (scan-2 explain_read over the shared event table, core-indel.c)
            for _, rr in ends:
                ind = np.asarray(rr["indel"], np.int32)
                sel = np.flatnonzero(np.asarray(rr["mapped"], bool) & (ind != 0))
                pos_a = np.asarray(rr["pos"], np.uint32)
                spl_a = np.asarray(rr["split"], np.int32)
                cl_a = np.asarray(rr.get("clip_l", np.zeros_like(ind)))
                for q in sel:
                    # small side = last M base before the event
                    ss = int(pos_a[q]) + int(spl_a[q]) - int(cl_a[q]) - 1
                    chunk_events.setdefault((ss, int(ind[q])), (1, ""))
            for bb, rr in ends:
                indelevent.rescue_clipped_with_events(
                    self.genome, bb, rr, chunk_events,
                    max_mismatches=self.cfg.max_mismatches,
                )
            indelevent.rescue_unmapped_mates(self.genome, b1, b2, r1, r2, self.cfg)
        else:
            # scan-2 event sharing + chaining, as the single-end step: table
            # junctions (this chunk + earlier chunks + -a annotations)
            # rescue clipped/unmapped mates
            prelim, events = self._event_table(ends, t)
            r1 = self.rescue_with_events(b1, r1, *events)
            r2 = self.rescue_with_events(b2, r2, *events)
            m1, m2 = self._reported_mask(r1), self._reported_mask(r2)
            # count_primary: chained rows are skipped by the final
            # collect_junctions below (their split/junc_gap are stale), so
            # the chain counts their primary junction here — in the
            # pre-chain frame, where the ci-M block genuinely sits
            r1 = self.chain_clipped_junctions(
                b1, r1, t.junctions, events=prelim, count_primary=True, mask=m1,
            )
            r2 = self.chain_clipped_junctions(
                b2, r2, t.junctions, events=prelim, count_primary=True, mask=m2,
            )
            collect_junctions(r1, b1, self.genome, t.junctions, mask=m1)
            collect_junctions(r2, b2, self.genome, t.junctions, mask=m2)
        self._add_breakpoints(b1, r1, t)
        self._add_breakpoints(b2, r2, t)
        self._emit_sam_pe(writer, b1, b2, r1, r2, summary, t.indel_events)

    def _place_events(self, batch, res: dict, t: _ChunkTables) -> dict:
        """Event-table indel placement of one end (indelevent's
        propose_and_apply); the events it places go to the indel table.
        Returns them, {(small side, length): (reads, inserted bases)}."""
        ev_new, ev_done = indelevent.propose_and_apply(
            self.genome, batch, res, self.cfg,
            anchor_mism_limit=self.cfg.max_mismatches,
            index_gap=self.index.index_gap,
        )
        if ev_done:
            # these rows' events are recorded here; emitters must not
            # re-derive them from (pos, split)
            res["_events_done"] = set(ev_done)
        for (ss, elen), (sup, iseq) in ev_new.items():
            ci, co = self.genome.linear_to_chro(np.asarray([ss], np.int64))
            _count_events(t.indel_events,
                          [((int(ci[0]), int(co[0]), elen), (sup, iseq))])
        return ev_new

    def _event_table(self, ends, t: _ChunkTables):
        """The junction events of subjunc's rescue: -a's known junctions,
        the table so far, this chunk's junctions and seed junctions of each
        (batch, res) of ends.  Returns the events keyed as the table, and
        their left and right arrays and donor strands for
        rescue_with_events."""
        prelim = dict(self.annot_junctions or {})
        prelim.update(t.junctions)
        for batch, res in ends:
            collect_junctions(res, batch, self.genome, prelim)
        for _batch, res in ends:
            collect_seed_junctions(res, self.genome, prelim, t.seed_pending)
        return prelim, junction_event_arrays(self.genome, prelim)

    def _add_breakpoints(self, batch, res: dict, t: _ChunkTables) -> None:
        """Fusion breakpoints of one end's results (--allJunctions)."""
        if t.breakpoints is not None and "vk_pos" in res:
            accumulate_breakpoints(t.breakpoints, detect_fusion_pairs(
                res, batch.lengths, self.cfg.max_indel, batch=batch,
                genome=self.genome,
            ))


def _calc_tlen_cigar(cigar: str, Ps: int, Pb: int, Lbig: int,
                     Lsm: int) -> int:
    """Literal calc_tlen walk (core.c:1718) over a CIGAR string: S and M
    consume chro+read, I consumes read, D/N consume chro; at every
    I/D/N boundary and at the end, if section_end >= Pb the walk stops
    with read_cursor + Pb - section_end + Lbig."""
    chro = Ps
    read = 0
    section_end = 0
    num = 0
    ops = []
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((num, ch))
            num = 0
    for j, (n, op) in enumerate(ops):
        if op in "MS=X":
            chro += n
            read += n
            section_end = chro
        last = j == len(ops) - 1
        if op in "NDI" or last:
            if op in "ND":
                chro += n
            if section_end >= Pb:
                return read + Pb - section_end + Lbig
        if op == "I":
            read += n
    return Pb - section_end + Lbig + Lsm


@timing.span("indel")
def refine_multi_indels(
    genome: Genome, batch: ReadBatch, res: dict, max_indel: int,
    vote_params: VoteParams, max_mismatches: int = 3, min_votes: int = 3,
) -> dict[int, tuple[str, int, int]]:
    """Exact multi-indel CIGARs for reads whose winning vote cluster has
    three or more distinct probe offsets (the indel_recorder walk of
    find_new_indels, core-indel.c:1874-1906, done host-side for the rare
    flagged reads).  Returns {read_idx: (cigar, mismatches, nm)} for reads
    where the multi-indel explanation beats the single-indel one."""
    if "probe_kv" not in res:
        return {}
    pkv = res["probe_kv"].astype(np.int64)          # [R, P]
    pos = res["pos"].astype(np.int64)
    SEN = np.int64(np.uint32(0xFFFFFFFF))
    # a multi-indel read usually FAILS the single-indel mismatch gate
    # (one merged event leaves a shifted middle segment), so the flag is
    # vote anchoring, not the final mapped bit
    anchored = (pos != SEN) & (np.asarray(res["votes"]) >= min_votes)
    valid = (pkv != SEN) & anchored[:, None]
    delta = np.where(valid, pkv - pos[:, None], 0)
    if "multi_indel" in res:
        # flags were computed on device (_select_se)
        flagged = np.flatnonzero(np.asarray(res["multi_indel"], bool))
    else:
        # distinct deltas per read among valid probes, vectorised (a python
        # per-read loop here costs more than the whole device step)
        big = np.int64(1) << 62
        ds = np.sort(np.where(valid, delta, big), axis=1)
        nvalid = valid.sum(axis=1)
        j = np.arange(1, ds.shape[1])[None, :]
        trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
        n_distinct = (nvalid > 0).astype(np.int32) + trans.sum(axis=1)
        flagged = np.flatnonzero((n_distinct >= 3) & anchored)
    if len(flagged) == 0:
        return {}

    out: dict[int, tuple[str, int, int]] = {}
    KMER = 16
    for r in flagged:
        L = int(batch.lengths[r])
        strand = int(res["strand"][r])
        codes = batch.codes[r, :L]
        oriented = dna.revcomp(codes) if strand == 1 else codes
        p0 = int(pos[r])
        # probe walk in read order: sections of equal delta.  kv for
        # reverse-strand clusters was computed at the mirrored offset
        # o' = L - KMER - o in the oriented (revcomp) read.
        # probe_kv rows are already the winner's OWN strand scan (the
        # two-grid probes read the reversed read at the same offset grid),
        # so the offsets apply without mirroring
        po = _probe_offsets_host(L, vote_params)
        P = min(pkv.shape[1], len(po))
        pairs = [
            (int(po[p]), int(delta[r, p]))
            for p in range(P)
            if valid[r, p]
        ]
        pairs.sort()
        sections = []
        for off, d in pairs:
            if not sections or sections[-1][2] != d:
                sections.append([off, off, d])
            else:
                sections[-1][1] = off
        # require monotone plausible steps
        ok = all(
            abs(sections[i + 1][2] - sections[i][2]) <= max_indel
            for i in range(len(sections) - 1)
        )
        if len(sections) < 3 or not ok:
            continue
        gwin = lambda s, e, shift: _genome_codes(genome, p0 + shift + s, e - s)
        splits = []
        total_mism = 0
        prev_split = 0
        feasible = True
        for i in range(len(sections) - 1):
            lo = sections[i][1] + 1              # after last probe of sec i
            hi = min(sections[i + 1][0] + KMER - 1, L - 1)
            lo = max(lo, prev_split + 1)
            if lo > hi:
                feasible = False
                break
            d_before, d_after = sections[i][2], sections[i + 1][2]
            # choose split s in [lo, hi] minimising local mismatches
            g_before = gwin(lo, hi, d_before)
            g_after = gwin(lo, hi, d_after)
            seg = oriented[lo:hi]
            mm_b = (seg != g_before[: len(seg)]).astype(np.int32)
            mm_a = (seg != g_after[: len(seg)]).astype(np.int32)
            # cost(s) = before-mism in [lo, s) + after-mism in [s, hi)
            pref = np.concatenate(([0], np.cumsum(mm_b)))
            suff = np.concatenate((np.cumsum(mm_a[::-1])[::-1], [0]))
            s_local = int(np.argmin(pref + suff))
            splits.append((lo + s_local, d_after - d_before))
            prev_split = lo + s_local
        if not feasible or not splits:
            continue
        # assemble CIGAR (M segments between splits; D consumes genome,
        # I consumes read) and recount mismatches over the M segments
        cig = []
        nm = 0
        read_cursor = 0
        ok = True
        for s, d in splits + [(L, 0)]:
            seg_len = s - read_cursor
            if seg_len <= 0:
                ok = False
                break
            cig.append((seg_len, "M"))
            read_cursor += seg_len
            if d > 0:
                cig.append((d, "D"))
                nm += d
            elif d < 0:
                ins = min(-d, L - read_cursor)
                if ins <= 0:
                    ok = False
                    break
                cig.append((ins, "I"))
                nm += ins
                read_cursor += ins
        if not ok or read_cursor != L:
            continue
        mism = 0
        read_cursor = 0
        gpos = p0
        for n_, op in cig:
            if op == "M":
                g = _genome_codes(genome, gpos, n_)
                mism += int(
                    (oriented[read_cursor : read_cursor + n_] != g[:n_]).sum()
                )
                read_cursor += n_
                gpos += n_
            elif op == "D":
                gpos += n_
            elif op == "I":
                read_cursor += n_
        if mism > max_mismatches:
            continue
        was_mapped = bool(res["mapped"][r])
        if was_mapped and mism + len(splits) >= int(res["mism"][r]) + (
            1 if int(res["indel"][r]) else 0
        ):
            continue  # single-indel explanation is as good — keep it
        cigar = "".join(f"{n_}{op}" for n_, op in cig)
        out[int(r)] = (cigar, mism, mism + nm)
    return out


def _probe_offsets_host(L: int, params: VoteParams) -> np.ndarray:
    """Host mirror of ops.vote.static_offsets for one read length
    (includes the >160bp applied-subread ladder)."""
    return static_offsets(L, params).astype(np.int64)


def _genome_codes(genome: Genome, start: int, n: int) -> np.ndarray:
    start = max(int(start), 0)
    return genome.codes[start : start + n]

