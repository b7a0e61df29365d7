"""Copy of `subread_tpu/align/longread.py`: the port imports nothing of the JAX package.

`map_long_reads_sharded`, the mesh path, runs over the port's
`parallel.mesh.sharded_align_step` on torch devices instead of a JAX mesh.
Departures that leave every hit and record as the original's:
`window_batch` builds the window batch from the reads' codes (the original
decodes each window to text and parses it back); `sublong_file` takes
`reader=` as `Aligner.align_file` does and otherwise reads through the
port's `FastqReader` (the original parses the file itself); chaining runs
in three steps, for a whole chunk at once (`chain_reads`; `chain_read` is
its one-read case): each read's winning chain is chosen first
(`_select_chain`: the winner depends on its windows and votes, never on its
CIGAR, so only the winner's CIGAR is built) and planned (`_plan_cigar`:
the coarse blocks and the stretches to refine, which depend on the chain
alone), then every stretch of the chunk is refined in one batched call
(`ops.banded_dp.refine`: the CUDA kernel on a card, its plain PyTorch
version on the CPU, each giving `banded_align`'s operations op for op;
`banded_align` itself stays as the numpy oracle), then each CIGAR is
assembled (`_assemble_cigar`) as the original's `_chain_to_cigar` merges
and balances it; and the steps report `timing` spans and counters:

  * `sublong.read`: a reader call, bytes to codes;
  * `sublong.windows`: cutting a chunk's reads into windows (`window_batch`);
  * `sublong.align`: `align_batch` on the windows (`submit`, `collect`);
  * `sublong.chain`: chaining the chunk's reads, with one child
    `sublong.dp` for the chunk's batched refinement (pack, upload, the
    launch, download, decode: the span waits for the card, since the
    assembly needs the operations);
  * `sublong.emit`: building and writing the records, the BAM's close
    included (`bgzf.deflate`);

and, per chunk while a profiler records, the counters `sublong.windows`
(windows voted) and `sublong.bases` (read bases), and per refinement call
`sublong.dp_cells` (the band cells of its stretches, as `banded_align`
would fill them) and `sublong.dp_jobs` (the stretches it refines).

sublong: long-read mapping by windowed voting + chain consensus.

Reference: longread-one/ (~6 kLoC standalone LRM copies) — subread voting
over many subreads followed by *chaining* of vote clusters along the read
(longread-mapping.c:529-660), indel/junction events between chained
anchors (LRMchro-event.c), reads up to 1.2 Mbp (LRMconfig.h:25).

TPU formulation: a long read is a batch of fixed 100bp windows (the
sequence axis becomes the batch axis — the reference's chaining loop is
replaced by one more round of *voting*, this time over window diagonals):

  1. windows of MANY reads are mapped in one device batch;
  2. every window candidate contributes a diagonal d = pos - 100·w;
  3. per read, diagonals are clustered with a tolerance (the chain = the
     diagonal cluster with the most distinct windows — seed-and-vote one
     level up);
  4. within the winning chain, genome-vs-read distance deltas between
     consecutive chained windows become D/I CIGAR events (N when the
     deletion is intron-sized) — the LRMchro-event analog;
  5. unchained head/tail windows become soft clips.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna, timing
from ..io import sam as samio
from ..io.fastq import FastqReader, ReadBatch

WINDOW = 100
CHAIN_TOL = 800    # diagonal tolerance: indel drift allowed along the read
MIN_INTRON = 50    # deletions at least this long are written as N (intron)


@dataclass
class LongReadHit:
    mapped: bool
    pos: int = 0          # linear genome position of the chained read start
    strand: int = 0
    clip_left: int = 0
    clip_right: int = 0
    cigar_ops: list = field(default_factory=list)  # [(n, op)] between clips
    span: int = 0         # genome bases covered
    n_windows: int = 0
    votes: int = 0


def banded_align(read_seg: np.ndarray, gen_seg: np.ndarray,
                 extra_band: int = 24) -> list[tuple[int, str]]:
    """Banded global alignment of a read segment against its genome
    segment, unit costs (match 0 / mismatch 1 / gap 1) — the
    between-anchor refinement of the reference long-read mapper
    (longread-one/longread-mapping.c:529-660 runs the same job with its
    banded iterative extension).  Returns merged CIGAR ops covering the
    whole read_seg.  numpy row-rolling DP: O(n * band) cells."""
    n, m = len(read_seg), len(gen_seg)
    if n == 0:
        return [(m, "D")] if m else []
    if m == 0:
        return [(n, "I")]
    band = abs(n - m) + extra_band
    BIG = 1 << 20
    # dp[j] over genome positions for current read row; parent ops tracked
    prev = np.arange(m + 1, dtype=np.int32)            # row 0: j deletions
    ops_tbl = np.zeros((n + 1, m + 1), np.int8)        # 0 diag 1 up(I) 2 left(D)
    ops_tbl[0, 1:] = 2
    for i in range(1, n + 1):
        lo = max(1, i - band)
        hi = min(m, i + band)
        cur = np.full(m + 1, BIG, np.int32)
        if i - 1 <= band:
            cur[0] = i
            ops_tbl[i, 0] = 1
        seg = gen_seg[lo - 1 : hi]
        sub = prev[lo - 1 : hi] + (seg != read_seg[i - 1])
        up = prev[lo : hi + 1] + 1                     # insertion (read base)
        best = np.minimum(sub, up)
        op = np.where(sub <= up, 0, 1).astype(np.int8)
        # left (deletion) needs a serial scan: cur[j-1] + 1
        run = best.copy()
        for k in range(1, len(run)):
            c = run[k - 1] + 1
            if c < run[k]:
                run[k] = c
                op[k] = 2
        cur[lo : hi + 1] = run
        ops_tbl[i, lo : hi + 1] = op
        prev = cur
    # backtrack
    i, j = n, m
    rev: list[str] = []
    while i > 0 or j > 0:
        o = ops_tbl[i, j]
        if i > 0 and j > 0 and o == 0:
            rev.append("M")
            i -= 1
            j -= 1
        elif i > 0 and (o == 1 or j == 0):
            rev.append("I")
            i -= 1
        else:
            rev.append("D")
            j -= 1
    out: list[tuple[int, str]] = []
    for op in reversed(rev):
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + 1, op)
        else:
            out.append((1, op))
    return out


def _refine(jobs: list, device) -> list:
    """Each job's banded_align operations, all jobs in one `ops.banded_dp`
    call on device (the CUDA kernel on a card, its plain version on the
    CPU), in a sublong.dp span that waits for the card; while a profiler
    records, their band cells are counted as sublong.dp_cells and the jobs
    as sublong.dp_jobs.  jobs: (read codes, genome codes, extra band)."""
    if not jobs:
        return []
    from ..ops import banded_dp

    with timing.span("sublong.dp"):
        ops = banded_dp.refine(jobs, device)
    if timing.recording():
        n = np.asarray([len(r) for r, _, _ in jobs], np.int64)
        m = np.asarray([len(g) for _, g, _ in jobs], np.int64)
        extra = np.asarray([e for _, _, e in jobs], np.int64)
        timing.count("sublong.dp_cells",
                     int(banded_dp.band_cells(n, m, np.abs(n - m) + extra).sum()))
        timing.count("sublong.dp_jobs", len(jobs))
    return ops


def _plan_cigar(wins: np.ndarray, gpos: np.ndarray, L: int, strand: int,
                oriented: np.ndarray | None, gcodes: np.ndarray | None,
                jobs: list, max_refine: int = 4000):
    """The CIGAR plan of one chained window set: its pieces in SAM (genome)
    orientation, each an (n, op) or the index in jobs of a stretch to
    refine, appended there as (read codes, genome codes, extra band).

    wins: window indices (fwd-read numbering), gpos: genome start of each
    window's 100bp block.  For strand 1 the blocks are emitted in genome
    order (reversed window order) since the SAM record holds the rc read.
    With `oriented` (read codes in genome orientation) and `gcodes`
    (genome 2-bit codes, linear coords) the inter-anchor gaps get
    base-accurate banded-DP ops instead of coarse min(dr,dg)M+diff
    blocks — the reference's between-anchor iterative refinement
    (longread-one/longread-mapping.c:529-660).  Whether a stretch is
    refined depends on the chain alone, never on an earlier stretch's
    operations, so a chunk's stretches are all known before any DP runs.
    Returns (pieces, w, g) with w and g in genome order."""
    order = np.argsort(gpos)
    w = wins[order]
    g = gpos[order]
    n = len(w)
    # oriented-read start of block w (ascending along the genome order)
    ostart = (
        (lambda wi: wi * WINDOW) if strand == 0
        else (lambda wi: L - (wi + 1) * WINDOW)
    )

    def refine(o_lo, o_hi, g_lo, g_hi):
        ops.pop()          # the coarse body block being replaced
        ops.append(len(jobs))
        jobs.append((oriented[o_lo:o_hi], gcodes[g_lo:g_hi], 40))
        ops.append((WINDOW, "M"))

    ops: list = [(WINDOW, "M")]
    for i in range(1, n):
        # read distance between consecutive blocks, in genome orientation
        dw = abs(int(w[i]) - int(w[i - 1])) - 1
        dr = dw * WINDOW
        dg = int(g[i]) - (int(g[i - 1]) + WINDOW)
        if dg < 0:
            # overlapping blocks (repeat artefact): the segment consumes
            # WINDOW+dr read bases but only WINDOW+dg of genome — emit the
            # difference as I so downstream ops stay read-aligned (a bare
            # short M here desynchronised every later block)
            if (
                oriented is not None and gcodes is not None
                and dr <= max_refine
            ):
                o_lo = ostart(int(w[i - 1]))
                o_hi = ostart(int(w[i]))
                g_lo = int(g[i - 1])
                g_hi = int(g[i])
                if (
                    0 <= o_lo < o_hi <= len(oriented)
                    and 0 <= g_lo < g_hi <= len(gcodes)
                    and ops and ops[-1] == (WINDOW, "M")
                ):
                    refine(o_lo, o_hi, g_lo, g_hi)
                    continue
            gm = max(WINDOW + dg, 1)
            rm = WINDOW + dr
            ops.append((gm, "M"))
            if rm > gm:
                ops.append((rm - gm, "I"))
            continue
        # the N (skip) classification only fits a near-pure genome gap:
        # when the gap also holds read bases (unmapped windows over an
        # ONT-noise stretch) it is an alignment problem, not an intron
        intronic = dg - dr >= MIN_INTRON and dr <= 8
        need_refine = max(dr, dg) > 0
        if (
            oriented is not None and gcodes is not None and not intronic
            and not need_refine
        ):
            # equal-length segment: vote anchors are only +-tolerance
            # accurate, so probe the coarse placement and banded-refine
            # when it mismatches badly (indel-rich window bodies)
            o_lo_p = ostart(int(w[i - 1]))
            o_hi_p = ostart(int(w[i]))
            g_lo_p = int(g[i - 1])
            g_hi_p = int(g[i])
            if (
                0 <= o_lo_p < o_hi_p <= len(oriented)
                and g_hi_p <= len(gcodes)
                and o_hi_p - o_lo_p == g_hi_p - g_lo_p
            ):
                seg_mm = int(
                    (oriented[o_lo_p:o_hi_p] != gcodes[g_lo_p:g_hi_p]).sum()
                )
                need_refine = seg_mm > 0.08 * (o_hi_p - o_lo_p)
        if (
            oriented is not None and gcodes is not None and not intronic
            and need_refine and dr <= max_refine and dg <= max_refine
        ):
            # refine the COMBINED previous-window-body + gap stretch: with
            # indel-rich reads (ONT) the drift sits INSIDE window bodies,
            # not just between them, so the banded DP must span from the
            # previous anchor to this one (the reference's iterative
            # between-anchor extension covers the same stretch)
            o_lo = ostart(int(w[i - 1]))
            o_hi = ostart(int(w[i]))
            g_lo = int(g[i - 1])
            g_hi = int(g[i])
            if (
                0 <= o_lo < o_hi <= len(oriented) and g_hi <= len(gcodes)
                and ops and ops[-1] == (WINDOW, "M")
            ):
                refine(o_lo, o_hi, g_lo, g_hi)
                continue
        m = min(dr, dg)
        if m:
            ops.append((m, "M"))
        if dg > dr:
            ops.append((dg - dr, "N" if dg - dr >= MIN_INTRON else "D"))
        elif dr > dg:
            ops.append((dr - dg, "I"))
        ops.append((WINDOW, "M"))
    return ops, w, g


def _assemble_cigar(plan, L: int, strand: int, seg_ops: list):
    """The CIGAR of a `_plan_cigar` plan, each refined stretch's
    operations (seg_ops, by job) spliced in: adjacent equal operations
    merged, the clips, and the read bases balanced.  Returns (clip_left,
    ops, clip_right, genome_pos) in SAM (genome) orientation."""
    pieces, w, g = plan
    # merge adjacent Ms
    merged: list[tuple[int, str]] = []
    for piece in pieces:
        for nn, op in (seg_ops[piece] if isinstance(piece, int) else (piece,)):
            if merged and merged[-1][1] == op:
                merged[-1] = (merged[-1][0] + nn, op)
            else:
                merged.append((nn, op))
    wmin, wmax = int(w.min()), int(w.max())
    if strand == 0:
        clip_l = wmin * WINDOW
        clip_r = max(L - (wmax + 1) * WINDOW, 0)
    else:
        # rc record: the read tail maps at the smallest genome coordinate
        clip_l = max(L - (wmax + 1) * WINDOW, 0)
        clip_r = wmin * WINDOW
    # read bases consumed by ops must equal L - clips: pad the last M for
    # the read tail that falls inside the final partial window
    consumed = sum(nn for nn, op in merged if op in "MI")
    want = L - clip_l - clip_r
    if want > consumed:
        # extend the tail-side M into the partial window
        if merged[-1][1] == "M":
            merged[-1] = (merged[-1][0] + (want - consumed), "M")
        else:
            merged.append((want - consumed, "M"))
    elif want < consumed:
        # trim read-consuming ops from the tail until balanced (refined
        # segments can overshoot when an overlap merge follows them)
        excess = consumed - want
        out = []
        for nn, op in reversed(merged):
            if excess > 0 and op in "MI":
                t = min(nn, excess)
                excess -= t
                nn -= t
            if nn > 0:
                out.append((nn, op))
        merged = list(reversed(out))
        while merged and merged[-1][1] in "DN":
            merged.pop()
    return clip_l, merged, clip_r, int(g[0])


def _select_chain(res: dict, rows: np.ndarray, wins: np.ndarray,
                  min_windows: int):
    """The winning diagonal cluster of one read's mapped windows (batch
    rows `rows`, window ids `wins`): (strand, its windows' ids, their
    genome positions, n_windows, votes), or None.  The winner depends on
    n_windows (after the drift filter) and the votes alone, never on the
    CIGAR, so only the winner's CIGAR is built."""
    best = None
    mapped = np.asarray(res["mapped"], bool)[rows]
    if not mapped.any():
        return best
    pos = res["pos"].astype(np.int64)[rows]
    # window pos is soft-clip-advanced; chaining and the banded
    # refinement anchor on the genome position of read offset w*WINDOW,
    # so undo the clip advance (the DP re-places any head noise itself)
    if "clip_l" in res:
        pos = pos - np.asarray(res["clip_l"], np.int64)[rows]
    strand = np.asarray(res["strand"])[rows]
    votes = np.asarray(res["votes"])[rows]
    for st in (0, 1):
        sel = mapped & (strand == st)
        if not sel.any():
            continue
        w = wins[sel]
        p = pos[sel]
        v = votes[sel]
        d = p - w * WINDOW if st == 0 else p + w * WINDOW
        order = np.argsort(d)
        darr, warr, parr, varr = d[order], w[order], p[order], v[order]
        i, n = 0, len(darr)
        while i < n:
            j = i
            while j < n and darr[j] - darr[i] <= CHAIN_TOL:
                j += 1
            members = np.arange(i, j)
            # one block per distinct window (best-vote member wins)
            uw = {}
            for m in members:
                k = int(warr[m])
                if k not in uw or varr[m] > varr[uw[k]]:
                    uw[k] = m
            n_windows = len(uw)
            vsum = int(varr[members].sum())
            if n_windows >= min_windows and (
                best is None or n_windows > best[3]
                or (n_windows == best[3] and vsum > best[4])
            ):
                midx = np.asarray(sorted(uw.values()))
                # local drift consistency: ONT-style indel drift moves the
                # window diagonal slowly (tens of bases per kb), while a
                # tandem-repeat wrong-copy hit jumps by the repeat period.
                # Windows whose diagonal deviates >60 from the running
                # median of their neighbours are dropped before the
                # banded refinement anchors on them.
                if len(midx) >= 5:
                    dd = darr[midx]
                    med = np.empty(len(dd))
                    for q in range(len(dd)):
                        lo_q = max(0, q - 3)
                        med[q] = np.median(dd[lo_q : q + 4])
                    keep = np.abs(dd - med) <= 60
                    if keep.sum() >= min_windows:
                        midx = midx[keep]
                        n_windows = len(midx)
                best = (st, warr[midx], parr[midx], n_windows, vsum)
            i = j
    return best


def _plan_read(res: dict, rows: np.ndarray, wins: np.ndarray, L: int,
               min_windows: int, codes, gcodes, jobs: list):
    """One read's chain and CIGAR plan (its stretches to refine appended
    to jobs): (strand, plan, n_windows, votes), or None."""
    sel = _select_chain(res, rows, wins, min_windows)
    if sel is None:
        return None
    st, w, p, n_windows, vsum = sel
    oriented = None
    if codes is not None:
        oriented = codes if st == 0 else dna.revcomp(codes)
    return st, _plan_cigar(w, p, L, st, oriented, gcodes, jobs), n_windows, vsum


def _assemble_read(planned, L: int, seg_ops: list) -> LongReadHit:
    """The hit of a `_plan_read` result, the refined stretches' operations
    spliced in."""
    if planned is None:
        return LongReadHit(mapped=False)
    st, plan, n_windows, vsum = planned
    cl, ops, cr, gpos0 = _assemble_cigar(plan, L, st, seg_ops)
    span = sum(nn for nn, op in ops if op in "MDN")
    return LongReadHit(
        mapped=True, pos=gpos0, strand=st,
        clip_left=cl, clip_right=cr, cigar_ops=ops,
        span=span, n_windows=n_windows, votes=vsum,
    )


def chain_reads(res: dict, spans: list, reads: list, min_windows: int,
                gcodes: np.ndarray | None = None, device="cpu") -> list:
    """Chain many reads' mapped windows: plan every read, refine all their
    stretches in one batched call on device, then assemble each hit.
    spans: each read's (batch rows, window ids); reads: each read's codes;
    without gcodes the gaps keep their coarse blocks."""
    jobs: list = []
    plans = [
        _plan_read(res, rows, wins, len(codes), min_windows,
                   codes if gcodes is not None else None, gcodes, jobs)
        for (rows, wins), codes in zip(spans, reads)
    ]
    seg_ops = _refine(jobs, device)
    return [_assemble_read(p, len(c), seg_ops) for p, c in zip(plans, reads)]


def chain_read(
    res: dict, rows: np.ndarray, wins: np.ndarray, L: int, min_windows: int,
    codes: np.ndarray | None = None, gcodes: np.ndarray | None = None,
) -> LongReadHit:
    """Chain the mapped windows (batch rows `rows`, window ids `wins`) of
    one read into the best diagonal cluster.  With codes/gcodes the
    inter-anchor gaps are refined by banded DP (see _plan_cigar) on the
    CPU: `chain_reads`' steps for one read."""
    jobs: list = []
    planned = _plan_read(res, rows, wins, L, min_windows,
                         codes if gcodes is not None else None, gcodes, jobs)
    return _assemble_read(planned, L, _refine(jobs, "cpu"))


def map_long_read(aligner, seq_codes: np.ndarray, min_windows: int = 2) -> LongReadHit:
    """Map one long read (uint8 codes) with the window/chain scheme."""
    hits = map_long_reads(aligner, [seq_codes], min_windows=min_windows)
    return hits[0]


def window_batch(reads: list[np.ndarray], pad_to: int | None):
    """The WINDOW-base windows of reads (uint8 codes) as one ReadBatch, from
    the codes: read r gives max(len // WINDOW, 1) rows named r{r}w{w}, each
    WINDOW bases (the read itself when shorter), 'I' qualities, no N; the
    width is at least pad_to.  Returns (batch, owner, winid), each row's
    read and window index."""
    n_win = np.asarray([max(len(c) // WINDOW, 1) for c in reads], np.int64)
    owner = np.repeat(np.arange(len(reads)), n_win)
    winid = np.arange(int(n_win.sum())) - np.repeat(np.cumsum(n_win) - n_win, n_win)
    lens = np.asarray([min(len(c), WINDOW) for c in reads], np.int32)[owner]
    width = max(int(lens.max()) if len(lens) else 0, pad_to or 0)
    codes = np.zeros((len(owner), width), np.uint8)
    row = 0
    for c, k in zip(reads, n_win.tolist()):
        if len(c) >= WINDOW:
            codes[row: row + k, :WINDOW] = c[: k * WINDOW].reshape(k, WINDOW)
        else:
            codes[row, : len(c)] = c
        row += k
    quals = np.where(np.arange(width)[None, :] < lens[:, None], np.uint8(ord("I")),
                     np.uint8(0))
    names = [f"r{r}w{w}" for r, w in zip(owner.tolist(), winid.tolist())]
    return (ReadBatch(names=names, codes=codes, lengths=lens, quals=quals,
                      ambig=np.zeros(codes.shape, bool)), owner, winid)


def map_long_reads(
    aligner, reads: list[np.ndarray], min_windows: int = 2
) -> list[LongReadHit]:
    """Map many long reads in one device batch of 100bp windows."""
    with timing.span("sublong.windows"):
        batch, owner, winid = window_batch(reads, aligner.cfg.pad_read_len)
    with timing.span("sublong.align"):
        res = aligner.align_batch(batch)
    with timing.span("sublong.chain"):
        ends = np.cumsum(np.bincount(owner, minlength=len(reads)))
        spans = []
        for r in range(len(reads)):
            rows = np.arange(ends[r - 1] if r else 0, ends[r])
            spans.append((rows, winid[rows]))
        return chain_reads(res, spans, reads, min_windows,
                           gcodes=aligner.genome.codes, device=aligner.device)


def map_long_reads_sharded(
    aligner, reads: list[np.ndarray], mesh, min_windows: int = 2
) -> list[LongReadHit]:
    """Sequence-parallel long-read mapping over a device mesh.

    The mesh answer to the reference's 1.2Mbp single-thread chaining loop
    (longread-mapping.c:529-660) and SURVEY §5's long-context scaling item:
    a long read's fixed 100bp windows ARE batch rows here, so sharding the
    reads axis of the window batch across the mesh splits ONE extreme read
    across all devices (window voting is embarrassingly parallel; only the
    host-side diagonal chaining sees the whole read).  No ring pass is
    needed because chaining consumes only (pos, strand, votes) per window —
    a few bytes, fetched once — not the window activations.
    """
    from .pipeline import _host
    from ..parallel.mesh import sharded_align_step

    batch, owner, winid = window_batch(reads, aligner.cfg.pad_read_len)
    n = len(batch)
    S = mesh.devices.size
    n_pad = -(-n // S) * S
    codes_p = np.zeros((n_pad, batch.max_len), np.uint8)
    ambig_p = np.zeros((n_pad, batch.max_len), bool)
    lens_p = np.zeros(n_pad, np.int32)
    codes_p[:n] = batch.codes
    ambig_p[:n] = batch.ambig
    lens_p[:n] = batch.lengths
    step = sharded_align_step(mesh, aligner)
    res_dev = step(codes_p, ambig_p, lens_p)
    # every key on the host in the JAX package's dtypes; rescue below
    # writes records in place
    res = {k: _host(k, v)[:n].copy() for k, v in res_dev.items()}
    # same wide-gather re-vote the single-chip align_batch applies to
    # saturated repeat windows — keeps mesh results bit-identical to it
    aligner._rescue_saturated(batch, res)
    spans = [(np.flatnonzero(owner == r), winid[np.flatnonzero(owner == r)])
             for r in range(len(reads))]
    return chain_reads(res, spans, reads, min_windows,
                       gcodes=aligner.genome.codes, device=aligner.device)


# reads a reader call hands over: about half a chunk's windows at Nanopore
# lengths, so a reader that ends the input at a deadline stops within one
READ_BATCH = 8


def sublong_file(aligner, fastq_path: str, out_sam: str, min_windows: int = 2,
                 sam_output: bool = False, reader=None):
    """Map a long-read FASTQ (plain or gzip), or the reads reader hands over
    (`next_batch(max_reads)`, as `Aligner.align_file` takes it), writing
    one primary record per read in input order; returns (mapped, total).
    Reads are mapped a chunk at a time, once the chunk holds
    max(batch_reads, 256) windows."""
    g = aligner.genome
    reader = reader if reader is not None else FastqReader(fastq_path)
    writer = samio.make_writer(
        out_sam, g.names, [int(x) for x in g.lengths],
        sam_output=sam_output or out_sam.endswith(".sam"),
    )
    mapped = total = 0
    # chunk reads so one device batch holds ~batch_reads windows
    per_chunk_windows = max(aligner.cfg.batch_reads, 256)
    pend_names, pend_codes, pend_quals = [], [], []
    pend_win = chunk = 0

    def flush():
        nonlocal mapped, pend_win, chunk
        if not pend_codes:
            return
        if timing.recording():
            timing.count("sublong.windows", pend_win)
            timing.count("sublong.bases", sum(len(c) for c in pend_codes))
        hits = map_long_reads(aligner, pend_codes, min_windows=min_windows)
        with timing.span("sublong.emit"):
            for name, codes, qual_s, hit in zip(
                pend_names, pend_codes, pend_quals, hits
            ):
                mapped += _write_long_record(writer, g, name, codes, qual_s, hit)
        pend_names.clear()
        pend_codes.clear()
        pend_quals.clear()
        pend_win = 0
        chunk += 1
        timing.set_chunk(chunk)

    try:
        timing.set_chunk(chunk)
        while True:
            with timing.span("sublong.read"):
                batch = reader.next_batch(READ_BATCH)
            if batch is None:
                break
            for i, name in enumerate(batch.names):
                n = int(batch.lengths[i])
                total += 1
                pend_names.append(name)
                pend_codes.append(batch.codes[i, :n])
                pend_quals.append(batch.quals[i, :n].tobytes().decode())
                pend_win += max(n // WINDOW, 1)
                if pend_win >= per_chunk_windows:
                    flush()
        flush()
    finally:
        reader.close()
        with timing.span("sublong.emit"):
            writer.close()
        timing.set_chunk(-1)
    return mapped, total


def _write_long_record(writer, g, name: str, codes: np.ndarray, qual_s: str,
                       hit: LongReadHit) -> bool:
    """Write one read's primary record; returns whether it is mapped."""
    seq_s = dna.decode(codes)
    if not hit.mapped:
        writer.write(
            samio.SamRecord(name, samio.FLAG_UNMAPPED, "*", 0, 0, "*",
                            seq=seq_s, qual=qual_s)
        )
        return False
    cidx, coff = g.linear_to_chro(np.asarray([hit.pos]))
    if hit.strand:
        seq_s = dna.decode(dna.revcomp(codes))
        qual_s = qual_s[::-1]
    cigar = ""
    if hit.clip_left:
        cigar += f"{hit.clip_left}S"
    cigar += "".join(f"{n}{op}" for n, op in hit.cigar_ops)
    if hit.clip_right:
        cigar += f"{hit.clip_right}S"
    flag = samio.FLAG_REVERSE if hit.strand else 0
    writer.write(
        samio.SamRecord(
            name, flag, g.names[int(cidx[0])], int(coff[0]) + 1,
            40 if hit.n_windows > 2 else 20, cigar,
            seq=seq_s, qual=qual_s,
            tags=[f"NW:i:{hit.n_windows}"],
        )
    )
    return True
