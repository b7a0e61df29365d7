"""banded_dp: sublong's between-anchor banded alignment for a whole chunk's
segments at once, as a CUDA kernel and its plain PyTorch version.

Each segment is a read stretch against its genome stretch, refined exactly
as `align.longread.banded_align` refines it (unit costs, a band of
|n - m| + extra columns on each side of the diagonal, its tie rules and its
backtrack): the same operations, op for op.  `refine` packs the segments on
the host, moves them to the device in one copy, runs the DP and the
backtrack there, brings back each segment's run-length operations in one
copy and returns them as `[(n, op)]` lists.  The CUDA source is
`csrc/banded_dp.cu`; its note says what bounds it and how it is laid out.

Layout shared by both versions.  A packed batch is one byte buffer: the
segment table (int64 [S, 7], columns `COLS`), then the read stretches, then
the genome stretches (uint8 codes, concatenated).  Row i of a segment (read
base i, 1..n) holds its band's columns max(1, i - band)..min(m, i + band);
the traceback table keeps one byte a band cell (0 diagonal, 1 up = I,
2 left = D), segment after segment and row after row, so a segment's rows
take `band_cells` bytes from its `cell` offset.  The result is int32
[S + slots]: each segment's run count, then each segment's slot of n + m
words, whose last `count` words are its runs in order, (length << 2) | op
with op 0 M, 1 I, 2 D.  The table's first `n_wide` segments need a block of
the kernel (a band row wider than `NARROW` columns), the rest a warp.

`banded_dp` takes the plain version only for tensors on the CPU.  For
tensors on a card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda_build import load

SOURCES = ["banded_dp.cu"]
COLS = ("read", "gen", "n", "m", "band", "cell", "slot")
NARROW = 256      # band columns a warp covers: 32 lanes x 8 cells
WIDE = 8192       # band columns a block covers: 512 threads x 16 cells
BIG = 1 << 20     # banded_align's out-of-band value
OPS = "MID"

_c = ctypes


def _lib() -> ctypes.CDLL:
    return load("banded_dp", SOURCES)


def band_cells(n, m, band) -> np.ndarray:
    """The band cells of segments of n read bases against m genome bases
    (int64 arrays), rows 1..n each from max(1, i - band) to min(m, i + band),
    in closed form; 0 where n or m is 0.  Needs band >= |n - m|, so that no
    row is empty."""
    n, m, b = (np.asarray(x, np.int64) for x in (n, m, band))
    a = np.clip(m - b, 0, n)                 # rows whose band ends before m
    upper = a * (a + 1) // 2 + a * b + (n - a) * m
    c = np.minimum(n, b + 1)                 # rows whose band starts at 1
    lower = c + (n * (n + 1) // 2 - c * (c + 1) // 2) - (n - c) * b
    return np.where((n > 0) & (m > 0), upper - lower + n, 0)


def pack(segments) -> tuple[np.ndarray, np.ndarray, int, int, int]:
    """segments: (read codes, genome codes, extra band) each, uint8 arrays.
    Returns (the packed byte buffer, each table row's segment, n_wide, the
    cells and the slots of the batch).  Table rows: the wide segments, then
    the narrow ones, each by falling n, so the longest start first."""
    n = np.asarray([len(r) for r, _, _ in segments], np.int64)
    m = np.asarray([len(g) for _, g, _ in segments], np.int64)
    extra = np.asarray([e for _, _, e in segments], np.int64)
    if (extra < 0).any():
        raise ValueError("banded_dp: extra band must be >= 0")
    band = np.abs(n - m) + extra
    wide = np.minimum(m, 2 * band + 1) > NARROW
    order = np.lexsort((-n, ~wide))
    S = len(order)
    n, m, band = n[order], m[order], band[order]
    cells = band_cells(n, m, band)
    table = np.empty((S, len(COLS)), np.int64)
    table[:, 2], table[:, 3], table[:, 4] = n, m, band
    table[:, 0] = np.cumsum(n) - n
    table[:, 1] = np.cumsum(m) - m
    table[:, 5] = np.cumsum(cells) - cells
    table[:, 6] = np.cumsum(n + m) - (n + m)
    tb = table.view(np.uint8).reshape(-1)
    buf = np.empty(tb.size + int(n.sum()) + int(m.sum()), np.uint8)
    buf[: tb.size] = tb
    o = tb.size
    reads = [segments[k][0] for k in order.tolist()]
    gens = [segments[k][1] for k in order.tolist()]
    if reads:
        buf[o: o + int(n.sum())] = np.concatenate(reads)
        buf[o + int(n.sum()):] = np.concatenate(gens)
    return (buf, order, int(wide.sum()), int(cells.sum()),
            int((n + m).sum()))


def unpack(buf: torch.Tensor, S: int, n_total: int):
    """(table int64 [S, 7], reads, genome stretches) as views of a packed
    buffer (on any device); n_total is the reads' length."""
    tb = S * len(COLS) * 8
    table = buf[:tb].view(torch.int64).view(S, len(COLS))
    return table, buf[tb: tb + n_total], buf[tb + n_total:]


def decode(out: np.ndarray, table: np.ndarray) -> list[list[tuple[int, str]]]:
    """Each table row's operations, [(n, op)], from a result of banded_dp."""
    S = len(table)
    counts = out[:S].astype(np.int64)
    if (counts < 0).any():
        raise RuntimeError("banded_dp: a segment's band was wider than its team")
    ends = S + table[:, 6] + table[:, 2] + table[:, 3]
    first = np.cumsum(counts) - counts
    idx = np.arange(int(counts.sum())) + np.repeat(ends - counts - first, counts)
    v = out[idx]
    lens, ops = (v >> 2).tolist(), (v & 3).tolist()
    res, k = [], 0
    for c in counts.tolist():
        res.append([(lens[q], OPS[ops[q]]) for q in range(k, k + c)])
        k += c
    return res


def refine(segments, device) -> list[list[tuple[int, str]]]:
    """banded_align's operations for every (read codes, genome codes, extra
    band) of segments, computed on device: one packed upload, one banded_dp
    call, one download.  Waits for the card."""
    if not segments:
        return []
    device = torch.device(device)
    buf, order, n_wide, cells, slots = pack(segments)
    S = len(order)
    t = torch.from_numpy(buf)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    host_table = buf[: S * len(COLS) * 8].view(np.int64).reshape(S, len(COLS))
    table, reads, gens = unpack(t, S, int(host_table[:, 2].sum()))
    out = banded_dp(table, reads, gens, n_wide, cells, slots).cpu().numpy()
    ops = decode(out, host_table)
    res = [None] * S
    for row, k in enumerate(order.tolist()):
        res[k] = ops[row]
    return res


def _row_width(i, m, band):
    """Band columns of row i (tensors), 0 where m is 0."""
    lo = torch.clamp(i - band, min=1)
    return lo, torch.clamp(torch.minimum(m, i + band) - lo + 1, min=0)


def banded_dp_reference(table, reads, gens, n_wide: int, cells: int,
                        slots: int) -> torch.Tensor:
    """Plain PyTorch banded_dp (see `banded_dp` for the arguments).

    Every segment steps through its rows together with the others: row i
    is one ragged vector of the band cells of the segments with n >= i.
    The deletion run of a row, run[k] = min(best[k], run[k-1] + 1), is
    k + the inclusive prefix-min of best[k] - k, found with one cummin over
    the row after each segment is lowered by `seg * 2**22` below the one
    before, so no minimum crosses a segment; LEFT is taken only where
    strictly better, and never at the band's first column.  The backtrack
    steps every segment at once, one operation a step."""
    S = table.shape[0]
    out = torch.zeros(S + slots, dtype=torch.int32)
    if S == 0:
        return out
    ro, go, n, m, band, cbase, sbase = table.to(torch.int64).unbind(1)
    reads, gens = reads.to(torch.int64), gens.to(torch.int64)
    tbl = torch.zeros(max(cells, 1), dtype=torch.uint8)
    fill_n = torch.where(m > 0, n, 0)
    by = torch.argsort(fill_n, descending=True, stable=True)
    fn, fm, fb = fill_n[by], m[by], band[by]
    fro, fgo, fcb = ro[by], go[by], cbase[by]
    rowoff = torch.zeros(S, dtype=torch.int64)
    huge, inf = 1 << 22, 1 << 40
    prev = prev_start = lo_p = w_p = None
    for i in range(1, int(fn[0]) + 1):
        k = int((fn >= i).sum())            # the active segments lead
        B, M = fb[:k], fm[:k]
        lo, w = _row_width(i, M, B)
        seg = torch.repeat_interleave(torch.arange(k), w)
        start = torch.cumsum(w, 0) - w
        t = torch.arange(int(w.sum())) - start[seg]
        j = lo[seg] + t

        def prev_val(col):
            if i == 1:
                return col                   # row 0: j deletions
            idx = col - lo_p[seg]
            inb = (idx >= 0) & (idx < w_p[seg])
            got = prev[(prev_start[seg] + idx).clamp(0, max(len(prev) - 1, 0))]
            v = torch.where(inb, got, BIG)
            c0 = torch.where(i - 2 <= B[seg], i - 1, BIG)
            return torch.where(col == 0, c0, v)

        rb = reads[fro[:k] + i - 1][seg]
        sub = prev_val(j - 1) + (gens[fgo[seg] + j - 1] != rb)
        up = prev_val(j) + 1
        best = torch.minimum(sub, up)
        op = (sub > up).to(torch.uint8)
        x = best - t - seg * huge
        incl = torch.cummin(x, 0).values
        excl = torch.cat([torch.full((1,), inf), incl[:-1]]) + seg * huge
        left = excl + t
        take = (t > 0) & (left < best)
        val = torch.where(take, left, best)
        op = torch.where(take, 2, op).to(torch.uint8)
        tbl[fcb[seg] + rowoff[:k][seg] + t] = op
        rowoff[:k] += w
        prev, prev_start, lo_p, w_p = val, start, lo, w
    # backtrack, every segment a step at once; rowoff becomes P(i - 1)
    cur = torch.empty_like(rowoff)
    cur[by] = rowoff
    i, j = n.clone(), m.clone()
    rowoff = cur - torch.where(i > 0, _row_width(i, m, band)[1], 0)
    steps = []
    while True:
        live = (i > 0) | (j > 0)
        if not bool(live.any()):
            break
        lo = torch.clamp(i - band, min=1)
        o = tbl[(cbase + rowoff + j - lo).clamp(0, len(tbl) - 1)]
        o = torch.where(j == 0, 1, o)
        o = torch.where(i == 0, 2, o)
        o = torch.where(live, o, 3).to(torch.uint8)
        steps.append(o)
        di = (o == 0) | (o == 1)
        i = i - di.to(torch.int64)
        rowoff = torch.where(di & (i > 0), rowoff - _row_width(i, m, band)[1], rowoff)
        j = j - ((o == 0) | (o == 2)).to(torch.int64)
    # runs in forward order: the backtrack reversed, merged
    seq = torch.stack(steps, 1).flip(1) if steps else torch.empty((S, 0), dtype=torch.uint8)
    keep = seq != 3
    key = (torch.arange(S)[:, None] * 4 + seq.to(torch.int64))[keep]
    uk, cnt = torch.unique_consecutive(key, return_counts=True)
    rseg, rop = uk // 4, uk % 4
    counts = torch.bincount(rseg, minlength=S)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(uk)) - first[rseg]
    pos = S + sbase[rseg] + n[rseg] + m[rseg] - counts[rseg] + rank
    out[pos] = ((cnt << 2) | rop).to(torch.int32)
    out[:S] = counts.to(torch.int32)
    return out


def banded_dp(
    table: torch.Tensor,   # int64 [S, 7], columns COLS
    reads: torch.Tensor,   # uint8, the read stretches
    gens: torch.Tensor,    # uint8, the genome stretches
    n_wide: int,           # the table's leading rows that need a block
    cells: int,            # band cells of the batch (traceback bytes)
    slots: int,            # sum of n + m
) -> torch.Tensor:
    """int32 [S + slots]: run counts, then each segment's slot with its
    runs at the slot's end (see the module docstring)."""
    args = (table, reads, gens)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return banded_dp_reference(table, reads, gens, n_wide, cells, slots)
    if kinds != {"cuda"} or len({t.device for t in args}) != 1:
        raise ValueError(f"banded_dp: tensors on mixed devices {kinds}")
    S = table.shape[0]
    for t, dt in ((table, torch.int64), (reads, torch.uint8), (gens, torch.uint8)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"banded_dp: got {t.dtype} (contiguous="
                             f"{t.is_contiguous()}), need {dt}")
    if table.dim() != 2 or table.shape[1] != len(COLS) or not 0 <= n_wide <= S:
        raise ValueError(f"banded_dp: table {tuple(table.shape)}, n_wide {n_wide}")
    out = launch(_lib(), table, reads, gens, n_wide, cells, slots)
    banded_dp.launches += 1
    return out


banded_dp.launches = 0  # kernel launches since the last reset


def launch(lib: ctypes.CDLL, table, reads, gens, n_wide: int, cells: int,
           slots: int) -> torch.Tensor:
    """Run the C entry point banded_dp_launch of the loaded library lib on
    CUDA tensors that `banded_dp` has checked, on the current stream."""
    fn = lib.banded_dp_launch
    if fn.argtypes is None:
        fn.restype = _c.c_int
        fn.argtypes = [_c.c_void_p, _c.c_int, _c.c_int, _c.c_void_p,
                       _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p]
    S = table.shape[0]
    dev = table.device
    out = torch.empty(S + slots, dtype=torch.int32, device=dev)
    tbl = torch.empty(max(cells, 1), dtype=torch.uint8, device=dev)
    if S == 0:
        return out
    rc = fn(table.data_ptr(), S, n_wide, reads.data_ptr(), gens.data_ptr(),
            tbl.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_dp kernel launch failed: CUDA error {rc}")
    return out
