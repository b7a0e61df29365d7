"""Index sharding across devices: the space-parallel form of the
reference's index-block serialization, on torch devices.

Port of `subread_tpu/parallel/index_shard.py`; `split_index_shards` and
`stack_shards` are its numpy code, copied.

The reference handles an index bigger than RAM by loading position-range
blocks one at a time and re-voting every read per block, accumulating one
vote table (read_chunk_circles, core.c:3562-3613).  On a mesh the same
decomposition goes over devices instead of over time: the genome's
(key, position) entries are split into contiguous POSITION ranges, one
shard per column of the "index" mesh axis.  Position ranges keep every
vote cluster inside one shard, so the max-based partial-vote merge
(ops.vote.merge_vote_results) is exact; shards overlap by the contig
padding so reads straddling a cut vote fully in both neighbours.

Every shard is rebuilt with one shared bucket_bits (sized for the largest
shard) and padded to a common comb_rows row count, as in the JAX package.
Each cell of the ("reads" x "index") mesh votes its row's reads against
its column's shard; the S partial top-K VoteResults of a row are gathered
onto the row's first device and folded left to right with
merge_vote_results: the order of the single-device block loop in
align.pipeline.Aligner, so the result is bit-identical to it.  The rows
are then gathered in order onto the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.build import HashIndex, native_layout, revcomp_keys_np
from ..ops.vote import VoteParams, VoteResult, merge_vote_results, vote_batch
from .mesh import (Mesh, device_array, mesh_devices, row_blocks, tensor_on,
                   visible_cards)

READS_AXIS = "reads"
INDEX_AXIS = "index"


def make_mesh_2d(n_reads: int, n_index: int, devices=None) -> Mesh:
    """("reads" x "index") mesh over the first n_reads * n_index of
    `devices` (names or torch.devices, repeats allowed), by default the
    visible cards; fewer devices than that raises."""
    n = n_reads * n_index
    devs = visible_cards(n) if devices is None else mesh_devices(devices)
    if len(devs) < n:
        raise ValueError(f"a {n_reads} x {n_index} mesh needs {n} devices, "
                         f"{len(devs)} given")
    return Mesh(device_array(devs[:n], (n_reads, n_index)),
                (READS_AXIS, INDEX_AXIS))


def split_index_shards(
    idx: HashIndex, n_shards: int, overlap: int | None = None
) -> list[HashIndex]:
    """Split an index into exactly n_shards position-range shards that all
    share one bucket_bits (the spatial analog of
    index.build.split_index_blocks)."""
    if n_shards <= 1:
        return [idx]
    n = idx.n_items
    overlap = idx.padding if overlap is None else overlap
    order = np.argsort(idx.positions, kind="stable")
    pos_sorted = idx.positions[order]
    genome_keys = np.where(idx.orient, revcomp_keys_np(idx.keys), idx.keys)
    per = -(-n // n_shards)
    # shared bucket space sized for the largest shard (per + overlap slack)
    bits = min(28, max(10, int(np.ceil(np.log2(max(per * 2, 2)))) + 2))
    shards = []
    for b in range(n_shards):
        lo, hi = b * per, min((b + 1) * per, n)
        if lo >= n:  # degenerate tiny index: empty trailing shard
            sel = np.zeros(n, bool)
        else:
            cut_lo = int(pos_sorted[lo])
            cut_hi = int(pos_sorted[hi - 1])
            sel = (idx.positions >= max(cut_lo - (overlap if b else 0), 0)) & (
                idx.positions <= cut_hi + (overlap if hi < n else 0)
            )
        shards.append(
            native_layout(
                genome_keys[sel], idx.positions[sel], idx.index_gap,
                idx.padding, bucket_bits=bits,
            )
        )
    return shards


def stack_shards(
    shards: list[HashIndex],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Stack shard arrays for device placement along the "index" axis:
    (bucket_start [S, B+1] int32, comb_rows [S, G, 24] uint32,
    sub_base [S, B] int32, sub_lo [S, M] int32, bucket_bits, sub_bits).
    comb_rows are padded to the largest shard's row count (padding rows are
    unreachable: bucket_start never points past a shard's own entries).
    Sub-bucket directories are rebuilt at one shared sub_bits (the max over
    shards — raising sub_bits keeps the run-start guarantee)."""
    bits = shards[0].bucket_bits
    assert all(s.bucket_bits == bits for s in shards)
    G = max(s.comb_rows.shape[0] for s in shards)
    bs = np.stack([s.bucket_start for s in shards])
    cb = np.stack(
        [
            np.pad(s.comb_rows, ((0, G - s.comb_rows.shape[0]), (0, 0)))
            for s in shards
        ]
    )
    from ..index.build import build_sub_directory

    dirs = [s.sub_dir for s in shards]
    sub_bits = max(d[2] for d in dirs)
    dirs = [
        d if d[2] == sub_bits or d[2] == 0
        else build_sub_directory(s.keys, s.orient, s.bucket_start, bits, force_bits=sub_bits)
        for s, d in zip(shards, dirs)
    ]
    M = max(len(d[1]) for d in dirs)
    sb = np.stack([d[0] for d in dirs])
    sl = np.stack([np.pad(d[1], (0, M - len(d[1]))) for d in dirs])
    assert all(d[3] == 0 for d in dirs)
    return bs, cb, sb, sl, bits, sub_bits


def place_sharded_index(mesh: Mesh, bs, cb, sb, sl):
    """Put the stacked shard arrays on the mesh: shard s on every device
    of index column s, uploaded once per distinct (device, shard).
    Returns (bucket_start, comb, sub_base, sub_lo), each a [rows][cols]
    nested list of tensors; comb_rows is carried as its int32 view, as
    index.device does."""
    cache: dict = {}

    def put(d, s):
        if (d, s) not in cache:
            cache[(d, s)] = tuple(
                tensor_on(a, d)
                for a in (bs[s].astype(np.int32, copy=False),
                          cb[s].view(np.int32),
                          sb[s].astype(np.int32, copy=False),
                          sl[s].astype(np.int32, copy=False))
            )
        return cache[(d, s)]

    rows, cols = mesh.devices.shape
    cells = [[put(mesh.devices[r, s], s) for s in range(cols)]
             for r in range(rows)]
    return tuple([[c[k] for c in row] for row in cells] for k in range(4))


def _cat_votes(parts: list[VoteResult], device) -> VoteResult:
    return VoteResult(*(
        None if getattr(parts[0], f) is None
        else torch.cat([getattr(p, f).to(device) for p in parts])
        for f in VoteResult._fields
    ))


def _on(v: VoteResult, device) -> VoteResult:
    return VoteResult(*(None if a is None else a.to(device) for a in v))


def index_sharded_vote(
    mesh: Mesh, bucket_bits: int, params: VoteParams,
    static_len: int | None = None, sub_bits: int = 0,
):
    """Build the vote step over a ("reads", "index") mesh.

    step(codes, ambig, lens, d_bs, d_cb, d_sb, d_sl) -> VoteResult on the
    mesh's first device.  codes (uint8 [R, L]), ambig (bool) and lens
    (int32 [R]) are numpy arrays or tensors whose leading dimension the
    number of mesh rows divides; d_* are place_sharded_index's.  Each
    cell votes its row's reads against its column's shard
    (search_steps=0, as the JAX step does), every cell launched before
    any is gathered; a row's S partial tables are folded left to right
    on the row's first device."""
    n_rows, n_shards = mesh.devices.shape
    first = mesh.devices[0, 0]

    def step(codes, ambig, lens, d_bs, d_cb, d_sb, d_sl):
        partial = []
        for r, sl_r in enumerate(row_blocks(codes.shape[0], n_rows)):
            row = []
            for s in range(n_shards):
                d = mesh.devices[r, s]
                c, a, ln = (tensor_on(x[sl_r], d) for x in (codes, ambig, lens))
                row.append(vote_batch(
                    c, a, ln, d_bs[r][s], d_cb[r][s], bucket_bits, params,
                    static_len=static_len, sub_base=d_sb[r][s],
                    sub_lo=d_sl[r][s], sub_bits=sub_bits, search_steps=0,
                ))
            partial.append(row)
        rows = []
        for r in range(n_rows):
            home = mesh.devices[r, 0]
            acc = _on(partial[r][0], home)
            for s in range(1, n_shards):
                acc = merge_vote_results(acc, _on(partial[r][s], home), params)
            rows.append(acc)
        return _cat_votes(rows, first)

    return step
