"""subread_tpu_torch.probe_bench on the CPU: the bytes probe_hits must move,
counted probe by probe with scalar arithmetic, against the vectorised count
that chip_smoke.py turns into the kernel's bound; and the smoke's shapes
and inputs as the vote builds them.  Each case runs on a full index and on
a gapped one (index_gap=3)."""

import types

import numpy as np
import pytest
import torch

from subread_tpu_torch.index import to_device
from subread_tpu_torch.index.build import build_hash_index, build_sub_directory
from subread_tpu_torch.ops.probe import COMB_W, GROUP
from subread_tpu_torch.ops.vote import VoteParams
from subread_tpu_torch.probe_bench import (
    bound_ms, probe_hits_bytes, probe_shapes, smoke_shapes,
)
from subread_tpu_torch.synth import synthetic_genome, synthetic_reads

from test_torch_probe_gpu import GENOME, make_probes


@pytest.fixture(scope="module")
def genome():
    return synthetic_genome(**GENOME)


@pytest.fixture(scope="module", params=[1, 3], ids=["gap1", "gap3"])
def setup(genome, request):
    """The full index and the gapped one (index_gap=3, subread-buildindex's
    default), each with its own bucket sizes and sub-bucket directory."""
    index = build_hash_index(genome, index_gap=request.param)
    blk = to_device(index, genome, torch.device("cpu")).blocks[0]
    return genome, index, blk


def scalar_bytes(a, ix, H) -> int:
    """probe_hits_bytes' count, one probe at a time."""
    keys, valid, orient, off = (t.numpy() for t in a)
    bucket_start, comb, sub_base, sub_lo, bb, sbits, steps = ix
    bs, flat = bucket_start.numpy(), comb.numpy().reshape(-1).view(np.uint32)
    sb_arr, sl_arr = sub_base.numpy(), sub_lo.numpy()
    total = keys.size * (8 + 1 + 1 + 8 * H + 1) + 4 * off.size
    for key, ok, ori in zip(keys.ravel(), valid.ravel(), orient.ravel()):
        if not ok:
            continue
        key = int(key)
        b = key >> (32 - bb)
        lo, hi = int(bs[b]), int(bs[b + 1])
        q = ((key & ((1 << (32 - bb)) - 1)) << 1) | int(ori)
        total += 8
        if sbits:
            total += 4
            if sb_arr[b] >= 0:
                total += 4
                si = min(int(sb_arr[b]) + (q >> (33 - bb - sbits)), sl_arr.size - 1)
                lo = int(sl_arr[si])
        cur, length = lo, min(hi - lo, 1 << steps)
        for _ in range(steps):
            total += 4
            half = length >> 1
            mid = cur + half
            wi = min(max((mid >> 4) * COMB_W + GROUP + ((mid & 15) >> 1), 0),
                     flat.size - 1)
            c = (int(flat[wi]) >> ((mid & 1) << 4)) & 0xFFFF
            if c < q and length > 0:
                cur, length = mid + 1, length - half - 1
            else:
                length = min(half, length)
        total += 6 * min(max(hi - cur, 0), H)
    return total


@pytest.mark.parametrize("H", [16, 96])
@pytest.mark.parametrize("directory", ["index", "coarse", "none"])
def test_probe_hits_bytes_counts_each_probe(setup, directory, H):
    genome, index, blk = setup
    if directory == "index":
        sub_dir = index.sub_dir
    elif directory == "coarse":
        sub_dir = build_sub_directory(index.keys, index.orient,
                                      index.bucket_start, index.bucket_bits,
                                      force_bits=2)
        assert sub_dir[3] > 0
    else:
        sub_dir = (np.full(1 << index.bucket_bits, -1, np.int32),
                   np.zeros(1, np.int32), 0, 0)
    keys, valid, orient, own, off, _ = make_probes(genome, index, seed=3,
                                                   n_reads=64)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    sb, sl, sbits, steps = sub_dir
    ix = (blk.bucket_start, blk.comb, t(sb), t(sl), index.bucket_bits, sbits, steps)
    for o in (own, off):
        a = (t(keys), t(valid), t(orient), t(o))
        n = probe_hits_bytes(a, ix, H)
        assert n == scalar_bytes(a, ix, H)
        assert bound_ms(n) == n / 3.35e12 * 1e3


def test_smoke_shapes_and_inputs(setup):
    genome, index, blk = setup
    vp = VoteParams(index_gap=index.index_gap)
    al = types.SimpleNamespace(vote_params=vp, rescue_hits=96,
                               dev_index=types.SimpleNamespace(blocks=[blk]))
    reads = synthetic_reads(genome, 600, seed=2)
    batch = tuple(torch.from_numpy(x) for x in
                  (reads.codes, reads.ambig, reads.lengths))
    for subjunc in (False, True):
        shapes = smoke_shapes(al, 600, subjunc)
        tag = "subjunc-" if subjunc else ""
        assert [s[0] for s in shapes] == [f"{tag}main", f"{tag}wide-mixed",
                                          f"{tag}wide-full"]
        got = list(probe_shapes(al, batch, vp, shapes))
        P = got[0][4][0].shape[1]
        for (name, r, p, H, a, ix), (_, rows, probes, h, shared) in zip(got, shapes):
            keys, valid, orient, off = a
            assert (r, p, H) == (rows, probes or P, h)
            # the first rows reads of the batch, all of them where it has fewer
            assert keys.shape == valid.shape == orient.shape == (min(r, 600), p)
            assert off.shape == ((p,) if shared else (keys.shape[0], p))
            assert all(x.is_contiguous() for x in a)
            assert ix[0] is blk.bucket_start and ix[4:] == (
                blk.bucket_bits, blk.sub_bits, blk.search_steps)
