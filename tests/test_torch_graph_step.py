"""The sub-batch step's graph path (align/graphstep.py) off the card, and
what makes the step recordable, on the CPU: submit_batch and
submit_batch_pe run the eager step there and count each sub-batch as
`submit.eager_steps` while the profiler records (nothing otherwise), with
the results `_device_align`/`_device_align_pe` give; the benchmark's
host.submit.graph_share reads those counters; the vote's host constants
are made on the device once (a second vote makes no host tensor) and give
the values a fresh build gives; the static-shape column repeat equals
repeat_interleave.  The card's replays are held to the eager step by
tests/test_torch_graph_step_gpu.py."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.spec import Spec
from subread_tpu_torch import timing
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.config import aligner_config
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.ops import vote
from subread_tpu_torch.synth import synthetic_genome, synthetic_pairs, synthetic_reads

torch.set_num_threads(2)

BS = 128


@pytest.fixture(scope="module")
def aligner():
    g = synthetic_genome(200_000, seed=61, n_contigs=2, tandem_frac=0.03)
    ix = build_hash_index(g, index_gap=3)
    return g, Aligner(g, ix, aligner_config(batch_reads=BS), device="cpu")


def steps_counted(fn):
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counts = {}
    for c in timing.counters():
        counts[c.name] = counts.get(c.name, 0) + c.value
    return out, counts


def assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_cpu_steps_are_eager_and_counted(aligner):
    g, al = aligner
    batch = synthetic_reads(g, 3 * BS, seed=62)
    timing.clear()
    al.submit_batch(batch)
    assert timing.counters() == []
    (pending, R, _), counts = steps_counted(lambda: al.submit_batch(batch))
    assert counts == {"submit.eager_steps": 3} and R == 3 * BS
    codes, ambig, lens, _ = al._pad_batch(batch)
    for j, res in enumerate(pending):
        sl = slice(j * BS, (j + 1) * BS)
        want = al._device_align(*al._upload_reads(codes[sl], ambig[sl], lens[sl]),
                                uniform_len=100)
        assert res.done is None
        assert_same(res.get(), want)
    assert al.step_graphs._chains == {}


def test_cpu_pair_steps_are_eager_and_counted(aligner):
    g, al = aligner
    b1, b2 = synthetic_pairs(g, 2 * BS, seed=63)
    (pending, _, _, _), counts = steps_counted(lambda: al.submit_batch_pe(b1, b2))
    assert counts == {"submit.eager_steps": 2}
    m = [al._pad_batch(b) for b in (b1, b2)]
    for j, res in enumerate(pending):
        r1, r2 = res.get()
        sl = slice(j * BS, (j + 1) * BS)
        up = [al._upload_reads(c[sl], a[sl], ln[sl]) for c, a, ln, _ in m]
        w1, w2 = al._device_align_pe(*up[0], *up[1], ul1=100, ul2=100)
        assert_same(r1, w1)
        assert_same(r2, w2)


def read_graph_share(counts):
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, value in counts:
            timing.count(name, value)
    return Spec().reader("host.submit.graph_share")({"window_s": 1.0})


def test_graph_share_reader():
    assert read_graph_share([]) is None
    assert read_graph_share([("bam.records_native", 5)]) is None
    assert read_graph_share([("submit.graph_steps", 3), ("submit.eager_steps", 1)]) == 0.75
    assert read_graph_share([("submit.graph_steps", 1)] * 4) == 1.0
    assert read_graph_share([("submit.eager_steps", 2)]) == 0.0
    with pytest.raises(RuntimeError):
        read_graph_share([("submit.graph_steps", 0), ("submit.eager_steps", 0)])


@pytest.mark.parametrize("static", [100, None])
def test_vote_constants_are_made_once(aligner, static, monkeypatch):
    g, al = aligner
    batch = synthetic_reads(g, BS, seed=64)
    codes, ambig, lens, _ = al._pad_batch(batch)
    if static is None:
        lens[::3] -= 7
    dc, da, dl = al._upload_reads(codes, ambig, lens)
    blk = al.dev_index.blocks[0]
    run = lambda vp: vote.vote_batch(
        dc, da, dl, blk.bucket_start, blk.comb, blk.bucket_bits, vp,
        static_len=static, sub_base=blk.sub_base, sub_lo=blk.sub_lo,
        sub_bits=blk.sub_bits, search_steps=blk.search_steps)
    vps = [al.vote_params, *(vp for vp, _ in al.rescue_tiers)]
    assert any(vp.wide_slots for vp in vps)
    vote._const_of.cache_clear()
    fresh = [(run(vp), vote.probe_inputs(dc, da, dl, vp, static)) for vp in vps]
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: made.append(a) or real(a))
    again = [(run(vp), vote.probe_inputs(dc, da, dl, vp, static)) for vp in vps]
    assert made == []
    for (v0, p0), (v1, p1) in zip(fresh, again):
        for a, b in zip(v0, v1):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(p0[:4], p1[:4]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert p0[4] == p1[4]


def test_repeat_cols_is_repeat_interleave():
    a = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    for n in (1, 3, 32):
        assert torch.equal(vote._repeat_cols(a, n), a.repeat_interleave(n, dim=1))
    e = torch.arange(5).expand(3, 5)
    assert torch.equal(vote._repeat_cols(e, 4), e.repeat_interleave(4, dim=1))
