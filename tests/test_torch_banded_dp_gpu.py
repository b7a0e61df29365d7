"""The banded_dp CUDA kernel against its plain PyTorch version and against
`banded_align`, on a card: on a chunk's worth of segments that sublong
plans itself (about 2,000, from synth.synthetic_long_reads through
`map_long_reads` on the card), with bands wider than a warp covers and as
wide as the kernel's block takes, on empty reads and empty genome
stretches, op for op; each call launches the kernel once, and a
`torch.cuda.synchronize()` after it reports no fault.  Needs no JAX, so it
runs on the machine with the card:

    python -m pytest tests/test_torch_banded_dp_gpu.py -q

Elsewhere it skips (a CUDA kernel has no CPU mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from subread_tpu_torch.align import longread
from subread_tpu_torch.align.longread import banded_align
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.ops import banded_dp
from subread_tpu_torch.synth import synthetic_genome, synthetic_long_reads
from subread_tpu_torch.tools import sublong as cli


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chunk():
    """(the jobs sublong's one chunk refines, the launches of the call that
    refined them, the hits): 2,048 windows of long reads on a 2 Mb genome,
    mapped by a card's aligner."""
    dev = card()
    g = synthetic_genome(2_000_000, seed=17, n_contigs=2)
    args = cli.build_parser().parse_args(["-i", "x", "-r", "y", "-o", "z"])
    cfg = dataclasses.replace(cli.sublong_config(args), batch_reads=2048)
    al = Aligner(g, build_hash_index(g, index_gap=3), cfg, device=dev)
    lr = synthetic_long_reads(g, 20, seed=18, min_len=6000, max_len=14_000)
    reads = [lr.codes[i, : lr.lengths[i]] for i in range(len(lr))]
    jobs, orig = [], banded_dp.refine

    def capture(segments, device):
        jobs.extend(segments)
        return orig(segments, device)

    banded_dp.refine = capture
    try:
        before = banded_dp.banded_dp.launches
        hits = longread.map_long_reads(al, reads)
        torch.cuda.synchronize()
        launches = banded_dp.banded_dp.launches - before
    finally:
        banded_dp.refine = orig
    return jobs, launches, hits


def wide_segments(rng):
    """Bands wider than a warp covers, up to a 4,100-base gap either way,
    and empty stretches."""
    g = lambda k: rng.integers(0, 4, k).astype(np.uint8)
    segs = []
    for diff in (150, 300, 1000, 4000):
        gen = g(100 + diff)
        read = np.concatenate([gen[:40], gen[40 + diff:]])
        segs += [(read, gen, 40), (gen, read, 40)]
    return segs + [(g(0), g(9), 40), (g(9), g(0), 40), (g(0), g(0), 24), (g(4000), g(4100), 40)]


@pytest.mark.gpu
def test_sublong_chunk_refines_in_one_launch(chunk):
    jobs, launches, hits = chunk
    assert len(jobs) > 1000
    assert launches == 1
    assert sum(h.mapped for h in hits) >= 15


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["chunk", "wide", "chunk+wide"])
def test_kernel_equals_plain_and_banded_align(chunk, which):
    card()
    rng = np.random.default_rng(5)
    segs = {"chunk": chunk[0], "wide": wide_segments(rng),
            "chunk+wide": chunk[0][::7] + wide_segments(rng)}[which]
    before = banded_dp.banded_dp.launches
    got = banded_dp.refine(segs, "cuda")
    torch.cuda.synchronize()
    assert banded_dp.banded_dp.launches == before + 1
    plain = banded_dp.refine(segs, "cpu")
    assert got == plain
    for (read, gen, extra), ops in zip(segs, got):
        assert ops == banded_align(read, gen, extra_band=extra), (len(read), len(gen))
