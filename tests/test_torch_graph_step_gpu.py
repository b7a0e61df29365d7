"""The sub-batch step replayed as CUDA graphs (align/graphstep.py) against
the eager step, on a card: single-end subread-align (reads of one length,
and of several), paired-end subjunc and sublong's 2,048-window batches, on
a 2 Mb synthetic genome's default gapped index.  For each, a key's first
chunk records it; then two chunks of at least three sub-batches with other
reads are submitted before either is read back (the depth-1 chunk loop),
so a replay that overwrote an earlier result would show.  Every result of
every replay, as copied to the host behind its step, equals `_device_align`/`_device_align_pe` on the same reads,
key for key, dtype and bits; the kernel launches as often as in the eager
step, and `ops.vote.probe_hits` is called as often, each time on tensors
that still hold that launch's values after the last replay.  Needs no JAX,
so it runs on the machine with the card:

    python -m pytest tests/test_torch_graph_step_gpu.py -q

Elsewhere it skips (a CUDA graph has no CPU mode)."""

import numpy as np
import pytest
import torch

from subread_tpu_torch.align import graphstep, longread
from subread_tpu_torch.align.pipeline import Aligner, uniform_length
from subread_tpu_torch.config import aligner_config, subjunc_config
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.ops import probe, vote
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_long_reads, synthetic_reads,
    synthetic_spliced_pairs,
)
from subread_tpu_torch.tools import sublong as sublong_cli


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def genome():
    card()
    g = synthetic_genome(2_000_000, seed=71, n_contigs=3)
    return g, build_hash_index(g, index_gap=3)


class Launches:
    """The probe_hits calls the vote makes while active: each call's inputs
    as it kept them, and copies taken at the call."""

    def __enter__(self):
        self.orig, self.calls = vote.probe_hits, []
        self.n0 = probe.probe_hits.launches

        def kept(keys, valid, orient, off, *rest):
            ins = (keys, valid, orient, off)
            self.calls.append((ins, tuple(t.clone() for t in ins)))
            return self.orig(keys, valid, orient, off, *rest)

        vote.probe_hits = kept
        return self

    def __exit__(self, *exc):
        vote.probe_hits = self.orig
        torch.cuda.synchronize()
        self.launches = probe.probe_hits.launches - self.n0


def trimmed(batch, rng):
    """The batch with a third of its reads cut to 80-99 bases."""
    cut = rng.random(len(batch)) < 1 / 3
    batch.lengths[cut] = rng.integers(80, 100, int(cut.sum()))
    batch.codes[np.arange(batch.codes.shape[1])[None, :] >= batch.lengths[:, None]] = 0
    return batch


def check_replays(al, chunks, submit, eager):
    """Record the key on chunks[0], then submit the other chunks before
    reading any back; hold every sub-batch's result to eager(sub-batch)."""
    submit(*chunks[0])
    torch.cuda.synchronize()
    chains = list(al.step_graphs._chains.values())
    assert chains and all(isinstance(c, graphstep._Chain) for c in chains)
    with Launches() as graph:
        pending = [submit(*c)[0] for c in chunks[1:]]
    results = [r.get() for p in pending for r in p]
    assert len(results) >= 6
    for ins, at_call in graph.calls:
        for t, c in zip(ins, at_call):
            assert torch.equal(t, c)
    with Launches() as ref:
        wants = [eager(*c) for c in chunks[1:]]
    wants = [w for ws in wants for w in ws]
    assert graph.launches == ref.launches == len(graph.calls) == len(ref.calls)
    assert graph.launches >= 4 * len(results)
    for got, want in zip(results, wants):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].device.type == "cpu", k
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k].cpu()), k


def eager_se(al):
    def run(batch):
        codes, ambig, lens, R = al._pad_batch(batch)
        ul = uniform_length(lens[:R])
        bs = al.cfg.batch_reads
        return [al._device_align(*al._upload_reads(codes[j:j + bs], ambig[j:j + bs],
                                                   lens[j:j + bs]), uniform_len=ul)
                for j in range(0, len(lens), bs)]
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", ["uniform", "mixed"])
def test_single_end_replays_equal_the_eager_step(genome, lengths):
    g, ix = genome
    al = Aligner(g, ix, aligner_config(batch_reads=1024), device=card())
    assert al.rescue_tiers
    rng = np.random.default_rng(72)
    chunks = []
    for i, n in enumerate((1024, 3 * 1024, 3 * 1024 - 100)):
        b = synthetic_reads(g, n, seed=73 + i)
        chunks.append((trimmed(b, rng) if lengths == "mixed" else b,))
    check_replays(al, chunks, al.submit_batch, eager_se(al))


@pytest.mark.gpu
def test_paired_subjunc_replays_equal_the_eager_step(genome):
    g, ix = genome
    al = Aligner(g, ix, subjunc_config(batch_reads=1024), device=card())

    def eager(b1, b2):
        m = [al._pad_batch(b) for b in (b1, b2)]
        R, bs = m[0][3], al.cfg.batch_reads
        uls = [uniform_length(ln[:R]) for _, _, ln, _ in m]
        out = []
        for j in range(0, len(m[0][2]), bs):
            up = [al._upload_reads(c[j:j + bs], a[j:j + bs], ln[j:j + bs])
                  for c, a, ln, _ in m]
            out.append(al._device_align_pe(*up[0], *up[1], ul1=uls[0], ul2=uls[1]))
        return out

    chunks = [synthetic_spliced_pairs(g, n, seed=81 + i)[:2]
              for i, n in enumerate((1024, 3 * 1024, 3 * 1024))]
    check_replays(al, chunks, al.submit_batch_pe, eager)


@pytest.mark.gpu
def test_sublong_window_batches_replay_equal_the_eager_step(genome):
    g, ix = genome
    args = sublong_cli.build_parser().parse_args(["-i", "x", "-r", "y", "-o", "z"])
    al = Aligner(g, ix, sublong_cli.sublong_config(args), device=card())
    assert al.cfg.batch_reads == 2048
    chunks = []
    for i, n in enumerate((30, 90, 90)):
        lr = synthetic_long_reads(g, n, seed=91 + i, min_len=6000, max_len=9000)
        reads = [lr.codes[r, : lr.lengths[r]] for r in range(len(lr))]
        batch, _, _ = longread.window_batch(reads, al.cfg.pad_read_len)
        chunks.append((batch,))
    assert all(len(c[0]) > 3 * 2048 for c in chunks[1:])
    check_replays(al, chunks, al.submit_batch, eager_se(al))
