"""The frozen yardsticks against the port's originals at a small size."""

import time

import numpy as np
import pytest
import torch

from benchmark.frozen import probe_bytes
from benchmark.frozen.host_seconds import host_seconds
from benchmark.frozen.synth import genomic_reads, spliced_pairs, synthetic_genome


@pytest.fixture(scope="module")
def small_aligner():
    from subread_tpu_torch.align.pipeline import Aligner
    from subread_tpu_torch.config import aligner_config
    from subread_tpu_torch.index.build import build_hash_index
    from subread_tpu_torch.synth import synthetic_genome as port_genome

    g = port_genome(300_000, seed=3)
    return Aligner(g, build_hash_index(g, index_gap=3), aligner_config(), device="cpu")


def test_constants_equal_the_ports():
    from subread_tpu_torch import probe_bench
    from subread_tpu_torch.ops import probe

    assert probe_bytes.GROUP == probe.GROUP
    assert probe_bytes.COMB_W == probe.COMB_W
    assert probe_bytes.HBM_BYTES_PER_S == probe_bench.HBM_BYTES_PER_S


def test_byte_count_equals_the_ports(small_aligner):
    from subread_tpu_torch import probe_bench
    from subread_tpu_torch.synth import synthetic_reads

    al = small_aligner
    reads = synthetic_reads(al.genome, 512, seed=5)
    codes, ambig, lens, _ = al._pad_batch(reads)
    batch = al._upload_reads(codes[:512], ambig[:512], lens[:512])
    shapes = probe_bench.smoke_shapes(al, 512, subjunc=False, tier_rows=(256, 64))
    n = 0
    for _, _, _, H, a, ix in probe_bench.probe_shapes(al, batch, al.vote_params, shapes):
        port = probe_bench.probe_hits_bytes(a, ix, H)
        assert probe_bytes.probe_hits_bytes(a, ix, H) == port > 0
        assert probe_bytes.bound_ms(port) == probe_bench.bound_ms(port)
        n += 1
    assert n == 3


def test_host_seconds_counts_time_and_spans():
    class Step:
        def work(self, s):
            time.sleep(s)
            return s

    spans = []
    with host_seconds([(Step, "work", "w"), (Step, "work", "w")], spans=spans) as secs:
        assert Step().work(0.02) == 0.02
    assert secs["w"] >= 0.04            # the two wrappers nest: both count
    assert len(spans) == 2 and all(b > a for _, a, b in spans)
    assert "work" in vars(Step) and Step().work(0) == 0


def test_generators_repeat_from_a_seed_and_keep_their_truth():
    g = synthetic_genome([("chrA", 300_000), ("chrB", 200_000), ("chrM", 13_794)], 7)
    a = genomic_reads(g, 500, seed=11)
    b = genomic_reads(g, 500, seed=11)
    assert a.names == b.names and (a.seqs[0] == b.seqs[0]).all()
    assert genomic_reads(g, 500, seed=12).names != a.names
    for pool in (a, genomic_reads(g, 300, seed=13, paired=True),
                 spliced_pairs(g, 300, seed=14)):
        for m in range(pool.mates):
            ok = []
            for r in range(len(pool)):
                if pool.indel[m][r] or pool.introns[m][r] or pool.second[m][r] >= 0:
                    continue
                s = pool.seqs[m][r]
                if pool.reverse[m][r] == 1:
                    from benchmark.frozen.synth import revcomp
                    s = revcomp(s)
                o = g.offsets[pool.contig[m][r]] + pool.start[m][r]
                ok.append(np.mean(s == g.bases[o: o + len(s)]) > 0.9)
            assert np.mean(ok) > 0.99
