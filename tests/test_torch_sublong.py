"""sublong on the port against the JAX package, on a 1.5 Mb synthetic
genome with long reads of 2-20 kb made here from a seed
(`synth.synthetic_long_reads`: 2% substitutions and one-base indels, both
strands, a quarter of them across a planted 300-base deletion):

  * `map_long_reads`' hits (position, strand, clips, CIGAR operations,
    windows, votes) and `sublong_file`'s SAM equal JAX's, with sublong's
    aligner options and with -X's;
  * `python -m subread_tpu_torch.tools.sublong --device cpu` writes the
    same SAM as subread_tpu's sublong CLI, with and without -X.

Every output is an integer or a file: the tolerance is 0."""

import re

import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.align import longread as jlong
from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu.config import aligner_config as jconfig
from subread_tpu.index.build import build_hash_index
from subread_tpu.tools import sublong as jcli
from subread_tpu_torch.align import longread as tlong
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.synth import synthetic_genome, synthetic_long_reads, write_fastq
from subread_tpu_torch.tools import sublong as tcli

torch.set_num_threads(1)

N_READS = 12
DEL = 300


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sublong")
    g = synthetic_genome(1_500_000, seed=11)
    idx = build_hash_index(g, index_gap=1)
    prefix = str(d / "idx")
    g.save(prefix)
    idx.save(prefix)
    reads = synthetic_long_reads(g, N_READS, seed=12, del_frac=0.25, del_len=DEL)
    assert any(not n.endswith("_0") for n in reads.names)
    fq = str(d / "long.fq")
    write_fastq(fq, reads)
    return dict(dir=d, genome=g, index=idx, prefix=prefix, reads=reads, fq=fq)


def cli_args(setup, rna):
    return ["-i", setup["prefix"], "-r", setup["fq"], "--SAMoutput"] + (["-X"] if rna else [])


def check_sam(path, reads):
    """Every read mapped near its start; each planted deletion a D or an N
    (a gap between chained windows) of at least 250 bases."""
    recs = [line.split("\t") for line in open(path) if not line.startswith("@")]
    assert [f[0] for f in recs] == list(reads.names)
    for f in recs:
        _, contig, pos1, strand, dl = f[0].split("_")
        assert int(f[1]) & 4 == 0 and f[2] == contig, f[:6]
        assert abs(int(f[3]) - int(pos1)) <= 1200 and (int(f[1]) & 16) == 16 * int(strand)
        gaps = [int(n) for n, op in re.findall(r"(\d+)([DN])", f[5]) if int(n) >= 250]
        assert bool(gaps) == (dl != "0"), f[:6]


@pytest.mark.parametrize("rna", [False, True], ids=["dna", "rna-X"])
def test_map_long_reads_and_sublong_file_equal_jax(setup, rna):
    args = tcli.build_parser().parse_args(cli_args(setup, rna) + ["-o", "-"])
    cfg = tcli.sublong_config(args)
    ja = JAligner(setup["genome"], setup["index"], jconfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    ta = Aligner(setup["genome"], setup["index"], cfg, device="cpu")
    b = setup["reads"]
    codes = [b.codes[i, :b.lengths[i]] for i in range(len(b))]
    hits_j = jlong.map_long_reads(ja, codes)
    hits_t = tlong.map_long_reads(ta, codes)
    assert [h.__dict__ for h in hits_j] == [h.__dict__ for h in hits_t]
    assert sum(h.mapped for h in hits_t) == N_READS
    d = setup["dir"]
    got = {}
    for side, mod, al in (("jax", jlong, ja), ("port", tlong, ta)):
        out = str(d / f"{side}-{rna}.sam")
        got[side] = (mod.sublong_file(al, setup["fq"], out, sam_output=True),
                     open(out).read())
    assert got["jax"] == got["port"]
    assert got["port"][0] == (N_READS, N_READS)
    check_sam(d / f"port-{rna}.sam", b)


@pytest.mark.parametrize("rna", [False, True], ids=["dna", "rna-X"])
def test_cli_equals_jax(setup, rna):
    d = setup["dir"]
    jout, tout = str(d / f"jcli-{rna}.sam"), str(d / f"tcli-{rna}.sam")
    with jax.default_device(jax.devices("cpu")[0]):
        assert jcli.main(cli_args(setup, rna) + ["-o", jout]) == 0
    assert tcli.main(cli_args(setup, rna) + ["-o", tout, "--device", "cpu"]) == 0
    assert open(jout).read() == open(tout).read()
    check_sam(tout, setup["reads"])
