"""The chunk loop of align_file and align_file_pe over several chunks: the
port's Aligner on the CPU against the JAX package's, both with the same
small chunk_reads, so that every file is read in three or more chunks and
the last one is short.  What one chunk leaves for the next (the indel
event table, the long-insertion piles, the junction table with its
pending seed junctions, the breakpoints) shows in the side files, which
must be byte-equal with the SAM or BAM:

  * single-end subread-align with -I 60: SAM and .indel.vcf;
  * paired subread-align: SAM and .indel.vcf;
  * single-end subjunc with -a: SAM, .junction.bed and .indel.vcf;
  * paired subjunc with --allJunctions: SAM, .junction.bed, .indel.vcf
    and .breakpoints.vcf;
  * single-end subread-align with -I 60 to BAM, with the native library
    and without it.

The genome and reads are those of test_torch_subjunc.py (genome, spliced
reads and pairs, the -a GTF), test_torch_pe.py (pairs) and
test_torch_longindel.py (long-indel reads).  test_benchmark_wrapped_names
holds the port to the names the benchmark wraps by setattr, and to how
often a three-chunk run calls each."""

import filecmp
from dataclasses import replace

import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.io.fastq import ReadBatch
from subread_tpu_torch.synth import synthetic_long_indel_reads, write_fastq
from subread_tpu_torch.tools import align as align_cli
from subread_tpu_torch.tools import subjunc as subjunc_cli
from test_torch_pe import pairs_for
from test_torch_subjunc import data, genome, index  # noqa: F401  (fixtures)
from torch_native_fixtures import native_mode  # noqa: F401  (fixture)

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

BATCH = 512     # as test_torch_subjunc.py: one JAX compile per configuration
PAIRS = 400     # pairs_for's special and simulated pairs, not its exact ones


def config(tool: str, *extra):
    """subread-align ("align") or subjunc options as the CLI builds them."""
    cli = subjunc_cli if tool == "subjunc" else align_cli
    base = ["-i", "x", "-r", "x", "-o", "x"] + (["-t", "1"] if tool == "align" else [])
    cfg = align_cli.config_from_args(cli.build_parser().parse_args(base + list(extra)),
                                     tool == "subjunc")
    return replace(cfg, batch_reads=BATCH)


# case: (tool, options, paired, side files); "subjunc-a" takes the
# annotated junctions of -a as the CLI sets them, on the aligner
CASES = {
    "align-I60": ("align", ("-I", "60"), False, (".indel.vcf",)),
    "align-pe": ("align", ("-R", "x"), True, (".indel.vcf",)),
    "subjunc-a": ("subjunc", (), False, (".junction.bed", ".indel.vcf")),
    "subjunc-pe-all": ("subjunc", ("-R", "x", "--allJunctions"), True,
                       (".junction.bed", ".indel.vcf", ".breakpoints.vcf")),
}


@pytest.fixture(scope="module")
def inputs(genome, data):
    """Each case's FASTQ file(s) with its chunk_reads, two fifths of its
    reads (pairs): two whole chunks and a short third; and the annotated
    junctions of data's GTF."""
    d = data["dir"]
    write_fastq(str(d / "li.fq"), synthetic_long_indel_reads(genome, seed=77))
    for m, b in enumerate(pairs_for(genome, PAIRS, seed=21)):
        b = ReadBatch(b.names[:PAIRS], b.codes[:PAIRS], b.lengths[:PAIRS],
                      b.quals[:PAIRS], b.ambig[:PAIRS])
        write_fastq(str(d / f"p{m + 1}.fq"), b, suffix=f"/{m + 1}")
    fq = {"align-I60": [d / "li.fq"], "align-pe": [d / "p1.fq", d / "p2.fq"],
          "subjunc-a": [d / "se.fq"], "subjunc-pe-all": [d / "r1.fq", d / "r2.fq"]}
    fq = {k: [str(p) for p in v] for k, v in fq.items()}
    for case in ("align-I60", "align-pe"):     # 400 for the seam test
        for p in fq[case]:
            with open(p) as f, open(p + ".head", "w") as h:
                h.writelines(line for _, line in zip(range(4 * 400), f))
    chunk = {}
    for case, paths in fq.items():
        with open(paths[0]) as f:
            n = sum(1 for _ in f) // 4
        chunk[case] = -(-2 * n // 5)
        assert n > 2 * chunk[case] and n % chunk[case], (case, n)
    ann = align_cli.load_annotated_junctions(subjunc_cli.build_parser().parse_args(
        ["-i", "x", "-r", "x", "-o", "x", "-a", str(d / "ann.gtf")]))
    assert ann
    return d, fq, chunk, ann


@pytest.fixture(scope="module")
def aligners(genome, index, inputs):
    """The port's and the JAX package's aligner of each case, built once."""
    out = {}

    def get(case):
        if case not in out:
            tool, extra, _, _ = CASES[case]
            cfg = config(tool, *extra)
            al, jal = Aligner(genome, index, cfg, device="cpu"), JAligner(genome, index, cfg)
            if case == "subjunc-a":
                al.annot_junctions = jal.annot_junctions = inputs[3]
            out[case] = al, jal
        return out[case]
    return get


def run_both(aligners, inputs, case, out_port, out_jax):
    _, fq, chunk, _ = inputs
    for a, out in zip(aligners(case), (out_port, out_jax)):
        run(a, fq, chunk, case, out)


def run(al, fq, chunk, case, out):
    if CASES[case][2]:
        al.align_file_pe(*fq[case], out, chunk_reads=chunk[case])
    else:
        al.align_file(fq[case][0], out, chunk_reads=chunk[case])


def same(a, b) -> bool:
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_outputs_match_jax(aligners, inputs, case):
    d = inputs[0]
    t, j = str(d / f"chunks_t_{case}.sam"), str(d / f"chunks_j_{case}.sam")
    run_both(aligners, inputs, case, t, j)
    for suf in ("",) + CASES[case][3]:
        assert same(t + suf, j + suf), suf
    with open(t) as f:
        cigars = [ln.split("\t")[5] for ln in f if not ln.startswith("@")]
    if case.startswith("subjunc"):
        assert sum("N" in c for c in cigars) > 100
        with open(t + ".junction.bed") as f:
            assert len(f.read().splitlines()) > 20
    else:
        assert sum("D" in c or "I" in c for c in cigars) > 20
    if case == "subjunc-pe-all":
        with open(t + ".breakpoints.vcf") as f:
            assert "SVTYPE=BND" in f.read()


def test_chunked_bam_matches_jax(aligners, inputs, native_mode):
    d = inputs[0]
    t = str(d / f"chunks_t_{native_mode}.bam")
    j = str(d / f"chunks_j_{native_mode}.bam")
    run_both(aligners, inputs, "align-I60", t, j)
    assert same(t, j)
    assert same(t + ".indel.vcf", j + ".indel.vcf")


def test_benchmark_wrapped_names(genome, index, inputs, tmp_path, monkeypatch):
    """Every (owner, name) the benchmark's aligner and sublong tools wrap
    exists, and a three-chunk single-end and a three-chunk paired run call
    through those names: the submit, collect and emit steps, the
    saturation rescue, the multi-indel refinement and the mates' rescue
    once a chunk, the event placement once for each end whose results
    carry probe_kv.  The benchmark labels the card's idle time by these
    calls."""
    from benchmark.aligner import AlignerTool, CyclicReader
    from benchmark.tools.sublong import SublongTool
    from subread_tpu_torch.io import bam

    tools = (AlignerTool("subread_tpu_torch.tools.align", subjunc=False),
             SublongTool("subread_tpu_torch.tools.sublong", subjunc=False))
    wrapped = {(owner, name) for tool in tools for owner, name, _ in tool.spans()}
    assert callable(bam.BamWriter.add_sam_fields)    # the `half` fault's
    calls, flagged = {}, [0]
    for owner, name in wrapped:
        assert callable(getattr(owner, name, None)), (owner, name)
        if owner is CyclicReader:
            continue

        def counted(*a, _f=getattr(owner, name), _k=name, **k):
            calls[_k] = calls.get(_k, 0) + 1
            out = _f(*a, **k)
            if _k.startswith("collect_batch"):    # ends with probe_kv to place
                flagged[0] += sum("probe_kv" in r for r in
                                  (out if isinstance(out, tuple) else (out,)))
            return out
        monkeypatch.setattr(owner, name, counted)

    _, fq, _, _ = inputs
    # the port alone, on sub-batches of 64: three chunks of at most 160;
    # the event placement runs for each end whose results have probe_kv
    for case, want in (
        ("align-I60", {"submit_batch": 3, "collect_batch": 3,
                       "_rescue_saturated": 3, "refine_multi_indels": 3,
                       "_emit_sam": 3}),
        ("align-pe", {"submit_batch_pe": 3, "collect_batch_pe": 3,
                      "_rescue_saturated_pe": 3, "rescue_unmapped_mates": 3,
                      "_emit_sam_pe": 3}),
    ):
        tool, extra, _, _ = CASES[case]
        al = Aligner(genome, index, replace(config(tool, *extra), batch_reads=64),
                     device="cpu")
        calls.clear()
        flagged[0] = 0
        run(al, {case: [p + ".head" for p in fq[case]]}, {case: 160}, case,
            str(tmp_path / f"{case}.bam"))
        assert flagged[0] >= 3, case
        assert calls == {**want, "propose_and_apply": flagged[0]}, case
