"""subread_tpu_torch must run where JAX is not installed (the machine with
the card has none): in a subprocess where `import jax` fails, import every
module of the port and align 64 reads, then 64 pairs (-R), on the CPU
through the CLI; then run subjunc with --allJunctions on 64 spliced reads
and on 64 spliced pairs."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.path.insert(0, sys.argv[1])
import subread_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    subread_tpu_torch.__path__, "subread_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from subread_tpu.index.build import build_hash_index
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_pairs, synthetic_reads,
    synthetic_spliced_pairs, synthetic_spliced_reads, write_fastq)
from subread_tpu_torch.tools import align, subjunc
d = tempfile.mkdtemp()
p = lambda name: os.path.join(d, name)
g = synthetic_genome(60_000, seed=2)
g.save(p("idx"))
build_hash_index(g, index_gap=3).save(p("idx"))
write_fastq(p("r.fq"), synthetic_reads(g, 64, seed=3))
b1, b2 = synthetic_pairs(g, 64, seed=4)
write_fastq(p("r1.fq"), b1)
write_fastq(p("r2.fq"), b2)
base = ["-t", "1", "-i", p("idx"), "--device", "cpu"]
align.main(base + ["-r", p("r.fq"), "-o", p("o.sam")])
align.main(base + ["-r", p("r1.fq"), "-R", p("r2.fq"), "-o", p("pe.sam")])
write_fastq(p("s.fq"), synthetic_spliced_reads(g, 64, seed=5)[0])
s1, s2, _ = synthetic_spliced_pairs(g, 64, seed=6)
write_fastq(p("s1.fq"), s1)
write_fastq(p("s2.fq"), s2)
sj = ["-i", p("idx"), "--device", "cpu", "--allJunctions"]
subjunc.main(sj + ["-r", p("s.fq"), "-o", p("sj.sam")])
subjunc.main(sj + ["-r", p("s1.fq"), "-R", p("s2.fq"), "-o", p("sjp.sam")])
recs = [l for l in open(p("o.sam")) if not l.startswith("@")]
pe = [l for l in open(p("pe.sam")) if not l.startswith("@")]
sj_recs = [l for l in open(p("sj.sam")) if not l.startswith("@")]
sjp_recs = [l for l in open(p("sjp.sam")) if not l.startswith("@")]
# junction rows after the .junction.bed header
bed = lambda f: len(open(p(f + ".junction.bed")).readlines()) - 1
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "subread_tpu.align",
                                               "subread_tpu.ops")))
mapped = lambda rs: sum(1 for r in rs if int(r.split()[1]) & 4 == 0)
print(len(mods), len(recs), mapped(recs), len(pe), mapped(pe),
      sum(1 for r in pe if int(r.split()[1]) & 2), len(sj_recs), bed("sj.sam"),
      len(sjp_recs), bed("sjp.sam"), loaded)
"""


def test_port_imports_and_aligns_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, REPO], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    (n_mods, n_recs, n_mapped, n_pe, n_pe_mapped, n_proper, n_sj, n_bed,
     n_sjp, n_bed_pe, loaded) = proc.stdout.split(maxsplit=10)
    assert int(n_mods) >= 13
    assert int(n_recs) == 64 and int(n_mapped) >= 50
    assert int(n_pe) == 128 and int(n_pe_mapped) >= 100
    assert int(n_proper) >= 90
    # subjunc single-end and paired-end with --allJunctions
    assert int(n_sj) == 64 and int(n_sjp) == 128
    assert int(n_bed) > 0 and int(n_bed_pe) > 0
    # only the placeholder this script planted: nothing imported JAX or
    # the JAX package's device modules
    assert loaded.strip() == "['jax']"
