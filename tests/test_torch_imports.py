"""The port imports nothing of the JAX package and no JAX: every module of
subread_tpu_torch, and the scripts that run on the machine with the card
(chip_smoke.py, profile_torch_pe.py, profile_probe_hits.py,
tests/test_torch_probe_gpu.py), are parsed and each import statement is
checked, wherever it stands (at the top of a module or inside a
function)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "subread_tpu_torch").rglob("*.py")
) + ["chip_smoke.py", "profile_torch_pe.py", "profile_probe_hits.py",
     "tests/test_torch_probe_gpu.py", "tests/test_torch_trace_gpu.py"]


def forbidden_imports(source: str) -> list[str]:
    """The modules of `source`'s import statements that are jax or any
    module of the JAX package `subread_tpu` (`subread_tpu_torch` is not)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "subread_tpu"):
                bad.append(n)
    return bad


@pytest.mark.parametrize("path", FILES)
def test_file_imports_nothing_of_the_jax_package(path):
    assert forbidden_imports((REPO / path).read_text()) == [], path


def test_the_check_finds_every_form():
    src = """
import subread_tpu
import os, subread_tpu.dna as d
from subread_tpu.io import sam
from subread_tpu import native
import jax.numpy as jnp
from subread_tpu_torch import dna
from . import dna
def f():
    from subread_tpu.index.build import build_hash_index
"""
    assert forbidden_imports(src) == [
        "subread_tpu", "subread_tpu.dna", "subread_tpu.io", "subread_tpu",
        "jax.numpy", "subread_tpu.index.build",
    ]
    assert len(FILES) > 30
