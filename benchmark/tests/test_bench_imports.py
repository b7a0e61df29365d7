"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""

import ast

from benchmark.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "subread_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        bad = set(imported(f)) & FORBIDDEN
        assert not bad, (f, bad)


def test_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "subread_tpu_torch" not in set(imported(f)), f
        assert "torch" not in set(imported(f)), f


def test_whole_names_not_prefixes():
    from benchmark.run import forbidden_modules

    names = ["subread_tpu_torch", "subread_tpu_torch.ops.vote", "jaxtyping",
             "subread_tpu.ops.vote", "jaxlib", "flax.linen", "numpy"]
    assert forbidden_modules(names) == ["flax.linen", "jaxlib", "subread_tpu.ops.vote"]
