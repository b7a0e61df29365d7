"""collect_batch against the JAX pipeline's on a gapped index and on a
two-block (-M) index: the same dict of numpy arrays (keys, dtypes and
values), the saturation rescue included.  The cases share
test_torch_align.py's genome, reads and checks."""

import pytest

pytest.importorskip("jax")

from subread_tpu.index.build import build_hash_index, split_index_blocks
from test_torch_align import genome, index  # noqa: F401  (fixtures)
from test_torch_align import collect_config, collect_matches_jax


@pytest.mark.parametrize("case", ["gap3", "blocks"])
def test_collect_batch_dict_matches_jax_split_indexes(genome, index, case,  # noqa: F811
                                                      monkeypatch):
    if case == "gap3":
        idx = build_hash_index(genome, index_gap=3)
    else:
        idx = split_index_blocks(index, memory_mb=1)
        assert len(idx) == 2
    collect_matches_jax(genome, idx, collect_config(), monkeypatch)
