"""`correct` on the CPU at a small size: a sound run of each cell is
correct, and each fault the cell can have, planted under the timed path,
makes it false, as does the control (the cell with -M raised to the limits
file's control_max_mismatches).  These skip the runner's look for a card
and drive the rest of a run (harness.run_cell on the CPU)."""

import time

import pytest

from benchmark.harness import run_cell
from benchmark.spec import Spec

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.data["workloads"]]
FAULTS = [(c, f) for c in CELLS
          for f in SPEC.tool(SPEC.config(SPEC.workload(c)["config"])["tool"]).faults]


def run(cell, cache, small, **kw):
    import torch

    torch.set_num_threads(4)
    return run_cell(Spec(), cell, 20261017, 1.0, False, time.perf_counter(),
                    device="cpu", overrides=small, cache=cache,
                    log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, index_cache, small):
    r = run(cell, index_cache, small)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for k, (v, lim) in r["checks"].items():
        assert v <= lim, k


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, index_cache, small):
    r = run(cell, index_cache, small, fault=fault)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(cell, index_cache, small):
    r = run(cell, index_cache, small, control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["over_mismatch_limit"][0] > 0
