"""host.emit.native_share, the share of the window's BAM records the
program packed with its native encoder: its reader on counters recorded
here (none, some of each, none packed), and a traced run of each cell on
the CPU at the size test_bench_correct.py uses, which reports it at 1 (every
record packed natively) where the native library builds."""

import time

import pytest

from benchmark.harness import run_cell
from benchmark.spec import Spec

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.data["workloads"]]


def read_counted(counts):
    """The reader on counters (name, value) recorded in a profiler session."""
    from torch.profiler import ProfilerActivity, profile

    from subread_tpu_torch import timing

    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, value in counts:
            timing.count(name, value)
    return SPEC.reader("host.emit.native_share")({"window_s": 1.0})


def test_reader_on_recorded_counters():
    assert read_counted([]) is None
    assert read_counted([("bam.pack_ns", 5)]) is None
    assert read_counted([("bam.records_native", 30), ("bam.records_python", 10),
                         ("bam.records_native", 60)]) == 0.9
    assert read_counted([("bam.records_python", 4)]) == 0.0
    with pytest.raises(RuntimeError):
        read_counted([("bam.records_native", 0), ("bam.records_python", 0)])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_packs_every_record_natively(cell, index_cache, small):
    import torch

    from subread_tpu_torch import native, timing

    if native.get_lib() is None:
        pytest.skip("no C++ toolchain for the native library")
    torch.set_num_threads(4)
    timing.clear()
    r = run_cell(Spec(), cell, 20261019, 1.0, True, time.perf_counter(),
                 device="cpu", overrides=small, cache=index_cache,
                 log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["host.emit.native_share"]["value"] == 1.0
