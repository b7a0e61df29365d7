"""The benchmark's own tests (`python -m pytest benchmark/tests -q` from the
root of the checkout).  They run on the CPU, except those marked gpu, which
skip themselves where no card is present."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a 1.2 Mb genome with the configurations' contig mix, small pools and
# sub-batches: what a CPU test run can hold
SMALL = {
    "config": {"genome": {"contigs": [["chrI", 700000], ["chrII", 500000],
                                      ["chrM", 13794]],
                          "seed": 235, "segdup_frac": 0.02, "segdup_len": 10000,
                          "tandem_frac": 0.01, "n_runs_per_contig": 3}},
    "pool": 4096, "chunk_reads": 2048, "batch_reads": 1024,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself where none is present")


@pytest.fixture(scope="session")
def small():
    return SMALL


@pytest.fixture(scope="session")
def index_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_cache")
