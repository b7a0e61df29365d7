"""A short run of the first cell on the card, through the command
(`python -m pytest benchmark/tests -q -m gpu` on a machine with one)."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import ROOT


@pytest.mark.gpu
def test_first_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "align-se100-acgt.wbcel235", "--seed", "7", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"reads_per_s", "setup_s", "true_placed"} <= set(line["metrics"])
