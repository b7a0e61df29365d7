"""BENCHMARK.json and the files it names, found by name.

A cell `w` of BENCHMARK.json names a configuration `c` and a traffic mix
`t`; their files are `configs/c.json` and `traffic/t.json`, the cell's
limits for `correct` are `limits/w.json`, the configuration's `tool` `x` is
run by `tools/x.py`, a traffic file's `generator` `g` is
`generators/g.py`, and a metric `m` is read by `metrics/m.py`.  Adding a
cell, a configuration, a tool, a traffic mix or a metric is adding files
and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(Path(path).read_text())
        self._metrics: dict = {}
        self._tools: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    @staticmethod
    def config(name: str) -> dict:
        return json.loads((HERE / "configs" / f"{name}.json").read_text())

    @staticmethod
    def traffic(name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    @staticmethod
    def limits(workload: str) -> dict:
        return json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of the cell reports: its end-to-end metrics
        with trace off, its per-layer metrics with trace on (each where its
        `workloads` list, if any, names the cell)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """metrics/<metric>.py's read(ctx)."""
        if metric not in self._metrics:
            self._metrics[metric] = load_by_name("metrics", metric).read
        return self._metrics[metric]

    def tool(self, name: str):
        """tools/<name>.py's TOOL: what a run of a configuration of that
        tool does (harness.run_cell says what it is asked)."""
        if name not in self._tools:
            self._tools[name] = load_by_name("tools", name).TOOL
        return self._tools[name]


def load_by_name(folder: str, name: str):
    """The module <folder>/<name>.py under benchmark/."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py under {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
