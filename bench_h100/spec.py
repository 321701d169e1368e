"""What ``BENCHMARK.json`` names, found by name under ``bench_h100/``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives it; the mix is
``traffic/<traffic>.json``; a per-layer metric is read by
``metrics/<name>.py`` (its ``read(record)``). A metric named
``<quantity>.<kind>`` is that quantity in the cells it lists, split off
because they report another end-to-end metric; without a reader of its own
it takes ``metrics/<quantity>.py``. A new configuration, mix or metric is
a new file and new entries, and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


class Cell:
    """One workload of the benchmark with its configuration, traffic and metrics."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; the benchmark has {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


def quantity(metric: str) -> str:
    """What a metric measures: its name before the first dot."""
    return metric.split(".")[0]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, else of ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{quantity(metric)}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} under {HERE / 'metrics'}")
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
