"""Finding a cell's files by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json``, ``workloads/<traffic>.json`` and
``limits/<cell>.json``, and each metric the cell reports is the ``read``
function of ``metrics/<metric>.py``.  Adding a cell, a configuration, a
traffic mix or a metric is adding files: nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    root: Path = HERE
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Path | None = None,
              root: Path | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default ``BENCHMARK.json`` at the
    root of the repository) with its files under ``root`` (default this
    directory)."""
    root = HERE if root is None else root
    spec = read_json(REPO / "BENCHMARK.json" if bench is None else bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=read_json(root / "configs" / f"{w['config']}.json"),
        traffic_name=w["traffic"],
        traffic=read_json(root / "workloads" / f"{w['traffic']}.json"),
        limits=read_json(root / "limits" / f"{name}.json"), root=root,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: Path | None = None):
    """The ``read(ctx)`` function of ``metrics/<name>.py``: the metric's
    value from a run's context, or None where the run has nothing for it
    to read."""
    path = (HERE if root is None else root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
