"""BENCHMARK.json against the contract's shape, and cells and metrics
found by name."""
from __future__ import annotations

import json
import re
from types import SimpleNamespace

import pytest

from benchmark.cells import HERE, REPO, load_cell, metric_reader
from benchmark.run import run_cell

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in E2E and "\n" not in m["layer"]
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "setup_s", "mpaths_per_s", "mphotons_per_s", "iter_ms_p95"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_by_name(cell):
    c = load_cell(cell)
    assert c.chips == 1 and c.limits["accum_mismatch"] == 0
    # a plain reference scene beside the configuration, a generated mesh,
    # or a mesh placed in such a scene
    assert "mesh" in c.config or "scene" in c.config
    if "scene" in c.config:
        assert (HERE / "configs" / c.config["scene"]).is_file()
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]))
    for m in c.per_layer:
        # every cell that reports a per-layer metric reports what it moves
        assert m["moves"] in e2e


class _Counts(dict):
    """A work count that reads 1 under every key."""

    def __missing__(self, key):
        return 1.0


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_rooflines_listed_only_where_their_integrator_runs(cell):
    """A roofline reads nothing in a run of another integrator, so a cell
    that lists it would print a traced line without it."""
    c = load_cell(cell)
    trace = SimpleNamespace(iters=1, seconds=lambda match: 1e-3)
    ctx = SimpleNamespace(mode=c.traffic["mode"], trace=trace,
                          work=_Counts(), pixels=1920 * 1080)
    for m in c.per_layer:
        if m["name"].endswith("_roofline"):
            assert metric_reader(m["name"])(ctx) is not None, m["name"]


def test_dummy_cell_and_metric_added_as_files(tiny_root):
    """A cell, a traffic mix and a metric that are only new files."""
    (tiny_root / "metrics" / "iters_done.py").write_text(
        "def read(ctx):\n    return ctx.iters\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "iters_done", "unit": "iters",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-pt"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("tiny-pt", bench=tiny_root / "BENCHMARK.json",
                     root=tiny_root)
    out = run_cell(cell, 2 ** 31 + 5, 0.5, False, device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["iters_done"]["value"] == out["attempted"]
    assert list(out)[-1] == "compared"
