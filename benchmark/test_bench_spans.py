"""The metrics read from the program's own spans and counters: device idle
inside the frames' spans, ``sync.*`` spans an iteration and the live lane
share, on hand-built stretches; and a number in every cell that lists
each of them."""
from __future__ import annotations

import json
import sys
import types
from types import SimpleNamespace

import pytest

from benchmark import trace
from benchmark.cells import REPO, load_cell, metric_reader

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = ("host_wait_ms.render", "host_wait_ms.ppm", "host_syncs.render",
       "host_syncs.ppm", "live_lane_share.render")
PROFILING = "path_tracing_tpu_torch.profiling"


def _stretch(frame="pt.frame", iters=2):
    """A 1000 us stretch of two frames, [0, 400) and [500, 900), with
    device work in [100, 200), [300, 600) and [950, 1000)."""
    st = trace.Stretch(t0=0.0, t1=1000.0, iters=iters)
    st.device = [("k", 100.0, 200.0), ("k", 300.0, 600.0),
                 ("k", 950.0, 1000.0)]
    st.host = [("bench.frame", 0.0, 450.0), (frame, 0.0, 400.0),
               ("sync.pt_loop", 10.0, 20.0), ("sync.pt_loop", 250.0, 260.0),
               ("bench.frame", 480.0, 920.0), (frame, 500.0, 900.0),
               ("sync.bdpt_n_valid", 700.0, 720.0),
               ("sync.early", -50.0, -10.0)]
    return st


def _ctx(mode="pt", st=None):
    return SimpleNamespace(mode=mode, trace=st)


def test_host_wait_counts_idle_inside_the_frames_only():
    st = _stretch()
    # idle in [0, 400): [0, 100) and [200, 300); in [500, 900): [600, 900)
    want = (100 + 100 + 300) * 1e-3 / 2
    assert metric_reader("host_wait_ms.render")(_ctx("pt", st)) == \
        pytest.approx(want)
    assert metric_reader("host_wait_ms.ppm")(_ctx("pt", st)) is None
    pp = _stretch("ppm.pass")
    assert metric_reader("host_wait_ms.ppm")(_ctx("ppm", pp)) == \
        pytest.approx(want)
    bd = _stretch("bdpt.frame")
    assert metric_reader("host_wait_ms.render")(_ctx("bdpt", bd)) == \
        pytest.approx(want)


def test_host_syncs_counts_sync_spans_an_iteration():
    st = _stretch()
    # three sync spans start in the stretch; the one before it is not read
    assert metric_reader("host_syncs.render")(_ctx("pt", st)) == 1.5
    assert metric_reader("host_syncs.ppm")(_ctx("pt", st)) is None
    assert metric_reader("host_syncs.ppm")(
        _ctx("ppm", _stretch("ppm.pass", iters=3))) == 1.0


@pytest.mark.parametrize("name", NEW[:4])
def test_span_metrics_read_none_without_the_programs_spans(name):
    """A program that records no frame span (the parent of the spans)
    reads None, as does a run without a trace."""
    st = _stretch(frame="other.frame")
    mode = "ppm" if name.endswith(".ppm") else "pt"
    assert metric_reader(name)(_ctx(mode, st)) is None
    assert metric_reader(name)(_ctx(mode, None)) is None


def test_live_lane_share_reads_the_counters(monkeypatch):
    read = metric_reader("live_lane_share.render")
    prof = types.ModuleType(PROFILING)
    monkeypatch.setitem(sys.modules, PROFILING, prof)
    assert read(_ctx("pt")) is None            # no counters kept
    prof.counters = {}
    assert read(_ctx("pt")) is None            # no per-bounce loop ran
    prof.counters = {"pt.live_lanes": 3, "pt.lane_slots": 12}
    assert read(_ctx("pt")) == pytest.approx(25.0)
    assert read(_ctx("bdpt")) is None
    monkeypatch.delitem(sys.modules, PROFILING)
    assert read(_ctx("pt")) is None


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_new_metrics_read_a_number_in_every_cell_that_lists_them(
        cell, monkeypatch):
    """A stand-in traced run of the cell, whose program keeps its spans and
    counters, reads a number for each new metric the cell lists: a listed
    metric missing from a traced line refuses the benchmark."""
    c = load_cell(cell)
    mode = c.traffic["mode"]
    frame = {"pt": "pt.frame", "bdpt": "bdpt.frame", "ppm": "ppm.pass"}[mode]
    prof = types.ModuleType(PROFILING)
    prof.counters = {"pt.live_lanes": 5, "pt.lane_slots": 8}
    monkeypatch.setitem(sys.modules, PROFILING, prof)
    ctx = _ctx(mode, _stretch(frame))
    for m in c.per_layer:
        if m["name"] in NEW:
            assert metric_reader(m["name"])(ctx) is not None, m["name"]
