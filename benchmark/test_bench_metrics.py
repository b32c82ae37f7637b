"""The metric arithmetic: rates over the window, the p95 over every
iteration, busy and idle time from profiler events, and the
rooflines from the frozen work model against hand counts."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import trace, workmodel
from benchmark.cells import metric_reader


def ctx(**kw):
    base = dict(mode="pt", pixels=1920 * 1080, paths_per_iter=1920 * 1080 * 4,
                photons_per_iter=1048576, iters=100, window_s=2.5,
                iter_s=[0.025] * 100, setup_s=12.5, scene_setup_s=0.2,
                trace=None, work=None, kernel_names=("render_wavefront",
                                                     "bdpt_eye",
                                                     "gather_flux"))
    base.update(kw)
    return SimpleNamespace(**base)


def test_rates_over_the_window():
    c = ctx(iters=100, window_s=2.5)
    assert metric_reader("mpaths_per_s")(c) == pytest.approx(
        1920 * 1080 * 4 * 100 / 2.5 / 1e6)
    assert metric_reader("mphotons_per_s")(c) is None
    c = ctx(mode="ppm", iters=30, window_s=3.0)
    assert metric_reader("mphotons_per_s")(c) == pytest.approx(
        1048576 * 30 / 3.0 / 1e6)
    assert metric_reader("mpaths_per_s")(c) is None
    assert metric_reader("setup_s")(c) == 12.5


def test_p95_over_every_iteration():
    it = [0.001 * k for k in range(200, 0, -1)]    # 200..1 ms
    # nearest rank: the 190th of 200 in order
    assert metric_reader("iter_ms_p95")(ctx(iter_s=it)) == pytest.approx(190)
    assert metric_reader("iter_ms_p95")(ctx(iter_s=[0.005])) == 5.0


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "bench.frame",
           "ts": 0, "dur": 800},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 50,
           "dur": 300},
          {"ph": "X", "cat": "user_annotation", "name": "bench.sync",
           "ts": 800, "dur": 200},
          {"ph": "X", "cat": "kernel", "ts": 100, "dur": 200,
           "name": "void render_wavefront_kernel<false, 0>(Tables, int)"},
          {"ph": "X", "cat": "kernel", "ts": 250, "dur": 150,
           "name": "void at::native::elementwise_kernel<128, 2>(int)"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 900, "dur": 50,
           "name": "Memcpy DtoD"},
          {"ph": "X", "cat": "kernel", "ts": 2000, "dur": 50,
           "name": "outside_kernel"}]
    return ev


def test_busy_idle_and_breakdown_from_events():
    st = trace.from_chrome(_events(), iters=2)
    assert st.window_s == pytest.approx(1e-3)
    # the union of [100, 400) and [900, 950) within [0, 1000)
    assert st.busy_s == pytest.approx(350e-6)
    c = ctx(trace=st)
    assert metric_reader("idle_share.render")(c) == pytest.approx(65.0)
    assert metric_reader("idle_share.ppm")(c) is None
    glue = metric_reader("glue_ms.render")(c)
    assert glue == pytest.approx((150 + 50) * 1e-3 / 2)
    assert metric_reader("device_ops.ppm")(ctx(mode="ppm", trace=st)) == 1.5
    top = dict(st.top_ops())
    assert top["render_wavefront_kernel"] == pytest.approx(200e-6)
    gaps = dict(st.idle_gaps())
    # [0, 100): under bench.frame and aten::mul from 50 on; the gap's start
    # is what names it; [400, 900) under bench.frame, then bench.sync
    assert gaps["bench.frame"] == pytest.approx(100e-6 + 500e-6)
    assert gaps["bench.sync"] == pytest.approx(50e-6)


def test_roofline_from_frozen_ops_against_hand_counts():
    c = dict(hit_spheres=10, hit_boxes=20, hit_tris=30, shadow_spheres=1,
             shadow_boxes=2, shadow_tris=3, bsdf_samples=4, evals=5, pdfs=6,
             draws=100, iterations=10, iteration_keys=2)
    hand = (11 * 20 + 22 * 24 + 33 * 50 + 4 * 150 + 5 * 110 + 6 * 60
            + (100 - 10 + 2) * 120)
    assert workmodel.mega_ops(c) == hand
    st = trace.from_chrome(_events(), iters=2)
    scale = 1e6
    w = dict(c, scale=scale)
    bound = max(1920 * 1080 * 20 / 3.35e12, hand * scale / 67e12)
    share = metric_reader("render_wavefront_roofline")(
        ctx(trace=st, work=w))
    assert share == pytest.approx(100 * bound / (200e-6 / 2))
    assert metric_reader("render_wavefront_roofline")(ctx(trace=st)) is None
    g = dict(pairs=1000, accepted=10)
    assert workmodel.gather_ops(g) == 1000 * 8 + 10 * 110
    e = dict(rows=2, evals=3, pdfs=4, shadow_spheres=5, shadow_boxes=6,
             shadow_tris=7, hit_spheres=8, hit_boxes=9, hit_tris=10,
             vertices=11, samples=12)
    assert workmodel.eye_ops(e) == (2 * 40 + 3 * 110 + 4 * 60 + 5 * 20
                                    + 6 * 24 + 7 * 50 + 8 * 20 + 9 * 24
                                    + 10 * 50 + 11 * (150 + 360)
                                    + 12 * 240)
