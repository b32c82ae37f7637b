"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files with tiny cells added as files, as a later change adds a cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
TINY = {
    "pt": dict(mode="pt", width=32, height=24, spp=2),
    "bdpt": dict(mode="bdpt", width=32, height=24, spp=2, spl=2,
                 light_depth=3, resample=8),
    "ppm": dict(mode="ppm", width=24, height=16, spl=256),
}
TINY_ENCLOSED = {"icosphere_tris": 320, "textured": False,
                 "material": [0.75, 0.75, 0.75, 1.0, 0.0, 0.0],
                 "radius": 0.35, "center": [0.0, -0.65, -0.55]}


def make_tiny_root(path: Path) -> Path:
    """A root under ``path`` with the benchmark's configurations and
    metrics, a tiny traffic mix and cell for each integrator
    (``tiny-pt``, ``tiny-bdpt``, ``tiny-ppm`` on cornell), a tiny
    textured icosphere with PT's (``tiny-tex``), a tiny icosphere in
    cornell's room with the same traffic (``tiny-enclosed``) and a
    ``BENCHMARK.json`` that lists them."""
    for d in ("configs", "metrics", "limits"):
        shutil.copytree(HERE / d, path / d)
    (path / "workloads").mkdir()
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = []
    for mode, t in TINY.items():
        t = dict(t, tier="auto", eye_depth=4, check_frames=2,
                 check_pixels=256, count_pixels=384,
                 check_prim_tests=1 << 20, trace_seconds=0.1,
                 trace_min_iters=1, why="a test")
        (path / "workloads" / f"tiny-{mode}.json").write_text(json.dumps(t))
        (path / "limits" / f"tiny-{mode}.json").write_text(
            json.dumps({"frame_rel_l1": 1e-6, "accum_mismatch": 0}))
        spec["workloads"].append({"name": f"tiny-{mode}",
                                  "config": "cornell",
                                  "traffic": f"tiny-{mode}", "chips": 1,
                                  "why": "a test"})
    # a configuration that is only a file: a small textured icosphere
    (path / "configs" / "tiny_textured.json").write_text(json.dumps(
        {"mesh": {"icosphere_tris": 320, "textured": True,
                  "material": [0.75, 0.75, 0.75, 1.0, 0.0, 0.0]}}))
    (path / "limits" / "tiny-tex.json").write_text(
        json.dumps({"frame_rel_l1": 1e-6, "accum_mismatch": 0}))
    # PT's traffic with a primitive budget that cuts the block to a third
    # of its pixels, which are then spread over the frame
    t = json.loads((path / "workloads" / "tiny-pt.json").read_text())
    t.update(check_pixels=768, check_prim_tests=321 * 256)
    (path / "workloads" / "tiny-tex.json").write_text(json.dumps(t))
    spec["workloads"].append({"name": "tiny-tex", "config": "tiny_textured",
                              "traffic": "tiny-tex", "chips": 1,
                              "why": "a test"})
    # a configuration that places a mesh in a scene: a 320-triangle
    # icosphere on cornell's floor, under the same traffic as ``tiny-tex``
    (path / "configs" / "tiny_enclosed.json").write_text(json.dumps(
        {"scene": "cornell.txt", "mesh": TINY_ENCLOSED}))
    (path / "limits" / "tiny-enclosed.json").write_text(
        json.dumps({"frame_rel_l1": 1e-6, "accum_mismatch": 0}))
    spec["workloads"].append({"name": "tiny-enclosed",
                              "config": "tiny_enclosed",
                              "traffic": "tiny-tex", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return path


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
