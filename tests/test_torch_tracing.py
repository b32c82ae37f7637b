"""The integrators' spans and counters (``profiling.span``, ``count``): off
without a profiler (one flag read, no ``record_function``, no counter), the
image unchanged under one, each frame's top-level span once with its
phases inside it, one ``sync.pt_loop`` span per host read of the
per-bounce PT loop, and ``pt.live_lanes`` equal to the counting plain
loop's ``iterations``; the sphere index's ``scene.sphere_index`` span and
``scene.spheres_indexed`` / ``scene.spheres_scanned`` counters, which the
benchmark's ``indexed_sphere_share.render`` reads.  Tiny renders of
cornell, a textured icosphere and small sphereflakes on the CPU."""
import functools
import json

import pytest
import torch

from path_tracing_tpu_torch import profiling
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
from path_tracing_tpu_torch.ops import _kernels, cuda_shade, rng
from path_tracing_tpu_torch.ops import cuda_wavefront as cw
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.camera import make_camera
from path_tracing_tpu_torch.scene.parser import load_scene

from test_torch_scene import CORNELL

W, H = 8, 6
FRAMES = {"pt": "pt.frame", "bdpt": "bdpt.frame", "ppm": "ppm.pass"}
PHASES = {
    "pt": {"pt.setup", "pt.bounce"},
    "bdpt": {"bdpt.light_trace", "bdpt.light_table", "bdpt.eye"},
    "ppm": {"ppm.eye_pass", "ppm.emission", "ppm.photon_trace",
            "ppm.gather_prepare", "ppm.gather", "ppm.resolve"},
}
# (integrator, tier, scene)
CASES = [("pt", "fused", "cornell"), ("pt", "plain", "cornell"),
         ("pt", "auto", "textured"), ("bdpt", "auto", "cornell"),
         ("bdpt", "auto", "textured"), ("ppm", "auto", "cornell"),
         ("ppm", "auto", "textured")]
IDS = ["-".join(c) for c in CASES]
_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        p = (load_scene(str(CORNELL)) if name == "cornell"
             else synth.icosphere_scene(80, textured=True))
        cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                          device="cpu")
        _SCENES[name] = (p.to_device("cpu"), cam)
    return _SCENES[name]


def _frame(mode, tier, scene_name, i=0):
    """Frame ``i`` of a tiny render: PT spp 2, BDPT spp 1 spl 2 (K 4), PPM
    64 photons a light."""
    scene, cam = _scene(scene_name)
    key = rng.fold_in(rng.prng_key(11), i)
    if mode == "pt":
        cfg = RenderConfig(width=W, height=H, spp=2, eye_depth=3)
        return pt.render_pt(scene, cam, W, H, 2, cfg, key, tier=tier)
    if mode == "bdpt":
        cfg = RenderConfig(width=W, height=H, spp=1, spl=2, light_depth=3,
                           eye_depth=3, bdpt_resample_vertices=4)
        return bdpt.render_bdpt(scene, cam, W, H, 1, 2, cfg, key, tier=tier)
    cfg = RenderConfig(width=W, height=H, spl=64, light_depth=3)
    return ppm.render_ppm_with_stats(scene, cam, W, H, 64, cfg, key,
                                     tier=tier)[0]


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler``: (its result, the Chrome
    trace's user annotations as (name, start, end))."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ann = [(e["name"], e["ts"], e["ts"] + e["dur"])
           for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation" and "dur" in e]
    return out, ann


@pytest.mark.parametrize("mode,tier,scene_name", CASES, ids=IDS)
def test_no_profiler_means_no_span_and_no_counter(mode, tier, scene_name,
                                                  monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    img = _frame(mode, tier, scene_name)
    assert img.shape == (W * H, 3) and bool(torch.isfinite(img).all())
    assert profiling.counters == {}


@pytest.mark.parametrize("mode,tier,scene_name", CASES, ids=IDS)
def test_image_is_the_same_under_a_profiler(mode, tier, scene_name,
                                            tmp_path):
    plain = _frame(mode, tier, scene_name)
    traced, _ = _profiled(lambda: _frame(mode, tier, scene_name), tmp_path)
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("mode,tier,scene_name", CASES, ids=IDS)
def test_each_frame_holds_its_phases(mode, tier, scene_name, tmp_path):
    """Two frames: the top-level span twice, every phase span and every
    ``sync.*`` span inside one of them, and each phase in both."""
    _, ann = _profiled(lambda: [_frame(mode, tier, scene_name, i)
                                for i in range(2)], tmp_path)
    frames = [a for a in ann if a[0] == FRAMES[mode]]
    assert len(frames) == 2
    inner = [a for a in ann if a[0] != FRAMES[mode]]
    for f in frames:
        names = {a[0] for a in inner if f[1] <= a[1] and a[2] <= f[2]}
        assert PHASES[mode] <= names, PHASES[mode] - names
    for name, a, b in inner:
        assert any(f[1] <= a and b <= f[2] for f in frames), name
    assert any(a[0].startswith("sync.") for a in inner)


@pytest.mark.parametrize("tier,scene_name", [
    ("auto", "cornell"), ("plain", "cornell"), ("auto", "textured")])
def test_ppm_eye_pass_on_cpu_tensors_counts_the_loop(tier, scene_name,
                                                     tmp_path):
    """CPU tensors, in any tier, and the plain tier take the eye loop
    (``ppm_eye_plain``): ``ppm.eye_plain`` counted once a pass, no
    ``ppm.eye_kernel``, no launch of either ``ppm_eye`` instance."""
    _kernels.reset_counts()
    _profiled(lambda: [_frame("ppm", tier, scene_name, i) for i in range(2)],
              tmp_path)
    assert profiling.counters.get("ppm.eye_plain") == 2
    assert "ppm.eye_kernel" not in profiling.counters
    assert _kernels.plain_calls["ppm_eye"] == 2
    assert _kernels.launches["ppm_eye"] == _kernels.launches["ppm_eye_tex"] \
        == 0


@pytest.mark.parametrize("tier,scene_name", [
    ("auto", "cornell"), ("plain", "cornell"), ("auto", "textured")])
def test_bdpt_light_trace_on_cpu_tensors_counts_the_loop(tier, scene_name,
                                                         tmp_path):
    """CPU tensors, in any tier, and the plain tier take the light loop
    (``light_trace_plain``): ``bdpt.light_plain`` counted once a frame,
    no ``bdpt.light_kernel``, no launch of either ``bdpt_light``
    instance, and the loop's ``sync.bdpt_light_loop`` reads inside
    ``bdpt.light_trace``."""
    _kernels.reset_counts()
    _, ann = _profiled(lambda: [_frame("bdpt", tier, scene_name, i)
                                for i in range(2)], tmp_path)
    assert profiling.counters.get("bdpt.light_plain") == 2
    assert "bdpt.light_kernel" not in profiling.counters
    assert _kernels.plain_calls["bdpt_light"] == 2
    assert (_kernels.launches["bdpt_light"]
            == _kernels.launches["bdpt_light_tex"] == 0)
    traces = [a for a in ann if a[0] == "bdpt.light_trace"]
    reads = [a for a in ann if a[0] == "sync.bdpt_light_loop"]
    assert len(traces) == 2 and reads
    assert all(any(t[1] <= r[1] and r[2] <= t[2] for t in traces)
               for r in reads)


@pytest.mark.parametrize("tier", ["fused", "plain"])
def test_one_sync_span_per_read_of_the_pt_loop(tier, tmp_path):
    """The per-bounce loop reads the card once an iteration and once more
    to find no lane left; where the iteration cap ends it (no iteration at
    all with a budget of 0), it reads nothing."""
    _, ann = _profiled(lambda: _frame("pt", tier, "cornell"), tmp_path)
    bounces = sum(a[0] == "pt.bounce" for a in ann)
    assert bounces > 0
    assert sum(a[0] == "sync.pt_loop" for a in ann) == bounces + 1
    scene, cam = _scene("cornell")
    cfg = RenderConfig(width=W, height=H, spp=2, eye_depth=0, delta_budget=0)
    img, ann = _profiled(lambda: pt.render_pt(
        scene, cam, W, H, 2, cfg, rng.prng_key(3), tier=tier), tmp_path)
    assert not any(a[0] in ("sync.pt_loop", "pt.bounce") for a in ann)
    assert not img.any() and profiling.counters == {}


@pytest.mark.parametrize("scene_name", ["cornell", "textured"])
def test_live_lanes_equal_the_counting_loops_iterations(scene_name,
                                                        tmp_path):
    """A profiled plain-tier PT frame counts the live lanes the counting
    plain loop counts as ``iterations``, and a lane slot per pixel each
    iteration."""
    scene, cam = _scene(scene_name)
    cfg = RenderConfig(width=W, height=H, spp=2, eye_depth=3)
    key = rng.prng_key(4)
    _profiled(lambda: pt.render_pt(scene, cam, W, H, 2, cfg, key,
                                   tier="plain"), tmp_path)
    got = dict(profiling.counters)
    profiling.reset_counters()
    c = cw.new_counts()
    idx = torch.arange(W * H, dtype=torch.int32)
    step = (cuda_shade.shade_step_tex_plain if scene.has_textures
            else cuda_shade.shade_step_plain)
    pt.wavefront_loop(scene.packed, scene.packed.light, cam, cfg, idx % W,
                      idx // W, 2,
                      key, 0, None, functools.partial(step, counts=c),
                      rng.uniform_rows_plain, counts=c)
    assert got["pt.live_lanes"] == c["iterations"] > 0
    assert got["pt.lane_slots"] == W * H * c["iteration_keys"]


def _flake(levels):
    p = synth.sphereflake_scene(levels)
    return p, make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                          device="cpu")


def test_sphere_index_costs_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    p, cam = _flake(2)
    scene = p.to_device("cpu")
    assert scene.packed.nsc > 0
    cfg = RenderConfig(width=W, height=H, spp=2, eye_depth=3)
    img = pt.render_pt(scene, cam, W, H, 2, cfg, rng.prng_key(5))
    assert bool(torch.isfinite(img).all()) and profiling.counters == {}


def _index_counters():
    return {k: v for k, v in profiling.counters.items()
            if k.startswith("scene.")}


def test_sphere_index_span_and_counters_under_a_profiler(tmp_path):
    """The set-up build of a 91-sphere flake is one ``scene.sphere_index``
    span and counts nothing; each frame that takes its tables counts the
    91 spheres reached through the index and the 3 light balls every ray
    tests in turn; cornell (5 spheres: no index) counts neither."""
    p, cam = _flake(2)
    scene, ann = _profiled(lambda: p.to_device("cpu"), tmp_path)
    assert [a[0] for a in ann].count("scene.sphere_index") == 1
    assert profiling.counters == {}
    cfg = RenderConfig(width=W, height=H, spp=2, eye_depth=3)
    _profiled(lambda: [pt.render_pt(scene, cam, W, H, 2, cfg,
                                    rng.prng_key(5), tier="mega")
                       for _ in range(3)], tmp_path)
    assert _index_counters() == {"scene.spheres_indexed": 3 * 91,
                                 "scene.spheres_scanned": 3 * 3}
    cornell, ccam = _scene("cornell")
    _, ann = _profiled(lambda: (load_scene(str(CORNELL)).to_device("cpu"),
                                pt.render_pt(cornell, ccam, W, H, 2, cfg,
                                             rng.prng_key(5), tier="mega")),
                       tmp_path)
    assert "scene.sphere_index" not in {a[0] for a in ann}
    assert profiling.counters and _index_counters() == {}


def test_indexed_sphere_share_reads_the_counters(tmp_path):
    """``indexed_sphere_share.render``: 100 x indexed / (indexed +
    scanned): 91 of 94 on the 91-sphere flake, above 99.9% on the
    7,381-sphere one (its 3 light balls in turn), None on cornell (no
    index, no counters)."""
    from types import SimpleNamespace

    from benchmark.cells import metric_reader

    read = metric_reader("indexed_sphere_share.render")
    ctx = SimpleNamespace(mode="pt")
    cfg = RenderConfig(width=W, height=H, spp=1, eye_depth=2)
    for levels, share in ((2, 100.0 * 91 / 94), (4, 100.0 * 7381 / 7384)):
        p, cam = _flake(levels)
        scene = p.to_device("cpu")
        _profiled(lambda: pt.render_pt(scene, cam, W, H, 1, cfg,
                                       rng.prng_key(5), tier="mega"),
                  tmp_path)
        assert read(ctx) == pytest.approx(share)
    assert read(ctx) > 99.9
    cornell, ccam = _scene("cornell")
    _profiled(lambda: pt.render_pt(cornell, ccam, W, H, 1, cfg,
                                   rng.prng_key(5), tier="mega"), tmp_path)
    assert read(ctx) is None
