"""The three integrators on meshes above the resident ceiling in the
PyTorch port against the JAX package's big-mesh route.

The mesh is the 1,280-triangle icosphere, with the port's
``MAX_RESIDENT_TRIS`` lowered to 512 so that it stands above the ceiling,
and its tables carried across with ``scene_from_jax_arrays``.  The JAX
package takes its big-mesh route with ``PT_TPU_INTERPRET=1``,
``PT_TPU_MAX_VMEM_TRIS=512`` and ``PT_TPU_PPM_EVCHUNK=128`` (its caches
cleared around every change): it finds hits through its streamed kernels
#6/#7 on sorted rays in interpret mode, traces photons with its XLA scan
and gathers with the exact Pallas gather in interpret mode.  The port
keeps its resident route there: PT auto is the megakernel's tier (the
fused one for a textured mesh), BDPT the mega and fused tiers, PPM the
photon-trace and gather kernels' tier; on the CPU each runs its kernels'
plain versions.  Bars, each the one the same render meets on cornell
(none loosened for the big mesh):

- PT: ``tests/test_torch_stream.py``'s (mean within 1e-3, >= 99% of
  pixels within rtol 1e-4 / atol 1e-5): the same Threefry draws, hits
  equal up to the last ulp of two frameworks;
- BDPT: ``tests/test_torch_bdpt.py``'s (mean within 1e-3, >= 97% of pixels
  with every channel within 1e-3 relative): the 1e8 eye-side MIS
  prefactor lets a branch taken the other way move a whole pixel;
- PPM: ``tests/test_torch_ppm.py``'s for a whole pass (image within rtol
  1e-3 / atol 1e-5 on >= 99% of pixels, mean within 1e-3 relative,
  overflow equal, photon counts equal on >= 99% of hitpoints): XLA's CPU
  rounding along a chain sits an ulp from torch's.
"""
import jax
import numpy as np
import pytest

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import bdpt as jbdpt
from path_tracing_tpu.integrators import ppm as jppm
from path_tracing_tpu.integrators.pt import render_pt as j_render_pt
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import synth as jsynth
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
from path_tracing_tpu_torch.ops import _kernels, rng
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene import types as scene_types
from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

from test_torch_bdpt import _render_bar
from test_torch_scene import jax_arrays

CEILING = 512
MESH_TRIS = 1280


@pytest.fixture()
def big_route(monkeypatch):
    """The port's ceiling lowered below the mesh, and a function that
    runs a JAX call on the JAX package's big-mesh route."""
    monkeypatch.setattr(scene_types, "MAX_RESIDENT_TRIS", CEILING)

    def on_jax_route(fn, **env):
        with monkeypatch.context() as m:
            for k, v in dict(PT_TPU_INTERPRET="1",
                             PT_TPU_MAX_VMEM_TRIS=str(CEILING),
                             PT_TPU_PPM_EVCHUNK="128", **env).items():
                m.setenv(k, v)
            jax.clear_caches()
            try:
                return fn()
            finally:
                jax.clear_caches()

    return on_jax_route


def _mesh(w, h, textured=False):
    p = jsynth.icosphere_scene(MESH_TRIS, textured=textured)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    assert ts.num_triangles == MESH_TRIS > CEILING
    return js, jc, ts, tc


# ---- PT: auto keeps the resident tiers ----

PT_W, PT_H, PT_SPP = 48, 36, 2
PT_CFG = dict(width=PT_W, height=PT_H, eye_depth=3, light_depth=3,
              delta_budget=3)


@pytest.mark.parametrize("textured", [False, True])
def test_pt_auto_above_the_ceiling_matches_jax_stream_route(textured,
                                                            big_route):
    js, jc, ts, tc = _mesh(PT_W, PT_H, textured)
    tier = pt.resolve_tier(ts, "auto")
    assert tier == ("fused" if textured else "mega")
    _kernels.reset_counts()
    img = pt.render_pt(ts, tc, PT_W, PT_H, PT_SPP, RenderConfig(**PT_CFG),
                       rng.prng_key(0)).numpy()
    calls = dict(_kernels.plain_calls)
    assert calls["nearest_hit_stream"] == calls["any_blocker_stream"] == 0
    assert calls["shade_step_tex" if textured else "render_wavefront"] > 0
    ref = np.asarray(big_route(lambda: j_render_pt(
        js, jc, PT_W, PT_H, PT_SPP, JConfig(**PT_CFG),
        jax.random.PRNGKey(0))))
    assert np.isfinite(img).all() and (img.sum(axis=1) > 0).mean() > 0.01
    assert abs(ref.mean() - img.mean()) / max(ref.mean(), 1e-6) < 1e-3
    close = np.isclose(ref, img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()


# ---- BDPT: mega (#9) and fused (#1 + #8) on the resident walk ----

BD_W = BD_H = 16
BD_SPL = 4
BD_CFG = dict(width=BD_W, height=BD_H, eye_depth=3, light_depth=3,
              delta_budget=3)


@pytest.fixture(scope="module")
def jax_bdpt_big():
    """The JAX package's BDPT frame on its big-mesh route (its per-bounce
    tier), rendered once for both port tiers."""
    js, jc, _, _ = _mesh(BD_W, BD_H)
    env = dict(PT_TPU_INTERPRET="1", PT_TPU_MAX_VMEM_TRIS=str(CEILING),
               PT_TPU_NO_BDPT_MEGAKERNEL="1")
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    jax.clear_caches()
    try:
        return np.asarray(jbdpt.render_bdpt(
            js, jc, BD_W, BD_H, 2, BD_SPL, JConfig(**BD_CFG),
            jax.random.PRNGKey(0)))
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.mark.parametrize("tier", ["auto", "fused"])
def test_bdpt_above_the_ceiling_matches_jax_route(tier, jax_bdpt_big,
                                                  big_route):
    _, _, ts, tc = _mesh(BD_W, BD_H)
    cfg = RenderConfig(**BD_CFG)
    assert bdpt.resolve_tier(ts, tier, cfg) == ("mega" if tier == "auto"
                                                else "fused")
    _kernels.reset_counts()
    img = bdpt.render_bdpt(ts, tc, BD_W, BD_H, 2, BD_SPL, cfg,
                           rng.prng_key(0), tier=tier).numpy()
    calls = dict(_kernels.plain_calls)
    assert calls["bdpt_eye" if tier == "auto" else "connect"] > 0
    assert calls["nearest_hit_stream"] == 0
    assert img.mean() > 0.0
    _render_bar(jax_bdpt_big, img)


# ---- PPM: the gate is lifted ----

PP_W, PP_H, PP_SPL = 32, 24, 4096     # one light: 4,096 photons a pass


def test_ppm_resolve_tier_above_the_ceiling(big_route):
    _, _, ts, _ = _mesh(4, 4)
    assert ppm.resolve_tier(ts, "auto") == "mega"
    for t in ("mega", "plain"):
        assert ppm.resolve_tier(ts, t) == t
    # a textured big mesh takes the same route (#10's textured instance)
    tex = synth.icosphere_scene(MESH_TRIS, textured=True).to_device("cpu")
    assert tex.has_textures
    assert ppm.resolve_tier(tex, "auto") == "mega"


@pytest.mark.parametrize("pass_index", [0, 1])
def test_ppm_pass_above_the_ceiling_matches_jax_route(pass_index, big_route):
    """Passes 0 and 1 at alpha 0.5, the JAX side on its stream route with
    its XLA photon scan and its exact gather in interpret mode."""
    js, jc, ts, tc = _mesh(PP_W, PP_H)
    cfg = dict(width=PP_W, height=PP_H, spl=PP_SPL, ppm_alpha=0.5,
               ppm_max_cells=1024)
    scale = ppm.ppm_radius_scale(pass_index, 0.5)
    a, ca, oa = big_route(lambda: tuple(np.asarray(x) for x in
                                        jppm.render_ppm_with_stats(
        js, jc, PP_W, PP_H, PP_SPL, JConfig(**cfg),
        jax.random.fold_in(jax.random.PRNGKey(0), pass_index), scale)))
    _kernels.reset_counts()
    b, cb, ob = ppm.render_ppm_with_stats(
        ts, tc, PP_W, PP_H, PP_SPL, RenderConfig(**cfg),
        rng.fold_in(rng.prng_key(0), pass_index), scale)
    assert _kernels.plain_calls["photon_trace"] == 1
    assert _kernels.plain_calls["gather_flux"] == 1
    b = b.numpy()
    assert int(oa) == int(ob) == 0
    assert np.isfinite(b).all() and b.mean() > 0.0
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-3
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert (ca == cb.numpy()).mean() >= 0.99


def test_cli_renders_all_three_modes_above_the_ceiling(tmp_path,
                                                       big_route):
    """Through the CLI on the CPU, a mesh above the (lowered) ceiling:
    PT auto picks mega, BDPT mega, PPM mega; none raises."""
    obj = synth.write_obj(synth.icosphere_scene(MESH_TRIS),
                          str(tmp_path / "ico.obj"))
    for mode, extra in (("pt", []), ("bdpt", ["--spl", "2"]),
                        ("ppm", ["--spl", "4096"])):
        res = cli.run(["--input", obj, "--mode", mode, "--spp", "1",
                       "--width", "16", "--height", "12", "--device", "cpu",
                       "--output", str(tmp_path / f"{mode}.png"), *extra])
        assert res["tier"] == "mega", (mode, res["tier"])
        assert np.isfinite(res["image"]).all() and res["image"].mean() > 0
