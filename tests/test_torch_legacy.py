"""Legacy-Ks scenes in the PyTorch port against the JAX package: the RGB
shadow (``transmittance_rgb``, ``shadow_factor``), PT's split tier, BDPT's
RGB connections and PPM, on ``OCCLUDER_SCENE`` (two refractive occluders
and an opaque one, ``tests/test_legacy_transmittance.py``) and on cornell
with a ``K`` record on its glass sphere's material, built inline from
``scenes/cornell.txt``.  Both packages read the same tables
(``scene_from_jax_arrays``); the JAX package runs its XLA route, the only
one it has for these scenes.  Bars, each with its reason:

- the RGB transmittance and ``shadow_factor``: rtol 1e-6 / atol 1e-7 (a
  product of one to three factors of ``1 - (1 - Ks)`` each, multiplied in
  another order: a few float32 ulps);
- RGB connection sums on the same eye vertices: max-channel relative
  error < 1e-3 on every active lane (``tests/test_torch_bdpt.py``'s bar
  for ``_connect``);
- renders: mean within 1e-3 and >= 99% of pixels within rtol 1e-4 / atol
  1e-5 (BDPT; PPM: the pass bar of ``tests/test_torch_ppm.py``, rtol 1e-3
  / atol 1e-5); PT against the JAX package's XLA tier, whose bounce rounds
  its BSDF arithmetic an ulp apart from the port's (which rounds as the
  Pallas bounce does): the mean bar and >= 95% of pixels, the bar
  ``tests/test_torch_pt.py`` holds cornell's PT to against that tier;
- PPM casts no shadow rays: the image of cornell with the ``K`` record is
  the image without it, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import bdpt as jb
from path_tracing_tpu.integrators.pt import render_pt as j_render_pt
from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import parser as jparser
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
from path_tracing_tpu_torch.ops import _kernels, cuda_connect, rng
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops import intersect as TI
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene.types import Material, scene_from_jax_arrays

from test_legacy_transmittance import OCCLUDER_SCENE
from test_torch_scene import CORNELL, jax_arrays

W = H = 16
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)
GLASS = "M 1 1 1 0.0 0.0 1.5     // glass\n"
KS = (0.9, 0.6, 0.3)


def legacy_cornell_text() -> str:
    """cornell with a K record on its glass sphere's material: that sphere
    multiplies its Ks into shadow rays; every other occluder blocks."""
    txt = CORNELL.read_text()
    assert GLASS in txt
    return txt.replace(GLASS, GLASS + "K %g %g %g 1.5\n" % KS)


def _scenes(txt: str, w=W, h=H):
    p = jparser.parse_scene_text(txt)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    return js, jc, ts, tc


@pytest.fixture(scope="module")
def cornell_k():
    return _scenes(legacy_cornell_text())


def _segments(name, n=4096):
    rs = np.random.RandomState(3)
    if name == "occluder":
        p1 = rs.uniform([-1.0, -1.0, -1.0], [1.0, 1.0, 10.0], (n, 3))
        p2 = rs.uniform([-1.0, -1.0, -1.0], [1.0, 1.0, 10.0], (n, 3))
    else:
        p1 = rs.uniform(-0.95, 0.95, (n, 3))
        p2 = rs.uniform(-0.95, 0.95, (n, 3))
    return p1.astype(np.float32), p2.astype(np.float32)


@pytest.mark.parametrize("name", ["occluder", "cornell_k"])
def test_transmittance_rgb_plain_matches_jax(name, cornell_k):
    """The plain RGB shadow on packed tables against the JAX package's
    ``transmittance_rgb``, every lane and then the live ones (the others
    1), and its walk model's counts bounded by the brute force's tests."""
    js, _, ts, _ = (_scenes(OCCLUDER_SCENE) if name == "occluder"
                    else cornell_k)
    p1, p2 = _segments(name)
    ref = np.asarray(JI.transmittance_rgb(js, jnp.asarray(p1),
                                          jnp.asarray(p2)))
    pk = pack_scene(ts)
    assert pk.legacy.shape == (pk.ns + pk.nt, 4)
    srd, _, md = TI.shadow_ray(torch.from_numpy(p1), torch.from_numpy(p2))
    got = CI.transmittance_rgb_plain(pk, torch.from_numpy(p1), srd, md)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    # every kind of verdict occurs: clear, tinted and blocked
    tinted = ((ref > 0) & (ref < 1)).any(axis=1)
    assert tinted.mean() > 0.01 and (ref == 1).all(axis=1).mean() > 0.05
    assert (ref == 0).all(axis=1).mean() > 0.05
    live = torch.from_numpy(np.random.RandomState(4).uniform(size=len(p1))
                            < 0.4)
    counts = cuda_connect.new_counts()
    part = CI.transmittance_rgb(pk, torch.from_numpy(p1), srd, md, live)
    again = CI.transmittance_rgb_plain(pk, torch.from_numpy(p1), srd, md,
                                       live, counts=counts)
    assert torch.equal(part, again)
    np.testing.assert_array_equal(part.numpy()[~live.numpy()], 1.0)
    np.testing.assert_allclose(part.numpy()[live.numpy()],
                               ref[live.numpy()], rtol=1e-6, atol=1e-7)
    n = int(live.sum())
    assert counts["shadow_spheres"] == n * pk.ns
    assert 0 < counts["shadow_tris"] <= n * pk.nt
    assert counts["shadow_boxes"] > 0


def test_rgb_walk_model_stops_where_every_component_is_zero():
    """The walk model counts every triangle of an entered cluster up to
    the one after which the factor is 0 in all three components: a
    segment through the opaque sphere tests no triangle, one that reaches
    only the refractive triangle tests it."""
    _, _, ts, _ = _scenes(OCCLUDER_SCENE)
    pk = pack_scene(ts)
    p1 = torch.tensor([[0.0, 0.0, 4.5], [0.0, 0.0, 7.0]])
    p2 = torch.tensor([[0.0, 0.0, 9.0], [0.0, 0.0, 9.0]])
    srd, _, md = TI.shadow_ray(p1, p2)
    for lane, tris in ((0, 0), (1, 1)):
        counts = cuda_connect.new_counts()
        tr = CI.transmittance_rgb_plain(pk, p1[lane:lane + 1],
                                        srd[lane:lane + 1],
                                        md[lane:lane + 1], counts=counts)
        assert counts["shadow_tris"] == tris, (lane, counts)
        assert (tr == 0).all() if lane == 0 else (tr > 0).all()


def test_shadow_factor_matches_jax(cornell_k):
    """``shadow_factor`` on legacy cornell: RGB under the GPU rule, the
    binary transmittance broadcast under the oracle's, as the JAX
    function does; a scene without legacy rows stays binary."""
    js, _, ts, _ = cornell_k
    p1, p2 = _segments("cornell_k", 1024)
    for rule in (True, False):
        a = np.asarray(JI.shadow_factor(js, jnp.asarray(p1), jnp.asarray(p2),
                                        dielectrics_block=rule))
        b = TI.shadow_factor(ts, torch.from_numpy(p1), torch.from_numpy(p2),
                             dielectrics_block=rule).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        tinted = ((b > 0) & (b < 1)).any(axis=1).mean()
        assert tinted > 0 if rule else tinted == 0


def test_tiers_route_legacy_scenes(cornell_k):
    """PT: auto is split (textured or not), mega, fused and stream raise;
    BDPT: auto is fused, mega raises; PPM: auto is mega."""
    _, _, ts, _ = cornell_k
    assert ts.has_legacy_ks
    assert pt.resolve_tier(ts, "auto") == "split"
    assert pt.resolve_tier(ts, "plain") == "plain"
    for t in ("mega", "fused", "stream"):
        with pytest.raises(ValueError, match="legacy"):
            pt.resolve_tier(ts, t)
    cfg = RenderConfig(**CFG)
    assert bdpt.resolve_tier(ts, "auto", cfg) == "fused"
    with pytest.raises(ValueError, match="mega"):
        bdpt.resolve_tier(ts, "mega", cfg)
    assert ppm.resolve_tier(ts, "auto") == "mega"


def _bar(a, b, pixel_share, rtol=1e-4, atol=1e-5):
    assert np.isfinite(b).all() and b.mean() > 0
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 1e-3
    close = np.isclose(a, b, rtol=rtol, atol=atol).all(axis=1)
    assert close.mean() >= pixel_share, close.mean()


def test_pt_legacy_render_matches_jax(cornell_k):
    """PT on legacy cornell at 16x16 spp 2: the split tier (the nearest-hit
    wrapper and the RGB shadow around the PyTorch bounce; on the CPU their
    plain versions) and the plain tier against the JAX package's XLA
    route; the two tiers equal, and the glass sphere's tint moves the
    image away from cornell's."""
    js, jc, ts, tc = cornell_k
    key = rng.prng_key(0)
    _kernels.reset_counts()
    a = pt.render_pt(ts, tc, W, H, 2, RenderConfig(**CFG), key).numpy()
    assert _kernels.plain_calls["transmittance_rgb"] > 0
    assert _kernels.plain_calls["any_blocker"] == 0
    b = pt.render_pt(ts, tc, W, H, 2, RenderConfig(**CFG), key,
                     tier="plain").numpy()
    np.testing.assert_array_equal(a, b)
    ref = np.asarray(j_render_pt(js, jc, W, H, 2, JConfig(**CFG),
                                 jax.random.PRNGKey(0)))
    _bar(ref, a, 0.95)
    _, _, ps, pc = _scenes(CORNELL.read_text())
    plain_img = pt.render_pt(ps, pc, W, H, 2, RenderConfig(**CFG),
                             key).numpy()
    assert not np.array_equal(plain_img, a)


def test_bdpt_legacy_render_matches_jax(cornell_k):
    """BDPT on legacy cornell at 16x16 spp 2, spl 2 in the auto tier
    (fused: #8's RGB instance; on the CPU its plain version, the plain
    tier's code) against the JAX package's XLA eye pass, whose
    ``_connect`` takes the RGB ``shadow_factor``."""
    js, jc, ts, tc = cornell_k
    _kernels.reset_counts()
    img = bdpt.render_bdpt(ts, tc, W, H, 2, 2, RenderConfig(**CFG),
                           rng.prng_key(1)).numpy()
    assert _kernels.plain_calls["transmittance_rgb"] > 0
    ref = np.asarray(jb.render_bdpt(js, jc, W, H, 2, 2, JConfig(**CFG),
                                    jax.random.PRNGKey(1)))
    _bar(ref, img, 0.99)


def test_connect_rgb_plain_matches_jax(cornell_k):
    """RGB ``connect_plain`` against the JAX package's ``_connect`` on the
    primary hits of a 16x16 frame of legacy cornell, against the exact
    table of a light trace carried across."""
    from path_tracing_tpu.ops.math3 import normalize

    js, jc, ts, tc = cornell_k
    cfg = JConfig(**CFG)
    lv = jb.trace_light_paths(js.with_illum_scaled(0.5), cfg,
                              js.num_lights * 4, 2, jax.random.PRNGKey(3))
    lv_flat, nv = jb.compact_flat(lv.flat())
    nv = int(nv)
    B = W * H
    idx = jnp.arange(B, dtype=jnp.int32)
    rs = np.random.RandomState(7)
    jx, jy = rs.uniform(0, 1, (2, B)).astype(np.float32)
    rd = jcamera.primary_ray_dirs(jc, idx % W, idx // W, jnp.asarray(jx),
                                  jnp.asarray(jy))
    ro = jnp.broadcast_to(jc.eye, (B, 3))
    hit = JI.find_closest_hit(js, ro, rd)
    act = np.asarray(hit.hit & ~hit.is_light)
    wo_s = normalize(jc.eye[None] - hit.pos)
    g = np.abs(rs.normal(size=B)).astype(np.float32)
    eye_f = jnp.where(hit.mtl.eta > 0.0, 0.0, 1e8 * (1.0 + jnp.asarray(g)))
    tp = jnp.asarray(rs.uniform(0.2, 1.0, (B, 3)).astype(np.float32))
    ref = np.asarray(jb._connect(js, cfg, lv_flat, nv, hit.pos, hit.normal,
                                 tp, hit.mtl, -rd, wo_s, eye_f, 64))
    # the JAX table's rows, carried across
    from path_tracing_tpu.ops.pallas_connect import pack_light_vertices

    def t(x):
        return torch.from_numpy(np.array(x))

    tab = t(pack_light_vertices(lv_flat))
    m = Material(*(t(getattr(hit.mtl, f)) for f in
                   ("base_color", "roughness", "metallic", "eta")))
    _kernels.reset_counts()
    got = cuda_connect.connect_plain(
        pack_scene(ts), tab, nv, t(hit.pos), t(hit.normal), t(tp), m,
        t(-rd), t(wo_s), t(eye_f), t(act), clamp_val=15.0,
        dielectrics_block=True).numpy()
    assert _kernels.plain_calls["transmittance_rgb"] > 0
    assert act.mean() > 0.9 and np.abs(got[act]).sum() > 0
    assert (got[~act] == 0).all()
    rel = np.abs(got - ref)[act] / (np.abs(ref[act]) + 1e-3)
    assert (rel.max(axis=1) < 1e-3).all(), rel.max()


def test_ppm_legacy_pass_matches_jax_and_ignores_the_record(cornell_k,
                                                           monkeypatch):
    """A PPM pass of legacy cornell at 16x16 (1,024 photons a light)
    against the JAX package's XLA route with its exact gather (interpret
    mode), and bit-equal to the pass of cornell without the record."""
    from test_torch_ppm import _jax_pass

    js, jc, ts, tc = cornell_k
    cfg = dict(width=W, height=H, spl=1024, ppm_max_cells=1024)
    key = rng.fold_in(rng.prng_key(0), 0)
    a = ppm.render_ppm(ts, tc, W, H, 1024, RenderConfig(**cfg), key).numpy()
    _, _, ps, pc = _scenes(CORNELL.read_text())
    b = ppm.render_ppm(ps, pc, W, H, 1024, RenderConfig(**cfg), key).numpy()
    np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("PT_TPU_NO_PHOTON_MEGA", "1")
    monkeypatch.setenv("PT_TPU_PPM_EVCHUNK", "128")
    jax.clear_caches()
    try:
        ref, _, overflow = _jax_pass(
            js, jc, JConfig(**cfg),
            jax.random.fold_in(jax.random.PRNGKey(0), 0), 1.0)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    assert overflow == 0
    _bar(ref, a, 0.99, rtol=1e-3)
