"""Textured scenes in BDPT and PPM of the PyTorch port against the JAX
package, on the 1,280-triangle textured icosphere (its checker atlas):
``find_closest_hit`` (which textures its hit, as the JAX function does)
on the icosphere alone, then the BDPT light trace and render and the PPM
eye pass, photon trace and pass with the icosphere (radius 0.35) in
cornell's room, where light bounces off the textured sphere onto the
walls and back.  Both packages read the same tables (``scene_from_jax_arrays``); the
JAX package runs its XLA route (``find_closest_hit`` with the texel, and
its XLA photon scan, ``PT_TPU_NO_PHOTON_MEGA=1``: its photon megakernel
has no texture code).  Bars, each with its reason:

- ``find_closest_hit``: hit and light flags equal on every ray; t within
  rtol 1e-5 on >= 99.95% of hits (``tests/test_torch_intersect.py``); the
  base color within rtol 1e-6 on >= 97% of hits and within rtol 1e-3 on
  all: the JAX function recomputes the winner's barycentrics in its own
  order, and a UV one ulp apart moves a bilinear fetch that straddles a
  checker edge by the edge's step times the texture's width (measured:
  97.6% within 1e-6, at most 1.2e-4 relative, on 4,096 camera and
  interior rays; the UVs themselves are held to the JAX package's
  ``with_uv`` kernel in ``tests/test_torch_texture.py``);
- the light trace: ``tests/test_torch_bdpt.py``'s bar (masks equal, every
  field within rtol 1e-5 / atol 1e-6 on >= 97% of valid rows and rtol
  1e-3 / atol 1e-5 on all);
- the PPM eye pass and photon trace: ``tests/test_torch_ppm.py``'s bars;
- renders: mean within 1e-3 and >= 99% of pixels within rtol 1e-4 / atol
  1e-5 (BDPT), the pass bar rtol 1e-3 / atol 1e-5 (PPM).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import bdpt as jb
from path_tracing_tpu.integrators import ppm as jppm
from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt, ppm
from path_tracing_tpu_torch.ops import _kernels, rng
from path_tracing_tpu_torch.ops import intersect as TI

from test_torch_bdpt import _np_lv
from test_torch_ppm import EV, TRACE_CFG, _jax_pass, _per_lane, _pixels, _t
from test_torch_texture import _camera_state, _jax_mesh

W = H = 16
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)
SPL = 2


@pytest.fixture(scope="module")
def mesh():
    return _jax_mesh(1280, 64, 64)


@pytest.fixture(scope="module")
def room():
    return _room(W, H)


def _room(w, h):
    """The textured icosphere at radius 0.35 on the floor of cornell's
    room (its blocks, spheres and lights), the room untextured: the JAX
    package's parse, and the same tables carried over to the port, with a
    w x h camera."""
    from path_tracing_tpu.scene import camera as jcamera
    from path_tracing_tpu.scene import parser as jparser
    from path_tracing_tpu.scene import synth as jsynth
    from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

    from test_torch_scene import CORNELL, jax_arrays

    p = jparser.load_scene(str(CORNELL))
    m = jsynth.icosphere_scene(1280, textured=True)
    n_room = len(p.tri_verts)
    tv = np.asarray(m.tri_verts, np.float32) * np.float32(0.35)
    tv = tv + np.asarray([0.0, -0.65, -0.55], np.float32)
    p.tri_verts = list(p.tri_verts) + tv.tolist()
    p.tri_mtl = list(p.tri_mtl) + list(m.tri_mtl)
    p.tri_group = list(p.tri_group) + [0] * len(tv)
    p.tri_uv = [[0.0] * 6] * n_room + list(m.tri_uv)
    p.tri_tex = [-1] * n_room + list(m.tri_tex)
    p.textures = list(m.textures)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    assert ts.has_textures and ts.num_triangles == n_room + 1280
    return js, jc, ts, tc


def _texelled(ts, bc) -> np.ndarray:
    """The rows of base colors ``bc`` that are no material's base color:
    a texel multiplied in."""
    mats = np.concatenate([ts.tri_mtl.base_color.numpy(),
                           ts.sph_mtl.base_color.numpy()])
    return ~np.isclose(bc[:, None], mats[None], rtol=0,
                       atol=1e-6).all(axis=2).any(axis=1)


@pytest.fixture()
def xla_scan(monkeypatch):
    """The JAX package's XLA photon scan and its gather's short event
    chunk, its caches cleared around the change."""
    monkeypatch.setenv("PT_TPU_NO_PHOTON_MEGA", "1")
    monkeypatch.setenv("PT_TPU_PPM_EVCHUNK", "128")
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_find_closest_hit_matches_jax(mesh):
    """The port's ``find_closest_hit`` textures its hit (the ``with_uv``
    nearest hit, then the bilinear texel in a textured triangle's base
    color) as the JAX function does; given ``live`` the other lanes get
    the miss record."""
    js, jc, ts, tc = mesh
    ro, rd = _camera_state(tc, 64, rng.prng_key(2))
    rs = np.random.RandomState(5)       # and rays from inside the sphere
    ro[:1024] = torch.from_numpy(rs.uniform(-0.5, 0.5, (1024, 3))
                                 .astype(np.float32))
    a = JI.find_closest_hit(js, jnp.asarray(ro.numpy()),
                            jnp.asarray(rd.numpy()))
    b = TI.find_closest_hit(ts, ro, rd)
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(hit, b.hit.numpy())
    # (the JAX function's light flag is its argmin's on a miss)
    np.testing.assert_array_equal(np.asarray(a.is_light)[hit],
                                  b.is_light.numpy()[hit])
    assert 0.3 < hit.mean() < 1.0
    t_ok = np.isclose(np.asarray(a.t), b.t.numpy(), rtol=1e-5)
    assert t_ok[hit].mean() >= 0.9995
    bc_a, bc_b = np.asarray(a.mtl.base_color), b.mtl.base_color.numpy()
    bc_ok = np.isclose(bc_a, bc_b, rtol=1e-6, atol=0.0).all(axis=1)
    assert bc_ok[hit].mean() >= 0.97, bc_ok[hit].mean()
    np.testing.assert_allclose(bc_b[hit], bc_a[hit], rtol=1e-3, atol=0.0)
    # the texel is there: the material's Kd is one grey, the hits are not
    assert len(np.unique(bc_b[hit].round(4), axis=0)) > 8
    live = torch.from_numpy(rs.uniform(size=ro.shape[0]) < 0.5)
    c = TI.find_closest_hit(ts, ro, rd, live=live)
    lv = live.numpy()
    assert not c.hit.numpy()[~lv].any()
    np.testing.assert_array_equal(c.mtl.base_color.numpy()[lv], bc_b[lv])
    np.testing.assert_array_equal(c.t.numpy()[lv], b.t.numpy()[lv])


def test_light_trace_textured_matches_jax(room):
    """The light trace's surface vertices carry the texel in their base
    color (``trace_light_paths`` on the textured hit)."""
    js, _, ts, _ = room
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0x0101)
    n = js.num_lights * 64
    a = _np_lv(jb.trace_light_paths(js.with_illum_scaled(1.0 / SPL),
                                    JConfig(**CFG), n, SPL, key))
    b = _np_lv(bdpt.trace_light_paths(
        ts.with_illum_scaled(1.0 / SPL), RenderConfig(**CFG), n, SPL,
        rng.fold_in(rng.prng_key(0), 0x0101)))
    np.testing.assert_array_equal(a["valid"], b["valid"])
    v = a["valid"]
    surf = v & ~a["is_light_source"]
    assert surf.sum() > 10
    assert _texelled(ts, b["mtl.base_color"][surf]).sum() > 5
    for k in a:
        x, y = a[k][v].astype(np.float64), b[k][v].astype(np.float64)
        ok = np.isclose(x, y, rtol=1e-5, atol=1e-6)
        ok = ok.all(axis=-1) if ok.ndim > 1 else ok
        assert ok.mean() >= 0.97, (k, ok.mean())
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5, err_msg=k)


def test_bdpt_textured_render_matches_jax(room):
    """BDPT at 16x16 spp 2, spl 2 in the auto tier (fused: #8 against the
    light vertices' textured base colors; on the CPU the plain tier's
    code) against the JAX package's XLA eye pass."""
    js, jc, ts, tc = room
    assert bdpt.resolve_tier(ts, "auto", RenderConfig(**CFG)) == "fused"
    _kernels.reset_counts()
    img = bdpt.render_bdpt(ts, tc, W, H, 2, SPL, RenderConfig(**CFG),
                           rng.prng_key(1)).numpy()
    assert _kernels.plain_calls["connect"] > 0
    assert _kernels.plain_calls["bdpt_eye"] == 0
    ref = np.asarray(jb.render_bdpt(js, jc, W, H, 2, SPL, JConfig(**CFG),
                                    jax.random.PRNGKey(1)))
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(ref.mean() - img.mean()) / ref.mean() < 1e-3
    close = np.isclose(ref, img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()


def test_ppm_eye_trace_textured_matches_jax():
    """The PPM eye pass's hitpoints carry the texel in their base color
    (at ``tests/test_torch_ppm.py``'s 32x24)."""
    w, h = 32, 24
    js, jc, ts, tc = _room(w, h)
    px, py = _pixels(w, h)
    cfg = dict(width=w, height=h)
    da, ha = jppm.ppm_eye_trace(js, jc, JConfig(**cfg), jnp.asarray(px),
                                jnp.asarray(py),
                                jax.random.fold_in(jax.random.PRNGKey(9), 1))
    db, hb = ppm.ppm_eye_trace(ts, tc, RenderConfig(**cfg), _t(px), _t(py),
                               rng.fold_in(rng.prng_key(9), 1))
    va, vb = np.asarray(ha.valid), hb.valid.numpy()
    assert (va == vb).mean() >= 0.99 and vb.mean() > 0.5
    both = va & vb
    np.testing.assert_allclose(db.numpy(), np.asarray(da), rtol=1e-5,
                               atol=1e-6)
    assert _texelled(ts, hb.mtl.base_color.numpy()[both]).sum() > 5
    rough_first = both & (np.asarray(ha.throughput) == 1.0).all(axis=1)
    assert rough_first.sum() > 0.3 * both.sum()
    for x, y in ((ha.pos, hb.pos), (ha.normal, hb.normal),
                 (ha.mtl.base_color, hb.mtl.base_color),
                 (ha.throughput, hb.throughput)):
        x, y = np.asarray(x), y.numpy()
        assert np.isclose(x, y, rtol=1e-5, atol=1e-6).all(
            axis=1)[rough_first].mean() >= 0.99
        assert np.isclose(x, y, rtol=1e-3, atol=1e-5).all(
            axis=1)[both].mean() >= 0.99


def test_photon_trace_textured_matches_xla_scan(room, xla_scan):
    """#10's plain version against the XLA scan, which textures its hits
    (its bounce's flux takes the texel), with ``tests/test_torch_ppm.py``'s
    bars."""
    js, _, ts, _ = room
    jkey = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    tkey = rng.fold_in(rng.prng_key(1), 2)
    P = 4096
    a = jppm.ppm_photon_trace(js, JConfig(**TRACE_CFG), P, P // 4, jkey)
    b = ppm.ppm_photon_trace(ts, RenderConfig(**TRACE_CFG), P, P // 4,
                             tkey)
    va, vb = np.asarray(a.valid), b.valid.numpy()
    assert vb.sum() > P
    assert abs(int(va.sum()) - int(vb.sum())) <= 1e-3 * va.sum()
    la, ea, na = _per_lane({f: np.asarray(getattr(a, f)) for f in EV}, va, P)
    lb, eb, nb = _per_lane({f: getattr(b, f).numpy() for f in EV}, vb, P)
    same = na == nb
    assert same.mean() >= 0.999
    ka, kb = same[la], same[lb]
    tight = np.ones(int(ka.sum()), bool)
    loose = tight.copy()
    for f in EV:
        x, y = ea[f][ka], eb[f][kb]
        tight &= np.isclose(x, y, rtol=1e-5, atol=1e-6).all(axis=1)
        loose &= np.isclose(x, y, rtol=1e-3, atol=1e-5).all(axis=1)
    assert loose.mean() >= 0.995, loose.mean()
    assert tight.mean() >= 0.9, tight.mean()
    # photons that bounced off the sphere deposit with the texel in their
    # flux: rows whose flux is none of the lights' tinted by a material
    assert (nb > 1).sum() > 100


def test_ppm_textured_pass_matches_jax(room, xla_scan):
    """One PPM pass at 16x16 (4 lights x 1,024 photons) against the JAX
    package's XLA route with its exact gather (interpret mode)."""
    js, jc, ts, tc = room
    cfg = dict(width=W, height=H, spl=1024, ppm_max_cells=1024)
    assert ppm.resolve_tier(ts, "auto") == "mega"
    a = ppm.render_ppm(ts, tc, W, H, 1024, RenderConfig(**cfg),
                       rng.fold_in(rng.prng_key(0), 0)).numpy()
    ref, _, overflow = _jax_pass(js, jc, JConfig(**cfg), jax.random.fold_in(
        jax.random.PRNGKey(0), 0), 1.0)
    assert overflow == 0
    assert np.isfinite(a).all() and a.mean() > 0
    assert abs(ref.mean() - a.mean()) / ref.mean() < 1e-3
    close = np.isclose(ref, a, rtol=1e-3, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
