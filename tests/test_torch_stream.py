"""PT on meshes above the resident ceiling in the PyTorch port against the
JAX package: the streamed layout and the super table, the ray sort, the
streamed nearest hit (#6) with its resolver, the streamed any-blocker (#7),
the tier choice and the ``stream`` tier end to end.

The JAX side runs its streaming kernels in interpret mode
(``force_stream=True``), as ``tests/test_mesh.py`` and
``tests/test_compaction.py`` run them; its tables are carried across with
``scene_from_jax_arrays``, rays drawn from a numpy seed.  Bars: layout and
super tables equal (the normal columns within rtol 1e-6: XLA's CPU backend
contracts a product of each ``jnp.cross`` component into an FMA, ROADMAP
queue 3; on degenerate triangles it leaves a residue that normalizes to a
unit vector where the port's cross is exactly zero; such a triangle is
never hit); sort keys bit-equal; hits: flags equal on >= 99.9% of rays, t
within rtol 1e-5 on >= 99.9%, the resolved fields within atol 1e-5 on
matching lanes; blocker verdicts equal on >= 99.9%; renders as
tests/test_torch_pt.py (mean within 1e-3, >= 99% of pixels within rtol
1e-4 / atol 1e-5)."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators.pt import render_pt as j_render_pt
from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu.ops import pallas_intersect as PI
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import synth as jsynth
from path_tracing_tpu.scene.obj_loader import load_any_scene as j_load_any
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators.pt import render_pt, resolve_tier
from path_tracing_tpu_torch.ops import _kernels, rng
from path_tracing_tpu_torch.ops import cuda_stream as CS
from path_tracing_tpu_torch.ops import intersect as TI
from path_tracing_tpu_torch.scene import obj_loader, synth
from path_tracing_tpu_torch.scene import types as scene_types
from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

from conftest import make_textured_quad_obj
from test_torch_scene import jax_arrays

SPHERE_OBJ = Path(__file__).resolve().parent / "fixtures" / "sphere.obj"
LEAVES = [None, 640, 96, 32]
HIT_FIELDS = ("nx", "ny", "nz", "bcr", "bcg", "bcb", "rough", "metal", "eta")


def _carry(js):
    return scene_from_jax_arrays(jax_arrays(js), "cpu")[0]


def _sphere(leaf):
    p = j_load_any(str(SPHERE_OBJ))
    js = p.to_device(cluster_leaf_size=leaf) if leaf else p.to_device()
    return js, _carry(js)


def _rays(n=512, seed=5, lo=-0.8, hi=0.8):
    """Origins in a box around the mesh; half the rays aimed near its
    centre, half in random directions."""
    rs = np.random.default_rng(seed)
    ro = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    aim = -ro + rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    rd[::2] = aim[::2]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the layout and the super table
# ---------------------------------------------------------------------------

def _assert_layout_equal(js, ts):
    (sph, _, _, _, dest, Tp, attr, vert, cl,
     blk) = PI._stream_layout(js)
    lay = CS.stream_layout(ts)
    st = CS.pack_scene_stream(ts)
    np.testing.assert_array_equal(np.asarray(dest), lay["dest"].numpy())
    assert Tp == lay["Tp"] == st.tri.shape[0]
    np.testing.assert_array_equal(np.asarray(sph), st.sph.numpy())
    np.testing.assert_array_equal(np.asarray(vert), lay["vert"].numpy())
    np.testing.assert_array_equal(np.asarray(blk), lay["blk"].numpy())
    np.testing.assert_array_equal(np.asarray(cl), lay["cl"].numpy())
    a, b = np.asarray(attr), lay["attr"].numpy()
    np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
    degenerate = ~b[:, :3].any(axis=1)
    np.testing.assert_allclose(a[~degenerate, :3], b[~degenerate, :3],
                               rtol=1e-6, atol=1e-7)
    # the slot rows [v0 e1 e2 can_block] under both blocking rules
    for rule, col in ((True, 9), (False, 10)):
        v = np.asarray(PI.pack_scene_stream_vpu(js, dielectrics_block=rule)[1])
        slots = v[:Tp // PI.VPU_TPR].reshape(Tp, PI.VPU_SLOT)
        np.testing.assert_array_equal(slots[:, :9], st.tri.numpy()[:, :9])
        np.testing.assert_array_equal(slots[:, 9], st.tri.numpy()[:, col])
    jcl, jsup, juse = PI.super_table(cl)
    pcl, psup, puse = CS.super_table(lay["cl"])
    assert juse == puse == st.use_super
    np.testing.assert_array_equal(np.asarray(jcl), pcl.numpy())
    np.testing.assert_array_equal(np.asarray(jsup), psup.numpy())
    np.testing.assert_array_equal(np.asarray(jcl), st.cl.numpy()[:, :jcl.shape[1]])
    return juse


@pytest.mark.parametrize("leaf", LEAVES)
def test_stream_layout_and_super_table_match_jax(leaf):
    """Leaf 640 spans several of the TPU's DMA windows, 96 gives odd
    block counts, 32 and the default (64 clusters) turn the super walk
    on."""
    js, ts = _sphere(leaf)
    use_super = _assert_layout_equal(js, ts)
    assert use_super == (leaf in (None, 32))


def test_super_table_matches_jax_on_icosphere_17000():
    js = jsynth.icosphere_scene(17000).to_device()
    assert _assert_layout_equal(js, _carry(js))


# ---------------------------------------------------------------------------
# the ray sort
# ---------------------------------------------------------------------------

def test_coherence_key_matches_jax():
    js, ts = _sphere(None)
    ro, rd = _rays(4096, 1, -3.0, 3.0)       # some origins outside the AABB
    rd[:7, 0] = 0.0                           # +0 counts as non-negative
    a = np.asarray(JI._coherence_key(js, jnp.asarray(ro), jnp.asarray(rd)))
    b = TI.coherence_key(ts.scene_min, ts.scene_max, _t(ro), _t(rd))
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(a, b.numpy())
    assert len(np.unique(a)) > 100


def test_sorted_call_with_live_lanes():
    """With ``live`` the results equal the unsorted call on the live lanes
    and the dead lanes report a miss / unblocked; the kernels' plain
    versions see the dead lanes last (``n_live`` = the live count)."""
    _, ts = _sphere(32)
    st = CS.pack_scene_stream(ts)
    ro, rd = (_t(x) for x in _rays(1000, 2))
    live = _t(np.random.default_rng(3).uniform(size=1000) < 0.5)
    t0, i0, k0 = CS.nearest_hit_stream(st, ro, rd)
    seen = {}

    def fn(a, b, n_live):
        seen["n_live"] = int(n_live[0])
        return CS.nearest_hit_stream(st, a, b, n_live)

    t1, i1, k1 = TI.sorted_call(st.bounds, ro, rd, fn, live=live)
    assert seen["n_live"] == int(live.sum())
    for x, y in ((t0, t1), (i0, i1), (k0, k1)):
        assert torch.equal(x[live], y[live])
    assert (t1[~live] == TI.INF).all() and (i1[~live] == -1).all()
    assert (k1[~live] == 0).all() and (k0[live] > 0).any()

    md = torch.full((1000,), 1.5)
    b0 = CS.any_blocker_stream(st, ro, rd, md, True)
    b1 = CS.stream_blocked(st, ro, rd, md, True, live=live)
    assert torch.equal(b0[live], b1[live]) and not b1[~live].any()
    assert b0[live].any()
    # without live every lane is worked, in lane order on return
    h = CS.stream_hit(st, ro, rd)
    assert torch.equal(h["t"], t0)


# ---------------------------------------------------------------------------
# #6 and #7 against the JAX streaming kernels
# ---------------------------------------------------------------------------

def _assert_hits_match(a, b, with_uv=False, share=0.999):
    a = {k: np.asarray(v) for k, v in a.items()}
    b = {k: v.numpy() for k, v in b.items()}
    same_flag = a["flag"] == b["flag"]
    same_t = np.isclose(a["t"], b["t"], rtol=1e-5)
    assert same_flag.mean() >= share and same_t.mean() >= share
    m = same_flag & same_t & (b["flag"] > 0)
    assert m.sum() > 50
    for k in HIT_FIELDS + (("iu", "iv", "tex") if with_uv else ()):
        np.testing.assert_allclose(a[k][m], b[k][m], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("leaf", LEAVES)
def test_nearest_hit_stream_matches_jax(leaf):
    js, ts = _sphere(leaf)
    st = CS.pack_scene_stream(ts)
    ro, rd = _rays()
    a = PI.nearest_hit_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                              force_stream=True, interpret=True)
    t, idx, kind = CS.nearest_hit_stream(st, _t(ro), _t(rd))
    assert set(kind.unique().tolist()) <= {0, 1, 2, 3}
    assert (idx[kind == 0] == -1).all() and (idx[kind == 3] >= 0).all()
    b = CS.resolve_stream_attrs(st, t, idx, kind, _t(ro), _t(rd))
    _assert_hits_match(a, b)


@pytest.mark.parametrize("leaf", LEAVES)
def test_any_blocker_stream_matches_jax(leaf):
    js, ts = _sphere(leaf)
    st = CS.pack_scene_stream(ts)
    ro, rd = _rays(seed=6)
    md = np.random.default_rng(7).uniform(0.05, 1.5, 512).astype(np.float32)
    for rule in (True, False):
        a = np.asarray(PI.any_blocker_pallas(
            js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(md), rule,
            force_stream=True, interpret=True))
        b = CS.any_blocker_stream(st, _t(ro), _t(rd), _t(md), rule).numpy()
        assert (a == b).mean() >= 0.999
        assert 0.05 < b.mean() < 0.95


@pytest.mark.parametrize("which", ["textured_quad", "icosphere_1280"])
def test_nearest_hit_stream_with_uv_matches_jax(which, tmp_path,
                                                monkeypatch):
    if which == "textured_quad":
        monkeypatch.setenv("PT_TPU_NO_NATIVE", "1")
        js = j_load_any(make_textured_quad_obj(tmp_path)).to_device()
        uvs = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75],
                        [0.75, 0.75]], np.float32)
        ro = np.concatenate([uvs, np.full((4, 1), -1.0, np.float32)], 1)
        rd = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    else:
        js = jsynth.icosphere_scene(1280, textured=True).to_device()
        ro, rd = _rays(512, 8, -1.6, 1.6)
    ts = _carry(js)
    st = CS.pack_scene_stream(ts)
    a = PI.nearest_hit_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                              with_uv=True, force_stream=True,
                              interpret=True)
    b = CS.resolve_stream_attrs(st, *CS.nearest_hit_stream(st, _t(ro),
                                                           _t(rd)),
                                _t(ro), _t(rd), with_uv=True)
    if which == "textured_quad":
        np.testing.assert_allclose(
            torch.stack([b["iu"], b["iv"]], -1).numpy(), uvs, atol=1e-5)
        assert (b["tex"] == 0).all() and (b["flag"] == 1).all()
        np.testing.assert_allclose(np.asarray(a["iu"]), b["iu"].numpy(),
                                   atol=1e-5)
    else:
        _assert_hits_match(a, b, with_uv=True)
        assert (b["tex"][b["flag"] == 1] == 0).all()


# ---------------------------------------------------------------------------
# routing, tiers and the slice end to end
# ---------------------------------------------------------------------------

def test_stream_bounce_passes_live_lanes_to_6_and_7(monkeypatch):
    """``shade_step_stream`` hands #6 the active lanes and #7 the
    NEE-eligible ones as ``live``, and its bounce equals the split tier's
    (the resident #1/#2) on the active lanes."""
    from path_tracing_tpu_torch.ops import cuda_shade as CSH
    from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
    from path_tracing_tpu_torch.ops.intersect import hit_from_fields

    _, ts = _sphere(32)
    st, pk, lt = CS.pack_scene_stream(ts), pack_scene(ts), ts.packed.light
    assert lt.shape[0] > 0
    n = 512
    ro, rd = (_t(x) for x in _rays(n, 11))
    rs = np.random.default_rng(12)
    act = _t(rs.uniform(size=n) < 0.7)
    u = _t(rs.uniform(size=(8, n)).astype(np.float32))
    state = (ro, rd, torch.ones((n, 3)), torch.ones(n),
             torch.zeros(n, dtype=torch.int32), act,
             torch.ones(n, dtype=torch.bool), torch.ones(n))
    kw = dict(clamp_val=15.0, stub_mis=True, dielectrics_block=True)
    seen = {}

    def hit(*a, live=None, **k):
        seen["hit"] = live
        return stream_hit(*a, live=live, **k)

    def blocked(*a, live=None, **k):
        seen["blocked"] = live
        return stream_blocked(*a, live=live, **k)

    stream_hit, stream_blocked = CS.stream_hit, CS.stream_blocked
    monkeypatch.setattr(CS, "stream_hit", hit)
    monkeypatch.setattr(CS, "stream_blocked", blocked)
    out = CSH.shade_step_stream(st, lt, *state, u, **kw)
    ref = CSH.shade_step_split(pk, lt, *state, u, **kw)
    assert torch.equal(seen["hit"], act)
    h = hit_from_fields(stream_hit(st, ro, rd), ro, rd)
    m = h.mtl
    elig = (act & h.hit & ~h.is_light & (m.eta <= 0.0)
            & ((m.metallic < 0.99) | (m.roughness > 0.01)))
    assert torch.equal(seen["blocked"], elig) and elig.any() and (
        act & ~elig).any()
    for k in ("radiance", "ro", "rd", "tp"):
        close = torch.isclose(out[k], ref[k], rtol=1e-5, atol=1e-6).all(1)
        assert close[act].float().mean().item() >= 0.99, k
    assert torch.equal(out["alive"], ref["alive"])


def test_resolve_tier_picks_stream_above_the_ceiling(monkeypatch, tmp_path):
    """Above the ceiling auto keeps the resident tiers (mega, or fused for
    textured scenes), which beat the stream tier on the card; ``stream``
    is picked only when asked for, on any scene."""
    plain = synth.icosphere_scene(1280).to_device("cpu")
    tex = synth.icosphere_scene(1280, textured=True).to_device("cpu")
    assert resolve_tier(plain, "auto") == "mega"
    assert resolve_tier(tex, "auto") == "fused"
    assert resolve_tier(plain, "stream") == "stream"
    monkeypatch.setattr(scene_types, "MAX_RESIDENT_TRIS", 1024)
    assert resolve_tier(plain, "auto") == "mega"
    assert resolve_tier(tex, "auto") == "fused"
    for t in ("mega", "fused", "split", "stream", "plain"):
        assert resolve_tier(plain, t) == t
    assert resolve_tier(tex, "stream") == "stream"
    with pytest.raises(ValueError):
        resolve_tier(tex, "mega")


W, H, SPP = 48, 36, 2
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)


@pytest.mark.parametrize("textured", [False, True])
def test_stream_render_matches_jax_per_bounce_stream(textured, monkeypatch):
    """The port's ``stream`` tier (asked for; auto keeps the resident
    tiers with the ceiling lowered to 512) on
    the 1,280-triangle icosphere against the JAX package's per-bounce body
    on its stream route (``PT_TPU_MAX_VMEM_TRIS=512``, kernels in
    interpret mode): the same sorted #6/#7 calls with the same live lanes,
    the same Threefry draws."""
    p = jsynth.icosphere_scene(1280, textured=textured)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    monkeypatch.setattr(scene_types, "MAX_RESIDENT_TRIS", 512)
    assert resolve_tier(ts, "auto") == ("fused" if textured else "mega")
    _kernels.reset_counts()
    img = render_pt(ts, tc, W, H, SPP, RenderConfig(**CFG),
                    rng.prng_key(0), tier="stream").numpy()
    calls = dict(_kernels.plain_calls)
    assert calls["nearest_hit_stream"] > 0 and calls["any_blocker_stream"] > 0
    assert calls["nearest_hit"] == calls["shade_step_tex"] == 0
    monkeypatch.setenv("PT_TPU_INTERPRET", "1")
    monkeypatch.setenv("PT_TPU_MAX_VMEM_TRIS", "512")
    jax.clear_caches()
    try:
        ref = np.asarray(j_render_pt(js, jc, W, H, SPP, JConfig(**CFG),
                                     jax.random.PRNGKey(0)))
    finally:
        jax.clear_caches()
    assert np.isfinite(img).all() and (img.sum(axis=1) > 0).mean() > 0.01
    assert abs(ref.mean() - img.mean()) / max(ref.mean(), 1e-6) < 1e-3
    close = np.isclose(ref, img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()


def test_cli_stream_tier_on_cpu(tmp_path, capsys, monkeypatch):
    """``--tier stream`` renders through the plain versions on the CPU;
    above the ceiling auto keeps the megakernel's tier."""
    out = tmp_path / "s.png"
    argv = ["--input", str(SPHERE_OBJ), "--spp", "1", "--width", "8",
            "--height", "6", "--device", "cpu", "--output", str(out)]
    res = cli.run(argv + ["--tier", "stream"])
    assert res["tier"] == "stream" and out.exists()
    assert np.isfinite(res["image"]).all() and res["image"].mean() > 0
    assert "(stream tier)" in capsys.readouterr().out
    monkeypatch.setattr(scene_types, "MAX_RESIDENT_TRIS", 1000)
    assert cli.run(argv)["tier"] == "mega"
    ts = obj_loader.load_any_scene(str(SPHERE_OBJ)).to_device("cpu")
    assert ts.num_triangles == 2304
