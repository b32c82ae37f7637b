"""Intersection in the PyTorch port against the JAX package: the plain
nearest-hit and any-blocker sweeps (what CPU tensors run) against the JAX
XLA tier and against the Pallas kernels in interpret mode, on the same rays
and the very same scene tables.

Tolerance: t within rtol 1e-5 on at least 99.95% of rays, the bound the JAX
package puts on its own Pallas sweep against its XLA sweep (knife-edge hits
resolve differently, tests/test_pallas_interpret.py); hit/miss and
light/surface flags must agree everywhere.  Shadow verdicts are binary:
exact.  Given ``live`` (the lanes whose result is read), the plain sweeps
give the other lanes the miss record or ``False``, and the live lanes the
JAX kernels' answers at those tolerances, on cornell (the flat cluster
walk) and on the textured 17,000-triangle icosphere (512 clusters: the
super walk); the PPM eye pass and the BDPT light trace hand their alive
lanes over and render what they rendered with every lane computed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu.ops.pallas_intersect import (any_blocker_pallas,
                                                   nearest_hit_pallas)
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops import cuda_connect, cuda_shade
from path_tracing_tpu_torch.ops import intersect as TI

from test_torch_scene import jax_cornell
from test_torch_walk import _aimed_rays, _icosphere, _segments

B = 2048
MASKS = ("all", "none", "random")


@pytest.fixture(scope="module")
def scenes():
    js, _, ts, _ = jax_cornell(16, 16)
    return js, ts


def _rays(seed):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.9, 0.9, (B, 3)).astype(np.float32)
    rd = rs.normal(size=(B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _same_t(a, b):
    return np.isclose(a, b, rtol=1e-5) | ((a >= 1e19) & (b >= 1e19))


def test_find_closest_hit_matches_xla(scenes):
    js, ts = scenes
    ro, rd = _rays(0)
    h1 = JI.find_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd))
    h2 = TI.find_closest_hit(ts, torch.from_numpy(ro), torch.from_numpy(rd))
    t1, t2 = np.asarray(h1.t), h2.t.numpy()
    same = _same_t(t1, t2)
    assert same.mean() >= 0.9995
    np.testing.assert_array_equal(np.asarray(h1.hit), h2.hit.numpy())
    np.testing.assert_array_equal(np.asarray(h1.is_light),
                                  h2.is_light.numpy())
    m = np.asarray(h1.hit) & same
    assert m.mean() > 0.9
    assert np.isclose(np.asarray(h1.normal), h2.normal.numpy(),
                      atol=1e-4)[m].mean() > 0.999
    for f in ("base_color", "roughness", "metallic", "eta"):
        np.testing.assert_array_equal(np.asarray(getattr(h1.mtl, f))[m],
                                      getattr(h2.mtl, f).numpy()[m])


def test_nearest_hit_matches_pallas_interpret(scenes):
    js, ts = scenes
    ro, rd = _rays(1)
    a = nearest_hit_pallas(js, jnp.asarray(ro), jnp.asarray(rd),
                           interpret=True)
    b = CI.nearest_hit(CI.pack_scene(ts), torch.from_numpy(ro),
                       torch.from_numpy(rd))
    same = _same_t(np.asarray(a["t"]), b["t"].numpy())
    assert same.mean() >= 0.9995
    np.testing.assert_array_equal(np.asarray(a["flag"]), b["flag"].numpy())
    m = same & (b["flag"].numpy() > 0)
    for f in ("nx", "ny", "nz"):
        assert np.isclose(np.asarray(a[f]), b[f].numpy(),
                          atol=1e-4)[m].mean() > 0.999, f
    for f in ("bcr", "bcg", "bcb", "rough", "metal", "eta"):
        np.testing.assert_array_equal(np.asarray(a[f])[m], b[f].numpy()[m])


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_transmittance_matches_exactly(scenes, dielectrics_block):
    js, ts = scenes
    rs = np.random.RandomState(2)
    p1 = rs.uniform(-0.95, 0.95, (B, 3)).astype(np.float32)
    p2 = rs.uniform(-0.95, 0.95, (B, 3)).astype(np.float32)
    a = np.asarray(JI.transmittance(js, jnp.asarray(p1), jnp.asarray(p2),
                                    dielectrics_block=dielectrics_block))
    b = TI.transmittance(ts, torch.from_numpy(p1), torch.from_numpy(p2),
                         dielectrics_block).numpy()
    np.testing.assert_array_equal(a, b)
    assert 0.05 < b.mean() < 0.95          # both verdicts occur
    # and the Pallas blocker kernel (interpret mode) on the same shadow rays
    rd, _, max_d = TI.shadow_ray(torch.from_numpy(p1), torch.from_numpy(p2))
    c = np.asarray(any_blocker_pallas(
        js, jnp.asarray(p1), jnp.asarray(rd.numpy()),
        jnp.asarray(max_d.numpy()), dielectrics_block, interpret=True))
    np.testing.assert_array_equal(c, b == 0.0)


def test_wrappers_refuse_tensors_off_cpu_without_a_kernel(scenes):
    """A wrapper takes its plain version only for CPU tensors; any other
    tensor goes to the kernel path, which checks the device and raises
    instead of carrying on (meta tensors stand in for a device here)."""
    _, ts = scenes
    pk = CI.pack_scene(ts)
    ro = torch.zeros((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        CI.nearest_hit(pk, ro, ro)
    with pytest.raises(ValueError, match="CUDA"):
        CI.any_blocker(pk, ro, ro, torch.zeros(8, device="meta"), True)
    z = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_shade.shade_step(pk, torch.zeros((4, 12)), ro, ro, ro, z,
                              z.int(), z.bool(), z.bool(), z,
                              torch.zeros((8, 8), device="meta"),
                              clamp_val=15.0, stub_mis=True,
                              dielectrics_block=True)


def test_legacy_ks_scene_is_refused():
    """Once refused, a legacy-Ks scene now shades: ``shadow_factor`` under
    the GPU rule returns the JAX package's RGB transmittance (its glass
    sphere multiplies its Ks in), and under the oracle's rule the binary
    one broadcast, as the JAX function does (rtol 1e-6, atol 1e-7)."""
    from path_tracing_tpu.scene.parser import parse_scene_text as jparse
    from path_tracing_tpu_torch.scene.parser import parse_scene_text

    txt = ("E 0 0 3\nV 0 0 0 0 1 0\nF 50\nR 4 4\nM 1 1 1 0 0 1.5\n"
           "K 0.5 0.25 0.75 1\nS 0 0 0 0.5\nM 0.8 0.8 0.8 1 0 0\n"
           "S 0 0 1.5 0.25\nL 0 2 0 0 -1 0 5 5 5 60 0 0.1\n")
    sc = parse_scene_text(txt).to_device("cpu")
    js = jparse(txt).to_device()
    assert sc.has_legacy_ks
    rs = np.random.RandomState(12)
    p1 = rs.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    p2 = rs.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    p1[:3] = [[0, 0, -2], [0, 0, -2], [2, 2, 2]]
    p2[:3] = [[0, 0, 1.0], [0, 0, 3.0], [3, 3, 3]]
    for rule in (True, False):
        a = np.asarray(JI.shadow_factor(js, jnp.asarray(p1), jnp.asarray(p2),
                                        dielectrics_block=rule))
        b = TI.shadow_factor(sc, torch.from_numpy(p1), torch.from_numpy(p2),
                             dielectrics_block=rule).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        if rule:
            np.testing.assert_allclose(b[:3], [[0.5, 0.25, 0.75], [0, 0, 0],
                                               [1, 1, 1]], atol=1e-7)
            assert ((b > 0) & (b < 1)).any(axis=1).mean() > 0.05
        else:
            assert (b == b[:, :1]).all()


# ---------------------------------------------------------------------------
# a lane mask: the lanes that are not live get the miss record or False
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def walks():
    """For each walk, both packages' scene, rays and shadow segments, and
    the JAX kernels' answers on every lane (interpret mode; computed once,
    with_uv and both blocking rules): cornell (the flat walk) and the
    textured 17,000-triangle icosphere (the super walk)."""
    out = {}
    js, _, ts, _ = jax_cornell(16, 16)
    ro, rd = (torch.from_numpy(x) for x in _rays(3))
    rs = np.random.RandomState(4)
    p1, p2 = (torch.from_numpy(rs.uniform(-0.95, 0.95, (B, 3))
                               .astype(np.float32)) for _ in range(2))
    srd, _, md = TI.shadow_ray(p1, p2)
    out["flat"] = (js, ts, ro, rd, p1, srd, md)
    p, js, ts = _icosphere(textured=True)
    ro, rd = _aimed_rays(p, ts, n=512, seed=5)
    out["super"] = (js, ts, ro, rd, *_segments(ts, 512, 6))
    res = {}
    for walk, (js, ts, ro, rd, p1, srd, md) in out.items():
        pk = CI.pack_scene(ts)
        assert (pk.n_super > 0) == (walk == "super")
        hit = nearest_hit_pallas(js, jnp.asarray(ro.numpy()),
                                 jnp.asarray(rd.numpy()), with_uv=True,
                                 interpret=True)
        blocked = {rule: np.asarray(any_blocker_pallas(
            js, jnp.asarray(p1.numpy()), jnp.asarray(srd.numpy()),
            jnp.asarray(md.numpy()), rule, interpret=True))
            for rule in (True, False)}
        res[walk] = dict(pk=pk, ro=ro, rd=rd, p1=p1, srd=srd, md=md,
                         hit={k: np.asarray(v) for k, v in hit.items()},
                         blocked=blocked)
    return res


def _live(mask: str, n: int) -> torch.Tensor:
    if mask == "random":
        return torch.from_numpy(np.random.RandomState(7).uniform(size=n)
                                < 0.4)
    return torch.full((n,), mask == "all", dtype=torch.bool)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("with_uv", [False, True])
@pytest.mark.parametrize("walk", ["flat", "super"])
def test_nearest_hit_plain_with_live_matches_pallas(walks, walk, with_uv,
                                                    mask):
    w = walks[walk]
    live = _live(mask, w["ro"].shape[0])
    b = CI.nearest_hit_plain(w["pk"], w["ro"], w["rd"], with_uv, live=live)
    assert set(b) == set(CI.HIT_FIELDS + ("flag",)
                         + (CI.UV_FIELDS if with_uv else ()))
    dead = ~live
    assert (b["t"][dead] == torch.tensor(TI.INF)).all()
    assert (b["flag"][dead] == 0).all()
    for k in CI.HIT_FIELDS[1:] + (("iu", "iv") if with_uv else ()):
        assert torch.equal(b[k][dead].view(torch.int32),
                           torch.zeros_like(b[k][dead]).view(torch.int32))
    if with_uv:
        assert (b["tex"][dead] == -1.0).all()
    # the live lanes: the unmasked sweep's, and the JAX kernel's
    full = CI.nearest_hit_plain(w["pk"], w["ro"], w["rd"], with_uv)
    for k in b:
        assert torch.equal(b[k][live], full[k][live]), k
    lv = live.numpy()
    if not lv.any():
        return
    a = w["hit"]
    np.testing.assert_array_equal(a["flag"][lv], b["flag"].numpy()[lv])
    same = _same_t(a["t"][lv], b["t"].numpy()[lv])
    assert same.mean() >= 0.9995
    hit = same & (b["flag"].numpy()[lv] > 0)
    assert hit.mean() > 0.3
    for f in ("nx", "ny", "nz"):
        assert np.isclose(a[f][lv], b[f].numpy()[lv],
                          atol=1e-4)[hit].mean() > 0.999, f
    for f in ("bcr", "bcg", "bcb", "rough", "metal", "eta"):
        np.testing.assert_array_equal(a[f][lv][hit], b[f].numpy()[lv][hit])
    if with_uv:
        uv_ok = ((np.abs(a["iu"][lv] - b["iu"].numpy()[lv]) <= 1e-5)
                 & (np.abs(a["iv"][lv] - b["iv"].numpy()[lv]) <= 1e-5)
                 & (a["tex"][lv] == b["tex"].numpy()[lv]))
        assert uv_ok[hit].mean() >= 0.9995


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dielectrics_block", [True, False])
@pytest.mark.parametrize("walk", ["flat", "super"])
def test_any_blocker_plain_with_live_matches_pallas(walks, walk,
                                                    dielectrics_block, mask):
    w = walks[walk]
    live = _live(mask, w["p1"].shape[0])
    b = CI.any_blocker_plain(w["pk"], w["p1"], w["srd"], w["md"],
                             dielectrics_block, live=live)
    assert not b[~live].any()
    lv = live.numpy()
    a = w["blocked"][dielectrics_block]
    np.testing.assert_array_equal(a[lv], b.numpy()[lv])
    assert 0.02 < a.mean() < 0.98          # both verdicts occur
    # the walk model's verdicts (the counting path) agree
    c = cuda_connect.new_counts()
    np.testing.assert_array_equal(
        CI.any_blocker_plain(w["pk"], w["p1"], w["srd"], w["md"],
                             dielectrics_block, live=live,
                             counts=c).numpy(), b.numpy())


def _record_nearest(module, monkeypatch):
    """Swap ``module.nearest_hit`` for one that records each call's mask
    and hands it on; returns the list of masks."""
    masks, own = [], module.nearest_hit

    def nearest(packed, ro, rd, with_uv=False, live=None):
        masks.append(live)
        return own(packed, ro, rd, with_uv, live)

    monkeypatch.setattr(module, "nearest_hit", nearest)
    return masks


def _ignore_live(packed, ro, rd, with_uv=False, live=None):
    """The nearest hit of every lane, whatever the mask (as before the
    mask was handed over)."""
    return CI.nearest_hit_plain(packed, ro, rd, with_uv)


@pytest.mark.parametrize("which", ["ppm_eye", "bdpt_light"])
def test_eye_pass_and_light_trace_hand_over_their_alive_lanes(which,
                                                              monkeypatch):
    """The PPM eye pass and the BDPT light trace pass their alive lanes as
    ``live``, and every output equals the one they give when every lane
    is computed: every read of the hit is gated by ``alive & hit``."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators import bdpt, ppm
    from path_tracing_tpu_torch.ops import cuda_bdpt_light, cuda_ppm_eye, rng

    _, _, ts, tc = jax_cornell(24, 16)
    key = rng.prng_key(3)
    if which == "ppm_eye":
        module = cuda_ppm_eye    # the loop: CPU tensors take it
        idx = torch.arange(24 * 16, dtype=torch.int32)
        cfg = RenderConfig(width=24, height=16)

        def run():
            direct, hp = ppm.ppm_eye_trace(ts, tc, cfg, idx % 24, idx // 24,
                                           key)
            return [direct, *(getattr(hp, f) for f in (
                "pos", "normal", "wo", "throughput", "valid")),
                *(getattr(hp.mtl, f) for f in ("base_color", "roughness",
                                                "metallic", "eta"))]
    else:
        module = cuda_bdpt_light    # the loop: CPU tensors take it
        cfg = RenderConfig(width=24, height=16, light_depth=4)

        def run():
            lv = bdpt.trace_light_paths(ts, cfg, ts.num_lights * 64, 8, key)
            return [getattr(lv, f) for f in ("pos", "normal", "throughput",
                                             "pdf_fwd", "pdf_rev", "valid",
                                             "mis_a")]
    with monkeypatch.context() as m:
        masks = _record_nearest(module, m)
        got = run()
    assert len(masks) > 1 and all(x is not None for x in masks)
    assert not masks[-1].all()              # later calls drop lanes
    with monkeypatch.context() as m:
        m.setattr(module, "nearest_hit", _ignore_live)
        ref = run()
    for x, y in zip(got, ref):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
