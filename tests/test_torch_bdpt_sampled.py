"""Sampled BDPT connections (``bdpt_connection_samples`` = M > 0) in the
PyTorch port against the JAX package's ``_connect_sampled``: the
stratified rows, the connection sums on the same eye vertices (exact
shadows and, on cornell with a ``K`` record, the RGB shadow) and renders
through the fused and plain tiers, on cornell at a small size.  Both
packages read the same tables (``scene_from_jax_arrays``); the JAX package
runs its XLA eye pass (its only route for sampled connections).  Bars,
each with its reason:

- the rows: bit for bit (the same Threefry counters and float32 ops);
- connection sums: max-channel relative error < 1e-3 on every active lane
  and 0 on the others (``tests/test_torch_bdpt.py``'s bar for
  ``_connect``);
- renders: mean within 1e-3 and >= 99% of pixels within rtol 1e-4 / atol
  1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import bdpt as jb
from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu.ops import rng as jrng
from path_tracing_tpu.ops.math3 import normalize
from path_tracing_tpu.ops.pallas_connect import pack_light_vertices
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt
from path_tracing_tpu_torch.ops import _kernels, cuda_connect, rng
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene.types import Material

from test_torch_legacy import _scenes, legacy_cornell_text
from test_torch_scene import CORNELL

W = H = 16
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)
MTL = ("base_color", "roughness", "metallic", "eta")


@pytest.fixture(scope="module")
def cornell():
    return _scenes(CORNELL.read_text())


def _jax_rows(key, B, M, nv, start=0, total=None):
    """``_connect_sampled``'s stratified rows, its lines verbatim."""
    nv = jnp.maximum(jnp.int32(nv), 1)
    u = jnp.stack(jrng.uniforms_g(jax.random.fold_in(key, 0x5E1), B, M,
                                  start, total))
    j = jnp.arange(M, dtype=jnp.float32)[:, None]
    vidx = jnp.minimum(((j + u) * (nv.astype(jnp.float32) / M))
                       .astype(jnp.int32), nv - 1)
    return np.asarray(vidx.T)


@pytest.mark.parametrize("M,nv,window", [(16, 813, None), (6, 5, None),
                                         (5, 0, None), (8, 100, (64, 512))])
def test_sample_rows_bit_equal_to_jax(M, nv, window):
    key = jax.random.fold_in(jax.random.PRNGKey(4), 7)
    tkey = rng.fold_in(rng.prng_key(4), 7)
    start, total = window or (0, None)
    B = 256
    a = _jax_rows(key, B, M, nv, start, total)
    for draw in (rng.uniform_rows_plain, rng.uniform_rows):
        b = cuda_connect.sample_rows(draw, rng.fold_in(tkey, 0x5E1), B, M,
                                     nv, start, total, device="cpu")
        assert b.dtype == torch.int32 and b.shape == (B, M)
        np.testing.assert_array_equal(a, b.numpy())
    assert a.min() >= 0 and a.max() <= max(nv, 1) - 1


def test_sample_chunk_and_scale():
    assert [cuda_connect.sample_chunk(m) for m in (16, 12, 6, 5, 1)] == [
        8, 4, 2, 1, 1]
    assert cuda_connect.sampled_scale(0, 4).item() == np.float32(1) / 4
    assert (cuda_connect.sampled_scale(813, 16).item()
            == np.float32(813) / np.float32(16))


def _primary(js, jc, cfg, seed=7):
    """The JAX package's compacted light vertices of a frame and the
    primary hits of a W x H frame with a random eye-side G."""
    lv = jb.trace_light_paths(js.with_illum_scaled(0.5), cfg,
                              js.num_lights * 4, 2, jax.random.PRNGKey(3))
    lv_flat, nv = jb.compact_flat(lv.flat())
    B = W * H
    idx = jnp.arange(B, dtype=jnp.int32)
    rs = np.random.RandomState(seed)
    jx, jy = rs.uniform(0, 1, (2, B)).astype(np.float32)
    rd = jcamera.primary_ray_dirs(jc, idx % W, idx // W, jnp.asarray(jx),
                                  jnp.asarray(jy))
    hit = JI.find_closest_hit(js, jnp.broadcast_to(jc.eye, (B, 3)), rd)
    g = np.abs(rs.normal(size=B)).astype(np.float32)
    eye_f = jnp.where(hit.mtl.eta > 0.0, 0.0, 1e8 * (1.0 + jnp.asarray(g)))
    tp = jnp.asarray(rs.uniform(0.2, 1.0, (B, 3)).astype(np.float32))
    wo_s = normalize(jc.eye[None] - hit.pos)
    return lv_flat, int(nv), hit, rd, wo_s, eye_f, tp


@pytest.mark.parametrize("scene,M", [("cornell", 16), ("cornell", 6),
                                     ("cornell_k", 5)])
def test_connect_sampled_plain_matches_jax(scene, M, cornell):
    """``connect_plain`` with ``vidx`` against ``_connect_sampled`` on the
    same eye vertices, table and key: mc = 8 (M 16), 2 (M 6) and 1 (M 5,
    on legacy cornell, with the RGB shadow)."""
    js, jc, ts, _ = (cornell if scene == "cornell"
                     else _scenes(legacy_cornell_text()))
    cfg = JConfig(**dict(CFG, bdpt_connection_samples=M))
    lv_flat, nv, hit, rd, wo_s, eye_f, tp = _primary(js, jc, cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    ref = np.asarray(jb._connect_sampled(js, cfg, lv_flat, nv, hit.pos,
                                         hit.normal, tp, hit.mtl, -rd, wo_s,
                                         eye_f, key))

    def t(x):
        return torch.from_numpy(np.array(x))

    act = np.asarray(hit.hit & ~hit.is_light)
    vidx = cuda_connect.sample_rows(
        rng.uniform_rows_plain, rng.fold_in(rng.fold_in(rng.prng_key(5), 1),
                                            0x5E1), W * H, M, nv,
        device="cpu")
    np.testing.assert_array_equal(vidx.numpy(),
                                  _jax_rows(key, W * H, M, nv))
    _kernels.reset_counts()
    got = cuda_connect.connect_plain(
        pack_scene(ts), t(pack_light_vertices(lv_flat)), nv, t(hit.pos),
        t(hit.normal), t(tp), Material(*(t(getattr(hit.mtl, f))
                                         for f in MTL)),
        t(-rd), t(wo_s), t(eye_f), t(act), clamp_val=15.0,
        dielectrics_block=True, vidx=vidx).numpy()
    assert (_kernels.plain_calls["transmittance_rgb"] > 0) == (
        scene == "cornell_k")
    assert act.mean() > 0.9 and np.abs(got[act]).sum() > 0
    assert (got[~act] == 0).all()
    rel = np.abs(got - ref)[act] / (np.abs(ref[act]) + 1e-3)
    assert (rel.max(axis=1) < 1e-3).all(), rel.max()


@pytest.mark.parametrize("tier,K", [("fused", 0), ("plain", 8)])
def test_render_sampled_matches_jax(tier, K, cornell):
    """A frame at 16x16 spp 2, spl 2 with M = 4 (and global RIS K = 8 in
    front of it) against the JAX package's XLA eye pass, which calls
    ``_connect_sampled``; the sampled estimate differs from the exact
    sweep's."""
    js, jc, ts, tc = cornell
    cfg = dict(CFG, bdpt_connection_samples=4, bdpt_resample_vertices=K)
    assert bdpt.resolve_tier(ts, "auto", RenderConfig(**cfg)) == "fused"
    img = bdpt.render_bdpt(ts, tc, W, H, 2, 2, RenderConfig(**cfg),
                           rng.prng_key(2), tier=tier).numpy()
    ref = np.asarray(jb.render_bdpt(js, jc, W, H, 2, 2, JConfig(**cfg),
                                    jax.random.PRNGKey(2)))
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(ref.mean() - img.mean()) / ref.mean() < 1e-3
    close = np.isclose(ref, img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    exact = bdpt.render_bdpt(ts, tc, W, H, 2, 2, RenderConfig(**dict(
        cfg, bdpt_connection_samples=0)), rng.prng_key(2),
        tier=tier).numpy()
    assert not np.array_equal(exact, img)
