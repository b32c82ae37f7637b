"""Intersection in the PyTorch port against the JAX package: the plain
nearest-hit and any-blocker sweeps (what CPU tensors run) against the JAX
XLA tier and against the Pallas kernels in interpret mode, on the same rays
and the very same scene tables.

Tolerance: t within rtol 1e-5 on at least 99.95% of rays, the bound the JAX
package puts on its own Pallas sweep against its XLA sweep (knife-edge hits
resolve differently, tests/test_pallas_interpret.py); hit/miss and
light/surface flags must agree everywhere.  Shadow verdicts are binary:
exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.ops import intersect as JI
from path_tracing_tpu.ops.pallas_intersect import (any_blocker_pallas,
                                                   nearest_hit_pallas)
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops import cuda_shade
from path_tracing_tpu_torch.ops import intersect as TI

from test_torch_scene import jax_cornell

B = 2048


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
    from path_tracing_tpu_torch.scene.parser import parse_scene_text

    txt = ("E 0 0 3\nV 0 0 0 0 1 0\nF 50\nR 4 4\nM 1 1 1 0 0 1.5\n"
           "K 0.5 0.5 0.5 1\nS 0 0 0 0.5\nL 0 2 0 0 -1 0 5 5 5 60 0 0.1\n")
    sc = parse_scene_text(txt).to_device("cpu")
    assert sc.has_legacy_ks
    p = torch.zeros((2, 3))
    with pytest.raises(NotImplementedError):
        TI.shadow_factor(sc, p, p + 1.0, dielectrics_block=True)
