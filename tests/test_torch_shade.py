"""The fused PT bounce: the port's plain ``shade_step`` (what CPU tensors
run) against the JAX package's ``shade_step_pallas`` in interpret mode, on
one 4096-lane tile of matched inputs: the same scene tables, path state
and uniforms.

Tolerance: every output within rtol 1e-4 / atol 1e-5 on at least 99.9% of
lanes.  Both sides compute the same float32 formulas; the bounce starts
from cos/sin of sampled angles, where the two frameworks' libm differ by an
ulp, and a lane on a knife edge (a hit or a branch decided by the last bit)
may go the other way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.integrators.pt import _light_table as j_light_table
from path_tracing_tpu.ops.pallas_shade import shade_step_pallas
from path_tracing_tpu_torch.ops import cuda_shade, rng
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene.camera import primary_ray_dirs

from test_torch_scene import jax_cornell

W = H = 64          # 4096 lanes: one (32, 128) tile of the Pallas kernel
FIELDS = ("radiance", "ro", "rd", "tp", "eta", "depth", "alive",
          "last_is_delta", "last_pdf")


@pytest.fixture(scope="module")
def matched_state():
    """Path state after two plain bounces from the camera (a mix of
    surface, light and miss lanes, delta and rough vertices, lanes that
    died), plus a fresh row of uniforms."""
    js, _, ts, tc = jax_cornell(W, H)
    pk, lt = pack_scene(ts), ts.packed.light
    B = W * H
    idx = torch.arange(B, dtype=torch.int32)
    key = rng.prng_key(7)
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8)
    st = dict(ro=tc.eye[None].expand(B, 3).contiguous(),
              rd=primary_ray_dirs(tc, idx % W, idx // W, u[6], u[7]),
              tp=torch.ones(B, 3), eta=torch.ones(B),
              depth=torch.zeros(B, dtype=torch.int32),
              alive=torch.ones(B, dtype=torch.bool),
              last_is_delta=torch.ones(B, dtype=torch.bool),
              last_pdf=torch.ones(B))
    for it in range(2):
        out = cuda_shade.shade_step_plain(
            pk, lt, st["ro"], st["rd"], st["tp"], st["eta"], st["depth"],
            st["alive"], st["last_is_delta"], st["last_pdf"], u,
            clamp_val=15.0, stub_mis=True, dielectrics_block=True)
        st = {k: out[k] for k in st}
        u = rng.uniform_rows(rng.iter_key(key, it + 1), B, 8)
    # keep some dead lanes, and wake a share of the rest at depth 0
    wake = torch.arange(B) % 3 == 0
    st["alive"] = st["alive"] | wake
    return js, pk, lt, st, u


@pytest.mark.parametrize("stub_mis,dielectrics_block",
                         [(True, True), (False, False)])
def test_shade_step_matches_pallas_interpret(matched_state, stub_mis,
                                             dielectrics_block):
    js, pk, lt, st, u = matched_state
    assert 0.3 < st["alive"].float().mean() < 1.0
    kw = dict(clamp_val=15.0, stub_mis=stub_mis,
              dielectrics_block=dielectrics_block)
    got = cuda_shade.shade_step(pk, lt, st["ro"], st["rd"], st["tp"],
                                st["eta"], st["depth"], st["alive"],
                                st["last_is_delta"], st["last_pdf"], u, **kw)
    j = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    ju = tuple(jnp.asarray(u[i].numpy()) for i in range(6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_TPU_INTERPRET", "1")
        jax.clear_caches()
        ref = shade_step_pallas(js, j_light_table(js), j["ro"], j["rd"],
                                j["tp"], j["eta"], j["depth"], j["alive"],
                                j["last_is_delta"], j["last_pdf"], ju, **kw)
    jax.clear_caches()
    for f in FIELDS:
        a, b = np.asarray(ref[f]), got[f].numpy()
        assert a.shape == b.shape, f
        ok = np.isclose(a.astype(np.float64), b.astype(np.float64),
                        rtol=1e-4, atol=1e-5)
        if ok.ndim > 1:
            ok = ok.all(axis=1)
        assert ok.mean() >= 0.999, (f, ok.mean())
    assert float(got["radiance"].sum()) > 0.0      # the bounce gathers light


def test_step_tiers_identical_on_cpu(matched_state):
    """On CPU tensors the fused wrapper, the split step and the plain step
    all run the plain code: identical outputs."""
    _, pk, lt, st, u = matched_state
    args = (pk, lt, st["ro"], st["rd"], st["tp"], st["eta"], st["depth"],
            st["alive"], st["last_is_delta"], st["last_pdf"], u)
    kw = dict(clamp_val=15.0, stub_mis=True, dielectrics_block=True)
    a = cuda_shade.shade_step(*args, **kw)
    b = cuda_shade.shade_step_split(*args, **kw)
    c = cuda_shade.shade_step_plain(*args, **kw)
    for f in FIELDS:
        assert torch.equal(a[f], b[f]) and torch.equal(a[f], c[f]), f
