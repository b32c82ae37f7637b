"""Device math of the PyTorch port against the JAX package on the same
random inputs: vectors, frames, Fresnel, GGX (with the reference's D
quirk), sphere sampling and the BSDF.

Tolerances.  Functions of given directions: rtol 1e-5 / atol 1e-6, the
last-ulp differences of float32 in two frameworks (the port rounds as its
CUDA kernels do: reciprocal-multiply normalization, component sums).
Sampled directions: rtol 1e-4 / atol 1e-5 on at least 99.9% of lanes.  They
start from cos/sin of 2*pi*u, where XLA's and torch's float32 libm differ
by an ulp, and VNDF sampling amplifies that through sqrt(1 - p1^2) as u1
nears 1 (about 0.2% of lanes move by up to ~1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.ops import bsdf as jb
from path_tracing_tpu.ops import frame as jf
from path_tracing_tpu.ops import fresnel as jfr
from path_tracing_tpu.ops import math3 as jm
from path_tracing_tpu.ops import microfacet as jmf
from path_tracing_tpu.ops import sampling as js
from path_tracing_tpu.scene.types import Material as JMaterial
from path_tracing_tpu_torch.ops import bsdf as tb
from path_tracing_tpu_torch.ops import frame as tf
from path_tracing_tpu_torch.ops import fresnel as tfr
from path_tracing_tpu_torch.ops import math3 as tm
from path_tracing_tpu_torch.ops import microfacet as tmf
from path_tracing_tpu_torch.ops import sampling as ts
from path_tracing_tpu_torch.scene.types import Material as TMaterial

RTOL, ATOL = 1e-5, 1e-6
SAMPLE_TOL = dict(share=0.999, rtol=1e-4, atol=1e-5)
N = 4096

# [r, g, b, roughness, metallic, eta]: every BSDF branch of the main path
MATERIALS = {
    "diffuse": [0.75, 0.15, 0.12, 1.0, 0.0, 0.0],
    "glossy": [0.85, 0.85, 0.85, 0.15, 0.0, 0.0],
    "rough_metal": [0.9, 0.6, 0.3, 0.3, 1.0, 0.0],
    "mirror": [0.95, 0.95, 0.95, 0.0, 1.0, 0.0],
    "glass": [1.0, 1.0, 1.0, 0.0, 0.0, 1.5],
    "diamond": [1.0, 1.0, 1.0, 0.0, 0.0, 2.4],
    "rough_glass": [1.0, 1.0, 1.0, 0.2, 0.0, 1.5],
}


def unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def both(x):
    x = np.asarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(a, b, share=1.0, rtol=RTOL, atol=ATOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    ok = np.isclose(a, b, rtol=rtol, atol=atol) | (np.isnan(a) & np.isnan(b))
    if a.ndim > 1:
        ok = ok.all(axis=tuple(range(1, a.ndim)))
    assert ok.mean() >= share, ok.mean()


def test_vector_math():
    rs = np.random.RandomState(0)
    a = rs.normal(size=(N, 3)).astype(np.float32)
    b = rs.normal(size=(N, 3)).astype(np.float32) * 10
    (ja, ta), (jbv, tbv) = both(a), both(b)
    close(jm.dot(ja, jbv), tm.dot(ta, tbv))
    close(jm.cross(ja, jbv), tm.cross(ta, tbv))
    close(jm.normalize(ja), tm.normalize(ta))
    close(jm.clamp_radiance(jbv * jbv, 15.0), tm.clamp_radiance(tbv * tbv,
                                                                15.0))
    c = b.copy()
    c[::7, 1] = np.nan
    c[::11, 2] = np.inf
    jc, tc = both(c)
    np.testing.assert_array_equal(np.asarray(jm.is_valid_color(jc)),
                                  tm.is_valid_color(tc).numpy())


def test_frame_fresnel_microfacet():
    rs = np.random.RandomState(1)
    n = unit(rs, N)
    n[:64] = [0.0, 0.0, 1.0]            # the |n.z| >= 0.999 branch
    w = unit(rs, N)
    jn, tn = both(n)
    jw, tw = both(w)
    (jt, jbb), (tt, tbb) = jf.build_local_frame(jn), tf.build_local_frame(tn)
    close(jt, tt)
    close(jbb, tbb)
    close(jf.world_to_local(jw, jt, jbb, jn),
          tf.world_to_local(tw, tt, tbb, tn))
    cos = rs.uniform(-1, 1, N).astype(np.float32)
    eta = rs.choice([1.5, 2.4, 0.0], N).astype(np.float32)
    (jc, tc), (je, te) = both(cos), both(eta)
    close(jfr.fr_dielectric(jc, 1.0, je), tfr.fr_dielectric(tc, 1.0, te))
    r0 = rs.uniform(0, 1, (N, 3)).astype(np.float32)
    jr0, tr0 = both(r0)
    close(jfr.fr_schlick(jnp.abs(jc), jr0), tfr.fr_schlick(tc.abs(), tr0))
    alpha = rs.uniform(1e-3, 1, N).astype(np.float32) ** 2
    ja, ta = both(alpha)
    close(jmf.tr_d(jw, ja), tmf.tr_d(tw, ta))
    close(jmf.tr_lambda(jw, ja), tmf.tr_lambda(tw, ta))
    up = np.abs(w) * [1, 1, 1]
    u1, u2 = rs.uniform(0, 1, (2, N)).astype(np.float32)
    (ju, tu), (jv, tv), (jup, tup) = both(u1), both(u2), both(up)
    close(jmf.sample_tr_visible_normal(jup, ja, ju, jv),
          tmf.sample_tr_visible_normal(tup, ta, tu, tv), **SAMPLE_TOL)
    close(js.uniform_sphere_dir(ju, jv), ts.uniform_sphere_dir(tu, tv),
          **SAMPLE_TOL)


def _materials(name, n):
    row = np.asarray(MATERIALS[name], np.float32)
    rows = np.broadcast_to(row, (n, 6)).copy()
    jmat = JMaterial(base_color=jnp.asarray(rows[:, :3]),
                     roughness=jnp.asarray(rows[:, 3]),
                     metallic=jnp.asarray(rows[:, 4]),
                     eta=jnp.asarray(rows[:, 5]))
    tmat = TMaterial(base_color=torch.from_numpy(rows[:, :3].copy()),
                     roughness=torch.from_numpy(rows[:, 3].copy()),
                     metallic=torch.from_numpy(rows[:, 4].copy()),
                     eta=torch.from_numpy(rows[:, 5].copy()))
    return jmat, tmat


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_bsdf_eval_pdf_and_sample(name):
    rs = np.random.RandomState(sorted(MATERIALS).index(name))
    jmat, tmat = _materials(name, N)
    n, wo, wi = unit(rs, N), unit(rs, N), unit(rs, N)
    wo = np.where((np.sum(wo * n, 1) < 0)[:, None] & (rs.rand(N) < 0.8)[:,
                                                                          None],
                  -wo, wo).astype(np.float32)
    (jn, tn), (jwo, two), (jwi, twi) = both(n), both(wo), both(wi)
    fa, pa = jb.bsdf_eval_pdf(jmat, jwo, jwi, jn)
    fb, pb = tb.bsdf_eval_pdf(tmat, two, twi, tn)
    close(fa, fb)
    close(pa, pb)

    u = rs.uniform(0, 1, (3, N)).astype(np.float32)
    cur = rs.choice([1.0, 1.5], N).astype(np.float32)
    (ju0, tu0), (ju1, tu1), (ju2, tu2), (jc, tc) = (both(u[0]), both(u[1]),
                                                    both(u[2]), both(cur))
    sa = jb.bsdf_sample(jmat, jwo, jn, ju0, ju1, ju2, jc)
    sb = tb.bsdf_sample(tmat, two, tn, tu0, tu1, tu2, tc)
    np.testing.assert_array_equal(np.asarray(sa.is_delta),
                                  sb.is_delta.numpy())
    for f in ("wi", "value", "pdf", "new_eta"):
        close(getattr(sa, f), getattr(sb, f), **SAMPLE_TOL)
