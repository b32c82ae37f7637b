"""The BDPT slice of the PyTorch port against the JAX package, module by
module and end to end, at a small size (16x16, eye and light depth 3,
delta budget 3, spl 4) on cornell and the diffuse box.

Inputs are made from a seed with numpy, and scenes are carried across with
``scene_from_jax_arrays``.  The JAX package runs its Pallas kernels in
interpret mode (``PT_TPU_INTERPRET=1``, its per-bounce BDPT tier with
``PT_TPU_NO_BDPT_MEGAKERNEL=1``) or its XLA tier, with ``jax.clear_caches``
around every change of those knobs.  Bars, each with its reason:

- ``rng.uniform``: bit for bit (the same Threefry counters);
- emission and the scaled scene: rtol 1e-6 (one float32 ulp of the
  transcendentals of two frameworks); the BSDF: rtol 1e-5 / atol 1e-6,
  tests/test_torch_bsdf.py's bar, since the port rounds as its kernels do
  (component sums, reciprocal-multiply normalization) and the GGX lobes
  amplify that ulp (measured up to 1.3e-5 relative at roughness 0.05);
- the light trace: validity masks equal; every field within rtol 1e-5 /
  atol 1e-6 on >= 97% of valid rows (measured 98.2% on cornell, where a
  metal and a glass sphere amplify an ulp through the BSDF sample; 100% on
  the diffuse box) and within rtol 1e-3 / atol 1e-5 on all of them;
- RIS tables: the share of equal draws, and equal scales where the draws
  agree (``cumsum`` and ``searchsorted`` may round a boundary otherwise);
- connection sums on matched inputs: max-channel relative error < 1e-3 on
  every active lane (tests/test_pallas_interpret.py's bar);
- renders: mean within 1e-3 and >= 97% of pixels with every channel within
  1e-3 relative (the JAX package's own tier bar: the 1e8 eye-side MIS
  prefactor lets a branch taken the other way move a whole pixel).  The
  port draws the JAX scan tier's very stream, and measured 100% of pixels
  within rtol 1e-4 / atol 1e-5 and a mean within 3e-7 at this size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import bdpt as jb
from path_tracing_tpu.ops import bsdf as jbsdf
from path_tracing_tpu.ops import sampling as jsampling
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import parser as jparser
from path_tracing_tpu.scene.types import Material as JMaterial
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt
from path_tracing_tpu_torch.ops import bsdf, cuda_bdpt_eye, cuda_connect, rng
from path_tracing_tpu_torch.ops import sampling
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene.types import Material, scene_from_jax_arrays

from test_torch_scene import CORNELL, DIFFUSE_BOX, jax_arrays, jax_cornell

W = H = 16
SPL = 4
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)
MTL_FIELDS = ("base_color", "roughness", "metallic", "eta")
LV_FIELDS = ("pos", "normal", "throughput", "pdf_fwd", "pdf_rev",
             "is_light_source", "source_cutoff", "is_parallel", "emit_dir",
             "wo", "mis_a", "valid")


def _scenes(name, w=W, h=H):
    if name == "cornell":
        return jax_cornell(w, h)
    p = jparser.parse_scene_text(DIFFUSE_BOX)
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    return js, jc, ts, tc


def _np_lv(lv) -> dict:
    """LightVertices of either package as numpy arrays."""
    d = {f: np.asarray(getattr(lv, f)) for f in LV_FIELDS}
    for f in MTL_FIELDS:
        d[f"mtl.{f}"] = np.asarray(getattr(lv.mtl, f))
    return d


def _port_lv(d: dict) -> bdpt.LightVertices:
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    return bdpt.LightVertices(
        mtl=Material(**{f: t[f"mtl.{f}"] for f in MTL_FIELDS}),
        **{f: t[f] for f in LV_FIELDS})


def _jax_lv(d: dict):
    return jb.LightVertices(
        mtl=JMaterial(**{f: jnp.asarray(d[f"mtl.{f}"]) for f in MTL_FIELDS}),
        **{f: jnp.asarray(d[f]) for f in LV_FIELDS})


def _traced(name="cornell", spl=SPL, seed=0, **cfg):
    """Both packages' light paths of a GPU-parity frame (flux / spl,
    Nl * spl * spl paths) from the same key, as numpy dicts."""
    js, _, ts, _ = _scenes(name)
    c = dict(CFG, **cfg)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x0101)
    n = js.num_lights * spl * spl
    a = jb.trace_light_paths(js.with_illum_scaled(1.0 / spl), JConfig(**c),
                             n, spl, key)
    b = bdpt.trace_light_paths(ts.with_illum_scaled(1.0 / spl),
                               RenderConfig(**c), n, spl,
                               rng.fold_in(rng.prng_key(seed), 0x0101))
    return _np_lv(a), _np_lv(b)


def _compacted(name="cornell"):
    """The JAX package's compacted flat light vertices, as numpy."""
    a, _ = _traced(name)
    lv_flat, n_valid = jb.compact_flat(_jax_lv(a).flat())
    return _np_lv(lv_flat), int(n_valid)


# ---- step 1: rng.uniform ----

@pytest.mark.parametrize("shape", [(7,), (32,), (5, 16), (127, 32)])
def test_uniform_matches_jax_random_uniform(shape):
    key = rng.fold_in(rng.prng_key(3), 0x5E5A)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 0x5E5A)
    a = np.asarray(jax.random.uniform(jkey, shape))
    b = rng.uniform(key, shape).numpy()
    np.testing.assert_array_equal(a, b)
    assert b.min() >= 0.0 and b.max() < 1.0


# ---- steps 2-4: emission, BSDF, the scaled scene ----

@pytest.mark.parametrize("parallel", [False, True])
def test_sample_light_emission_matches_jax(parallel):
    rs = np.random.RandomState(1 + parallel)
    n = 512
    f = np.float32
    pos = rs.uniform(-2, 2, (n, 3)).astype(f)
    d = rs.normal(size=(n, 3)).astype(f)
    d[::7, 0] = 0.95          # both branches of the light frame
    cutoff = rs.uniform(0.05, 1.5, n).astype(f)
    cutoff[::5] = 0.0
    is_par = np.full(n, int(parallel), np.int32)
    ball_r = rs.uniform(0.05, 0.5, n).astype(f)
    smin, smax = np.array([-5, -3, -5], f), np.array([5, 5, 5], f)
    u1, u2 = rs.uniform(0, 1, (2, n)).astype(f)
    args = (pos, d, cutoff, is_par, ball_r, smin, smax, u1, u2)
    a = jsampling.sample_light_emission(*map(jnp.asarray, args))
    b = sampling.sample_light_emission(*map(torch.from_numpy, args))
    # atol 2e-6 on the unit-scale values: XLA's CPU arccos is accurate to
    # 2.1 ulp and torch's to 0.65 ulp (measured against float64), and the
    # cone direction amplifies a theta ulp where its terms cancel
    for x, y in ((a.origin, b.origin), (a.direction, b.direction)):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=1e-6,
                                   atol=2e-6)
    ua, va = jsampling._light_frame(jnp.asarray(d / np.linalg.norm(
        d, axis=1, keepdims=True)))
    ub, vb = sampling._light_frame(torch.from_numpy(d / np.linalg.norm(
        d, axis=1, keepdims=True)))
    np.testing.assert_allclose(np.asarray(ua), ub.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(va), vb.numpy(), rtol=1e-6,
                               atol=1e-6)


# roughness, metallic, eta: diffuse, rough metal, rough dielectric, smooth
# dielectric, smooth conductor, glossy plastic
KINDS = {"diffuse": (1.0, 0.0, 0.0), "rough_metal": (0.3, 1.0, 0.0),
         "rough_dielectric": (0.2, 0.0, 1.5),
         "smooth_dielectric": (0.0, 0.0, 1.5),
         "smooth_conductor": (0.0, 1.0, 0.0), "glossy": (0.05, 0.4, 0.0)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bsdf_evaluate_and_pdf_match_jax(kind):
    rs = np.random.RandomState(len(kind))
    n = 1024
    f = np.float32

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(f)

    nrm, wo, wi = (unit(rs.normal(size=(n, 3))) for _ in range(3))
    wi[: n // 2] = unit(wi[: n // 2] * np.sign(
        np.sum(wi[: n // 2] * nrm[: n // 2], 1, keepdims=True)))
    rough, metal, eta = KINDS[kind]
    bc = rs.uniform(0.1, 0.9, (n, 3)).astype(f)
    cols = [np.full(n, v, f) for v in (rough, metal, eta)]
    jm = JMaterial(jnp.asarray(bc), *map(jnp.asarray, cols))
    tm = Material(torch.from_numpy(bc), *map(torch.from_numpy, cols))
    for jf, tf in ((jbsdf.bsdf_evaluate, bsdf.bsdf_evaluate),
                   (jbsdf.bsdf_pdf, bsdf.bsdf_pdf)):
        a = np.asarray(jf(jm, jnp.asarray(wo), jnp.asarray(wi),
                          jnp.asarray(nrm)))
        b = tf(tm, torch.from_numpy(wo), torch.from_numpy(wi),
               torch.from_numpy(nrm)).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_with_illum_scaled_matches_jax():
    js, _, ts, _ = jax_cornell(4, 4)
    a = np.asarray(js.with_illum_scaled(1.0 / 3.0).light_illum)
    b = ts.with_illum_scaled(1.0 / 3.0)
    np.testing.assert_allclose(a, b.light_illum.numpy(), rtol=1e-6)
    assert b.light_pos is ts.light_pos        # everything else shared
    np.testing.assert_array_equal(ts.light_illum.numpy(),
                                  np.asarray(js.light_illum))


# ---- step 5: the light trace ----

@pytest.mark.parametrize("name", ["cornell", "diffuse_box"])
def test_trace_light_paths_matches_jax(name):
    a, b = _traced(name)
    np.testing.assert_array_equal(a["valid"], b["valid"])
    v = a["valid"]
    assert v[:, 0].all() and v[:, 1:].sum() > 20, v.sum(axis=0)
    for k in a:
        x, y = a[k][v].astype(np.float64), b[k][v].astype(np.float64)
        ok = np.isclose(x, y, rtol=1e-5, atol=1e-6)
        ok = ok.all(axis=-1) if ok.ndim > 1 else ok
        assert ok.mean() >= 0.97, (k, ok.mean())
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5, err_msg=k)


def test_trace_light_paths_window_is_slice_of_full_trace():
    """Paths [start, start + P) of a total-path trace draw the global
    counters and the global light assignment: they are rows of the full
    trace."""
    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**CFG)
    key = rng.prng_key(4)
    full = _np_lv(bdpt.trace_light_paths(ts, cfg, 32, SPL, key))
    part = _np_lv(bdpt.trace_light_paths(ts, cfg, 12, SPL, key, start=9,
                                         total=32))
    for k in full:
        np.testing.assert_array_equal(full[k][9:21], part[k], err_msg=k)


@pytest.mark.parametrize("plain", [False, True])
def test_light_trace_on_cpu_tensors_runs_the_loop(plain):
    """CPU tensors take the light loop with or without ``plain`` (both
    draw and walk on the plain versions there), once a call, no kernel
    launched, the same vertices bit for bit; a light depth with no slot
    for the emitter is refused before the loop."""
    from path_tracing_tpu_torch.ops import _kernels
    from path_tracing_tpu_torch.ops.cuda_bdpt_light import light_vertex_bits

    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**CFG)
    key = rng.prng_key(8)
    _kernels.reset_counts()
    lv = bdpt.trace_light_paths(ts, cfg, 24, SPL, key, plain=plain)
    assert _kernels.plain_calls["bdpt_light"] == 1
    assert _kernels.launches["bdpt_light"] == 0
    other = bdpt.trace_light_paths(ts, cfg, 24, SPL, key, plain=not plain)
    assert torch.equal(light_vertex_bits(lv), light_vertex_bits(other))
    with pytest.raises(ValueError, match="light_depth"):
        bdpt.trace_light_paths(ts, cfg.with_(light_depth=0), 24, SPL, key,
                               plain=plain)
    assert _kernels.plain_calls["bdpt_light"] == 2


def test_light_vertex_bits_lays_out_a_row_a_vertex():
    """``light_vertex_bits``: one row of 28 32-bit words a vertex, (path,
    slot) row-major, the fields in ``LightVertices``' order (the bools as
    0.0 / 1.0)."""
    from path_tracing_tpu_torch.ops.cuda_bdpt_light import light_vertex_bits

    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**CFG)
    lv = bdpt.trace_light_paths(ts, cfg, 12, SPL, rng.prng_key(9))
    bits = light_vertex_bits(lv)
    L = cfg.light_depth
    assert bits.dtype == torch.int32 and bits.shape == (12 * L, 28)
    words = {"pos": (0, 3), "normal": (3, 6), "throughput": (6, 9),
             "mtl.base_color": (9, 12), "mtl.roughness": (12, 13),
             "mtl.metallic": (13, 14), "mtl.eta": (14, 15),
             "pdf_fwd": (15, 16), "pdf_rev": (16, 17),
             "is_light_source": (17, 18), "source_cutoff": (18, 19),
             "is_parallel": (19, 20), "emit_dir": (20, 23), "wo": (23, 26),
             "mis_a": (26, 27), "valid": (27, 28)}
    for name, (a, b) in words.items():
        x = lv.mtl if name.startswith("mtl.") else lv
        x = getattr(x, name.split(".")[-1]).float().reshape(12 * L, b - a)
        assert torch.equal(bits[:, a:b], x.view(torch.int32)), name
    r = 5 * L + 1                                   # path 5, slot 1
    assert torch.equal(bits[r, 0:3], lv.pos[5, 1].view(torch.int32))
    ones = bits[:, 27][lv.valid.reshape(-1)]
    assert ones.numel() > 12 and bool((ones == 0x3F800000).all())


def test_light_loop_counts_the_kernels_work(monkeypatch):
    """``light_trace_plain`` given ``counts`` walks on the plain nearest hit
    and returns the same vertices bit for bit; it counts every path, a walk
    for every live path-iteration, three draws a BSDF sample, a reverse pdf
    for every stored surface vertex, and a stored vertex for each valid one
    past the emitters."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_light as cbl

    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**CFG)
    got = []

    def record(*args):
        got.append(args)
        return cbl.light_trace(*args)

    monkeypatch.setattr(bdpt, "light_trace", record)
    lv = bdpt.trace_light_paths(ts, cfg, 24, SPL, rng.prng_key(10))
    (args,) = got
    c = cbl.new_counts()
    counted = cbl.light_trace_plain(*args, counts=c)
    assert torch.equal(cbl.light_vertex_bits(counted),
                       cbl.light_vertex_bits(lv))
    assert set(c) == set(cbl.COUNT_NAMES)
    assert c["paths"] == 24
    assert c["walks"] >= int(lv.valid[:, 0].sum()) > 0
    assert c["walks"] >= c["bsdf_samples"] >= c["pdfs"] > 0
    assert c["draws"] == 3 * c["bsdf_samples"]
    assert c["stored"] >= int(lv.valid[:, 1:].sum()) > 0
    assert 0 < c["iteration_keys"] <= cfg.max_light_iters
    assert c["hit_spheres"] > 0 and c["hit_tris"] > 0


def _port_traced_table(light_depth=4, paths=24, spl=4):
    """tests/test_bdpt.py::_traced_table from the port's light trace."""
    p = jparser.parse_scene_text(DIFFUSE_BOX)
    ts, _ = scene_from_jax_arrays(jax_arrays(p.to_device()), "cpu")
    cfg = RenderConfig(width=8, height=8, eye_depth=2,
                       light_depth=light_depth, delta_budget=2)
    d = _np_lv(bdpt.trace_light_paths(ts, cfg, paths, spl,
                                      rng.prng_key(11)))
    d["mtl"] = np.concatenate(
        [d["mtl.base_color"], d["mtl.roughness"][..., None],
         d["mtl.metallic"][..., None], d["mtl.eta"][..., None]], axis=-1)
    return d


def test_light_trace_stored_pdfs_match_literal_recomputation():
    """Stored pdf_fwd / pdf_rev against the reference math recomputed from
    the stored geometry with the numpy oracle's BSDF pdf: on a delta-free
    scene consecutive stored vertices are adjacent, so pdf_fwd[t] =
    pdf_omega(prev) |n_t . dir| / dist2 (pdf_omega of the emitter 1/pi)
    and pdf_rev[t] = bsdf_pdf(mtl_t, dir_{t+1}, wo_t) |n_{t-1} . dir_t| /
    dist2 (tests/test_bdpt.py's check, on the port's trace)."""
    from pt_numpy_oracle import _bsdf_eval_pdf

    t = _port_traced_table()
    P, L = t["pdf_fwd"].shape
    checked_fwd = checked_rev = 0
    for p_i in range(P):
        for ti in range(1, L):
            if not t["valid"][p_i, ti] or t["is_light_source"][p_i, ti]:
                continue
            pos_p, pos_t = t["pos"][p_i, ti - 1], t["pos"][p_i, ti]
            d = pos_t - pos_p
            dist2 = float(np.dot(d, d))
            if dist2 < 1e-6:
                continue
            dirn = d / np.sqrt(dist2)
            n_t, n_p = t["normal"][p_i, ti], t["normal"][p_i, ti - 1]
            if ti == 1:
                pdf_omega = 1.0 / np.pi
            else:
                _, pdf_omega = _bsdf_eval_pdf(
                    t["mtl"][p_i, ti - 1][None], t["wo"][p_i, ti - 1][None],
                    dirn[None], n_p[None])
                pdf_omega = float(pdf_omega[0])
            want_fwd = pdf_omega * abs(float(np.dot(n_t, dirn))) / dist2
            np.testing.assert_allclose(t["pdf_fwd"][p_i, ti], want_fwd,
                                       rtol=2e-4, atol=1e-7)
            checked_fwd += 1
            if ti + 1 < L and t["valid"][p_i, ti + 1] \
                    and not t["is_light_source"][p_i, ti + 1]:
                d2 = t["pos"][p_i, ti + 1] - pos_t
                wi = d2 / np.linalg.norm(d2)
                _, pdf_rev_omega = _bsdf_eval_pdf(
                    t["mtl"][p_i, ti][None], wi[None],
                    t["wo"][p_i, ti][None], n_t[None])
                want_rev = (float(pdf_rev_omega[0])
                            * abs(float(np.dot(n_p, dirn))) / dist2)
                np.testing.assert_allclose(t["pdf_rev"][p_i, ti], want_rev,
                                           rtol=2e-4, atol=1e-7)
                checked_rev += 1
    assert checked_fwd >= 10 and checked_rev >= 3, (checked_fwd, checked_rev)


def test_mis_prefactor_matches_literal_reference_walk():
    """mis_a[t] against the reference's literal light-side ratio walk run
    on the same stored pdf_fwd / pdf_rev (tests/test_bdpt.py's check)."""
    t = _port_traced_table()
    P, L = t["pdf_fwd"].shape
    eta = t["mtl"][..., 5]
    checked = 0
    for p_i in range(P):
        for ti in range(1, L):
            if not t["valid"][p_i, ti]:
                continue
            ratio, prev, total = 1.0, 1.0, 0.0
            for i in range(ti, 0, -1):
                if t["is_light_source"][p_i, i]:
                    ratio *= prev / max(t["pdf_fwd"][p_i, i], 1e-8)
                    total += ratio
                    break
                if eta[p_i, i] > 0.0:
                    break
                ratio *= prev / max(t["pdf_fwd"][p_i, i], 1e-8)
                total += ratio
                prev = t["pdf_rev"][p_i, i]
            np.testing.assert_allclose(t["mis_a"][p_i, ti], total,
                                       rtol=2e-4, atol=1e-6)
            checked += 1
    assert checked >= 10, checked


# ---- steps 6-9: compaction, RIS, the packed table ----

def test_compact_flat_matches_jax():
    a, _ = _traced()
    lv_a, nv_a = jb.compact_flat(_jax_lv(a).flat())
    lv_b, nv_b = bdpt.compact_flat(_port_lv(a).flat())
    assert int(nv_a) == nv_b > 0
    da, db = _np_lv(lv_a), _np_lv(lv_b)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert db["valid"][:nv_b].all() and not db["valid"][nv_b:].any()


def _same_draws(a: dict, b: dict):
    """Rows drawn from the same source row: positions and normals equal."""
    return ((a["pos"] == b["pos"]).all(-1)
            & (a["normal"] == b["normal"]).all(-1))


def test_resample_light_vertices_matches_jax():
    d, nv = _compacted()
    K = 48
    key = jax.random.fold_in(jax.random.PRNGKey(2), 0x5E5A)
    a, ka = jb.resample_light_vertices(_jax_lv(d), nv, K, key)
    b, kb = bdpt.resample_light_vertices(_port_lv(d), nv, K,
                                         rng.fold_in(rng.prng_key(2),
                                                     0x5E5A))
    assert int(ka) == kb == K
    a, b = _np_lv(a), _np_lv(b)
    same = _same_draws(a, b)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(a["throughput"][same], b["throughput"][same],
                               rtol=1e-5)


def test_tile_resample_matches_jax():
    d, nv = _compacted()
    js, jc, ts, tc = jax_cornell(64, 48)
    B, lanes, K = 64 * 48, 1024, 12
    T = -(-B // lanes)
    idx = np.arange(B, dtype=np.int32)
    ra = jb.tile_representatives(js, jc, jnp.asarray(idx % 64),
                                 jnp.asarray(idx // 64), lanes, T)
    rb = bdpt.tile_representatives(ts, tc, torch.from_numpy(idx % 64),
                                   torch.from_numpy(idx // 64), lanes, T)
    np.testing.assert_allclose(np.asarray(ra), rb.numpy(), rtol=1e-5,
                               atol=1e-6)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 0x5E5A)
    a, kpa = jb.resample_light_vertices_tiled(_jax_lv(d), nv, K, key, ra)
    b, kpb = bdpt.resample_light_vertices_tiled(
        _port_lv(d), nv, K, rng.fold_in(rng.prng_key(5), 0x5E5A),
        torch.from_numpy(np.asarray(ra)))
    assert kpa == kpb == 16
    a, b = _np_lv(a), _np_lv(b)
    np.testing.assert_array_equal(a["valid"].reshape(T, 16)[:, K:], False)
    np.testing.assert_array_equal(b["valid"].reshape(T, 16)[:, K:], False)
    same = _same_draws(a, b)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(a["throughput"][same], b["throughput"][same],
                               rtol=1e-5)


def _unbiased_setup():
    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(eye_depth=3, light_depth=3, delta_budget=3)
    lv = bdpt.trace_light_paths(ts, cfg, ts.num_lights * 8, 8,
                                rng.prng_key(3))
    lv_flat, nv = bdpt.compact_flat(lv.flat())
    assert nv > 16
    return lv_flat, nv, lv_flat.throughput[:nv].sum(dim=0).double()


def test_resample_light_vertices_unbiased_weights():
    """For any linear functional of the throughput the resampled table's
    expectation is the exact valid-prefix sum (tests/test_bdpt.py's
    check on the port, with cornell)."""
    lv_flat, nv, exact = _unbiased_setup()
    K, n = 16, 400
    acc = torch.zeros(3, dtype=torch.float64)
    for i in range(n):
        out, k2 = bdpt.resample_light_vertices(lv_flat, nv, K,
                                               rng.prng_key(1000 + i))
        assert k2 == K
        acc += out.throughput.sum(dim=0).double()
    rel = (acc / n - exact).abs() / exact.abs().clamp(min=1e-6)
    assert (rel < 0.05).all(), (acc / n, exact)


def test_tile_resample_unbiased_weights():
    """Every tile's table is unbiased, however wrong its proposal: three
    tiles with deliberately diverse representatives."""
    lv_flat, nv, exact = _unbiased_setup()
    reps = torch.tensor([[0.0, 0.0, 0.0], [4.0, 4.0, 4.0],
                         [-50.0, 3.0, 9.0]])
    K, n, T = 16, 400, 3
    acc = torch.zeros((T, 3), dtype=torch.float64)
    for i in range(n):
        out, kp = bdpt.resample_light_vertices_tiled(
            lv_flat, nv, K, rng.prng_key(2000 + i), reps)
        acc += out.throughput.reshape(T, kp, 3).sum(dim=1).double()
    rel = (acc / n - exact).abs() / exact.abs().clamp(min=1e-6)
    assert (rel < 0.05).all(), (acc / n, exact)


def test_pack_light_vertices_matches_jax():
    from path_tracing_tpu.ops.pallas_connect import pack_light_vertices

    d, nv = _compacted()
    a = np.asarray(pack_light_vertices(_jax_lv(d)))
    b = cuda_connect.pack_light_vertices(_port_lv(d)).numpy()
    assert a.shape == b.shape and a.shape[0] % 8 == 0
    # the rows the kernels read; past them, invalid rows (whose zero
    # normals give the JAX frame NaN and the port's 0) and zero padding
    np.testing.assert_allclose(a[:nv], b[:nv], rtol=1e-6, atol=1e-7)
    assert (b[nv:, 25] == 0).all() and (a[nv:, 25] == 0).all()


# ---- step 10: the plain connection sum ----

def test_connect_plain_matches_jax(monkeypatch):
    """connect_plain against the JAX package's chunked XLA ``_connect`` and
    its ``connect_pallas`` (interpret mode) on the same eye vertices (the
    primary hits) and the same table, with a random eye-side G so the 1e8
    MIS prefactor is exercised (tests/test_pallas_interpret.py:204-252)."""
    got, a, refs = _connect_against_jax(monkeypatch, keep=1.0)
    assert a.mean() > 0.9 and np.abs(got[a]).sum() > 0
    assert (got[~a] == 0).all()
    for other in refs:
        rel = np.abs(got - other)[a] / (np.abs(other[a]) + 1e-3)
        assert (rel.max(axis=1) < 1e-3).all(), rel.max()


def test_connect_plain_matches_jax_on_sparse_lanes(monkeypatch):
    """The same on the exact table with about 30% of the lanes active (a
    numpy draw), as the fused tier's later iterations hand #8 its lanes:
    every active lane within 1e-3 of ``connect_pallas`` (interpret mode),
    every inactive lane exactly 0 in both."""
    got, a, (_, kern) = _connect_against_jax(monkeypatch, keep=0.3)
    assert 0.2 < a.mean() < 0.4 and np.abs(got[a]).sum() > 0
    assert (got[~a] == 0).all() and (kern[~a] == 0).all()
    rel = np.abs(got - kern)[a] / (np.abs(kern[a]) + 1e-3)
    assert (rel.max(axis=1) < 1e-3).all(), rel.max()


def _connect_against_jax(monkeypatch, keep: float):
    """connect_plain, the JAX package's ``_connect`` and its
    ``connect_pallas`` (interpret mode) on the primary hits of a W x H
    frame of cornell against its exact table (compacted light vertices),
    each active lane (a hit that is not a light) kept with probability
    ``keep``.  Returns (the port's sums, the active mask, (the XLA sums,
    the kernel's sums))."""
    from path_tracing_tpu.ops.intersect import find_closest_hit
    from path_tracing_tpu.ops.math3 import normalize
    from path_tracing_tpu.ops.pallas_connect import (connect_pallas,
                                                     pack_light_vertices)

    js, jc, ts, tc = jax_cornell(W, H)
    d, nv = _compacted()
    jcfg = JConfig(**CFG)
    B = W * H
    idx = jnp.arange(B, dtype=jnp.int32)
    rs = np.random.RandomState(7)
    jx, jy = rs.uniform(0, 1, (2, B)).astype(np.float32)
    rd = jcamera.primary_ray_dirs(jc, idx % W, idx // W, jnp.asarray(jx),
                                  jnp.asarray(jy))
    ro = jnp.broadcast_to(jc.eye, (B, 3))
    hit = find_closest_hit(js, ro, rd)
    act = hit.hit & ~hit.is_light
    wo_s = normalize(jc.eye[None] - hit.pos)
    g = np.abs(rs.normal(size=B)).astype(np.float32)
    eye_f = jnp.where(hit.mtl.eta > 0.0, 0.0, 1e8 * (1.0 + jnp.asarray(g)))
    tp = jnp.asarray(rs.uniform(0.2, 1.0, (B, 3)).astype(np.float32))
    if keep < 1.0:
        act = act & jnp.asarray(np.random.RandomState(8).uniform(size=B)
                                < keep)
    ref = np.asarray(jb._connect(js, jcfg, _jax_lv(d), nv, hit.pos,
                                 hit.normal, tp, hit.mtl, -rd, wo_s, eye_f,
                                 64))
    monkeypatch.setenv("PT_TPU_INTERPRET", "1")
    jax.clear_caches()
    try:
        kern = np.asarray(connect_pallas(
            js, pack_light_vertices(_jax_lv(d)), nv, hit.pos, hit.normal, tp,
            hit.mtl, -rd, wo_s, eye_f, act, clamp_val=jcfg.clamp,
            dielectrics_block=True))
    finally:
        jax.clear_caches()

    def t(x):
        return torch.from_numpy(np.array(x))

    m = Material(*(t(getattr(hit.mtl, f)) for f in MTL_FIELDS))
    got = cuda_connect.connect_plain(
        pack_scene(ts), cuda_connect.pack_light_vertices(_port_lv(d)), nv,
        t(hit.pos), t(hit.normal), t(tp), m, t(-rd), t(wo_s), t(eye_f),
        t(act), clamp_val=15.0, dielectrics_block=True).numpy()
    return got, np.asarray(act), (ref, kern)


# ---- steps 12-15: the eye pass and the renders ----

def _jax_render(js, jc, cfg, seed, monkeypatch, spp=2, oracle=False,
                mega=False):
    monkeypatch.setenv("PT_TPU_INTERPRET", "1")
    if not mega:
        monkeypatch.setenv("PT_TPU_NO_BDPT_MEGAKERNEL", "1")
    jax.clear_caches()
    try:
        if oracle:
            return np.asarray(jb.render_oracle(js, jc, cfg["width"],
                                               cfg["height"], spp, SPL,
                                               JConfig(**cfg), seed=seed))
        return np.asarray(jb.render_bdpt(js, jc, cfg["width"], cfg["height"],
                                         spp, SPL, JConfig(**cfg),
                                         jax.random.PRNGKey(seed)))
    finally:
        jax.clear_caches()


def _render_bar(ref, img):
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(ref.mean() - img.mean()) / ref.mean() < 1e-3
    rel = np.abs(ref - img) / (np.abs(ref) + 1e-3)
    assert (rel.max(axis=1) < 1e-3).mean() >= 0.97


@pytest.mark.parametrize("tier,K", [("plain", 0), ("fused", 0), ("plain", 4),
                                    ("fused", 4)])
def test_render_bdpt_matches_jax_scan_tier(tier, K, monkeypatch):
    js, jc, ts, tc = jax_cornell(W, H)
    cfg = dict(CFG, bdpt_resample_vertices=K)
    img = bdpt.render_bdpt(ts, tc, W, H, 2, SPL, RenderConfig(**cfg),
                           rng.prng_key(0), tier=tier).numpy()
    assert img.mean() > 0.1
    _render_bar(_jax_render(js, jc, cfg, 0, monkeypatch), img)


def test_mega_plain_equals_scan_tier():
    """With a shared table the mega tier's plain version (bdpt_eye_plain)
    is the per-bounce loop, sample after sample: bit-equal on the CPU."""
    _, _, ts, tc = jax_cornell(8, 8)
    cfg = RenderConfig(**dict(CFG, width=8, height=8))
    imgs = [bdpt.render_bdpt(ts, tc, 8, 8, 2, SPL, cfg, rng.prng_key(1),
                             tier=t) for t in ("auto", "mega", "fused",
                                               "plain")]
    for img in imgs[1:]:
        assert torch.equal(imgs[0], img)


def test_bdpt_eye_tiled_table_identity(monkeypatch):
    """A (T, Kp, 40) table whose tiles all hold the shared table's rows
    renders bit-identically (tests/test_pallas_interpret.py's check of the
    JAX megakernel's tile plumbing)."""
    _, _, ts, tc = jax_cornell(16, 12)
    cfg = RenderConfig(**CFG)
    key = rng.prng_key(5)
    lv = bdpt.trace_light_paths(ts, cfg, ts.num_lights * 4, 4, key)
    lv_flat, nv = bdpt.compact_flat(lv.flat())
    tab = cuda_connect.pack_light_vertices(lv_flat)
    B = 16 * 12
    idx = torch.arange(B, dtype=torch.int32)
    pk = pack_scene(ts)
    # three tiles of 64 pixels at this size
    monkeypatch.setattr(bdpt, "TILE_LANES", 64)
    tiled = tab[None].expand(3, *tab.shape).contiguous()
    a = cuda_bdpt_eye.bdpt_eye(pk, tab, nv, tc, idx % 16, idx // 16, 2, cfg,
                               key, 1.0)
    b = cuda_bdpt_eye.bdpt_eye(pk, tiled, nv, tc, idx % 16, idx // 16, 2,
                               cfg, key, 1.0)
    assert a.sum() > 0 and torch.equal(a, b)


def test_mega_matches_jax_megakernel_in_distribution(monkeypatch):
    """Against the JAX megakernel (``bdpt_eye_pallas`` in interpret mode),
    which draws its eye paths from a counter hash in place of the TPU's
    on-core PRNG: only the estimate can agree.  Same light paths (the
    light trace draws Threefry in both).  On the diffuse box at 64x64 spp
    16 the standard error of the mean of the per-pixel difference measured
    0.81-0.95% of the mean over seeds 0-2, and the means differed by
    0.04-1.3%; the bar is 5%, about five standard errors."""
    n, spp = 64, 16
    js, jc, ts, tc = _scenes("diffuse_box", n, n)
    cfg = dict(CFG, width=n, height=n)
    img = bdpt.render_bdpt(ts, tc, n, n, spp, SPL, RenderConfig(**cfg),
                           rng.prng_key(0), tier="mega").numpy()
    ref = _jax_render(js, jc, cfg, 0, monkeypatch, spp=spp, mega=True)
    assert np.isfinite(ref).all() and np.isfinite(img).all()
    assert abs(ref.mean() - img.mean()) / ref.mean() < 0.05
    for half in (slice(0, n * n // 2), slice(n * n // 2, n * n)):
        a, b = ref[half].mean(), img[half].mean()
        assert abs(a - b) / a < 0.08


def test_render_oracle_reproducible_and_matches_jax(monkeypatch):
    js, jc, ts, tc = jax_cornell(W, H)
    a = bdpt.render_oracle(ts, tc, W, H, 2, SPL, RenderConfig(**CFG),
                           seed=11)
    b = bdpt.render_oracle(ts, tc, W, H, 2, SPL, RenderConfig(**CFG),
                           seed=11)
    assert torch.equal(a, b) and a.mean() > 0.05
    c = bdpt.render_oracle(ts, tc, W, H, 2, SPL, RenderConfig(**CFG),
                           seed=12)
    assert not torch.equal(a, c)
    _render_bar(_jax_render(js, jc, CFG, 11, monkeypatch, oracle=True),
                a.numpy())


def test_resolve_tier():
    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**CFG)
    assert bdpt.resolve_tier(ts, "auto", cfg) == "mega"
    for t in ("mega", "fused", "plain"):
        assert bdpt.resolve_tier(ts, t, cfg) == t
    with pytest.raises(ValueError, match="split"):
        bdpt.resolve_tier(ts, "split", cfg)
    # sampled connections take the fused tier (#8's sampled instance), as
    # the JAX package keeps them off its megakernel
    sampled = cfg.with_(bdpt_connection_samples=4)
    assert bdpt.resolve_tier(ts, "auto", sampled) == "fused"
    for t in ("fused", "plain"):
        assert bdpt.resolve_tier(ts, t, sampled) == t
    with pytest.raises(ValueError, match="mega"):
        bdpt.resolve_tier(ts, "mega", sampled)


def test_kernel_wrappers_refuse_tensors_off_cpu():
    """CPU tensors take the plain versions; any other tensor goes to the
    kernel path, which checks the device and raises (meta tensors stand in
    for a device here)."""
    _, _, ts, tc = jax_cornell(4, 4)
    pk = pack_scene(ts)
    B = 16
    z3 = torch.zeros(B, 3, device="meta")
    z = torch.zeros(B, device="meta")
    m = Material(z3, z, z, z)
    tab = torch.zeros(8, 40)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_connect.connect(pk, tab, 0, z3, z3, z3, m, z3, z3, z,
                             torch.zeros(B, dtype=torch.bool, device="meta"),
                             clamp_val=15.0, dielectrics_block=True)
    px = torch.zeros(B, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bdpt_eye.bdpt_eye(pk, tab, 0, tc, px, px, 1,
                               RenderConfig(**CFG), rng.prng_key(0), 1.0)
    with pytest.raises(ValueError, match="Threefry"):
        cuda_bdpt_eye.bdpt_eye(pk, tab, 0, tc, px, px, 1,
                               RenderConfig(**CFG), rng.prng_key(0), 1.0,
                               total=2 ** 31)


# ---- step 16: the CLI ----

def test_cli_bdpt_writes_png(tmp_path, capsys):
    from path_tracing_tpu_torch.film import read_png

    out = tmp_path / "b.png"
    res = cli.run(["--input", str(CORNELL), "--mode", "bdpt", "--spp", "1",
                   "--spl", "2", "--light-depth", "3", "--width", "12",
                   "--height", "8", "--device", "cpu", "--output", str(out)])
    assert res["tier"] == "mega" and res["image"].shape == (96, 3)
    assert np.isfinite(res["image"]).all() and res["image"].mean() > 0
    assert read_png(str(out)).shape == (8, 12, 3)
    assert "bdpt (mega tier)" in capsys.readouterr().out


def test_cli_bdpt_frame_keys_match_render_bdpt(tmp_path):
    """Frame i renders from fold_in(PRNGKey(seed), i) with the CLI's flags
    (--resample K, --tier): the CLI image is render_bdpt's."""
    res = cli.run(["--input", str(CORNELL), "--mode", "bdpt", "--spp", "1",
                   "--spl", "2", "--width", "8", "--height", "6",
                   "--eye-depth", "3", "--light-depth", "3", "--resample",
                   "4", "--tier", "fused", "--seed", "3", "--device", "cpu",
                   "--output", str(tmp_path / "k.png")])
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 8, 6, device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=1, spl=2, eye_depth=3,
                       light_depth=3, seed=3, bdpt_resample_vertices=4)
    img = bdpt.render_bdpt(p.to_device("cpu"), cam, 8, 6, 1, 2, cfg,
                           rng.fold_in(rng.prng_key(3), 0), tier="fused")
    np.testing.assert_array_equal(res["image"], img.numpy())


def test_cli_bdpt_split_tier_exits_nonzero(tmp_path, capsys):
    out = tmp_path / "b.png"
    rc = cli.main(["--input", str(CORNELL), "--mode", "bdpt", "--tier",
                   "split", "--device", "cpu", "--spp", "1", "--width", "4",
                   "--height", "4", "--output", str(out)])
    assert rc != 0 and not out.exists()
    assert "BDPT has no tier 'split'" in capsys.readouterr().err
