"""The PPM slice of the PyTorch port against the JAX package, module by
module and end to end, at a small size on cornell and on the diffuse box of
``tests/test_ppm_oracle.py``.

Inputs are made from a seed with numpy, and scenes are carried across with
``scene_from_jax_arrays``.  The JAX package's exact gather runs as its
Pallas kernel in interpret mode (``gather_flux_pallas(interpret=True)``,
with ``PT_TPU_PPM_EVCHUNK=128`` so that its unrolled body compiles in
seconds; the chunk sets only how the kernel fetches events, and the event
caps tested are multiples of both chunks), its photon trace as its XLA
scan (``PT_TPU_NO_PHOTON_MEGA=1``) or as its megakernel in interpret mode
(``PT_TPU_INTERPRET=1``), with ``jax.clear_caches`` around every change of
those knobs.  Bars, each with its reason:

- cell size, keys and the radius schedule: exactly equal (integer keys of
  the same float32 arithmetic);
- the gather on matched inputs: counts and overflow equal, flux within rtol
  2e-3 / atol 1e-5, the JAX package's own bar for its kernel against its
  all-pairs oracle (``tests/test_ppm_gather_kernel.py``: smooth GGX lobes
  amplify last-ulp differences in the half vector, and the TPU kernel takes
  the local frame through a matrix product);
- the photon trace against the scan: the same number of valid events per
  photon on >= 99.9% of photons and in all within 0.1% (so no deposit
  overwrote another in its depth slot: a transcendental one ulp apart can
  flip a branch on a rare photon, ROADMAP rule; measured: one photon of
  4096, 2 events against 3), and the events of the other photons, lane
  for lane in the order they were made, with all fields within rtol 1e-3
  / atol 1e-5 on >= 99.5% of them and within rtol 1e-5 / atol 1e-6 on >=
  90%: XLA's CPU backend rounds the BSDF sample's products and
  transcendentals an ulp apart from torch's, and the glass, diamond and
  mirror bounces of cornell amplify that ulp (measured 99.86% and 93.1%;
  with the JAX package's interpret-mode nearest hit too, and with both
  traces started from the JAX emission, the same; the kernel against its
  plain version is held bit for bit on the card);
- against the megakernel's counter-hash stream: valid-event count and total
  flux within 5% (the bar of ``tests/test_pallas_interpret.py``, at its
  light depth 3 and delta budget 2: at depth 4 and budget 8 cornell's
  caustic photons make the total flux heavy-tailed, 5-15% apart between
  seeds in the JAX package's own two streams);
- the eye pass: direct term exact to rtol 1e-5 / atol 1e-6 on >= 99% of
  lanes, valid flags equal on >= 99%, hitpoint fields within rtol 1e-5 /
  atol 1e-6 on >= 99% of lanes whose first hit is rough, and within rtol
  1e-3 / atol 1e-5 on >= 99% of all: behind the mirror wall and through the
  glass spheres a delta chain amplifies the JAX package's ulp-level
  difference (XLA's CPU backend contracts products into FMAs, ROADMAP
  queue 3) to ~1e-4 relative (measured on 37 of 382 chain lanes);
- a whole pass: image within rtol 1e-3 / atol 1e-5 on >= 99% of pixels,
  mean within 1e-3 relative, overflow equal;
- the NumPy oracle (an independent estimator with its own RNG): the bars of
  ``tests/test_ppm_oracle.py``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import ppm as jppm
from path_tracing_tpu.ops import pallas_ppm_gather as jgather
from path_tracing_tpu.ops.math3 import PI as JPI
from path_tracing_tpu.ops.math3 import clamp_radiance, is_valid_color
from path_tracing_tpu.scene.types import Material as JMaterial
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import ppm
from path_tracing_tpu_torch.ops import _kernels, cuda_photon, cuda_ppm_eye, rng
from path_tracing_tpu_torch.ops import cuda_ppm_gather as gather
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.ops.cuda_ppm_eye import eye_pass_bits
from path_tracing_tpu_torch.scene.types import Material, scene_from_jax_arrays

from test_torch_scene import CORNELL, jax_arrays, jax_cornell

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ppm_gather_kernel import _random_problem  # noqa: E402

MTL = ("base_color", "roughness", "metallic", "eta")
HP = ("pos", "normal", "wo", "throughput", "valid")
EV = ("pos", "normal", "wi", "flux")
W, H = 32, 24
PHOTONS, PHOTON_SPL = 4096, 1024          # cornell: 4 lights x 1024
TRACE_CFG = dict(light_depth=4, delta_budget=8)


@pytest.fixture()
def jax_knobs(monkeypatch):
    """Set the JAX package's trace-time knobs, clearing its caches around
    every change; the knobs and caches are restored afterwards."""
    def set_knobs(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jax.clear_caches()

    yield set_knobs
    monkeypatch.undo()
    jax.clear_caches()


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_hp(hp) -> ppm.HitPoints:
    return ppm.HitPoints(
        mtl=Material(**{f: _t(getattr(hp.mtl, f)) for f in MTL}),
        **{f: _t(getattr(hp, f)) for f in HP})


def _port_events(ev) -> ppm.PhotonEvents:
    return ppm.PhotonEvents.from_fields(
        *(_t(getattr(ev, f)) for f in EV), _t(ev.valid))


def _jax_events(ev) -> jppm.PhotonEvents:
    return jppm.PhotonEvents(
        **{f: jnp.asarray(getattr(ev, f).numpy()) for f in EV},
        valid=jnp.asarray(ev.valid.numpy()))


# ---- 1: cell size, keys, radius schedule ----

@pytest.mark.parametrize("radius", [0.05, 0.002])
def test_cell_size_and_keys_match_jax(radius):
    """Radius-sized cells, and cells grown to extent / 196 when the radius
    is smaller; positions up to half the box outside the domain clip."""
    js, _, ts, _ = jax_cornell(4, 4)
    cfg = dict(width=4, height=4, ppm_radius=radius)
    a = jgather._cell_size(js, JConfig(**cfg))
    b = gather._cell_size(ts, RenderConfig(**cfg))
    assert np.float32(a) == b.item()
    lo, hi = np.asarray(js.scene_min), np.asarray(js.scene_max)
    rs = np.random.RandomState(int(radius * 1e4))
    pos = (lo - 0.5 * (hi - lo) + rs.rand(4096, 3) * 2.0 * (hi - lo)).astype(
        np.float32)
    ka = np.asarray(jgather._keys(jnp.asarray(pos), js.scene_min, a))
    kb = gather._keys(torch.from_numpy(pos), ts.scene_min, b).numpy()
    np.testing.assert_array_equal(ka, kb)
    assert (ka == 0).any()                       # clipped below
    if radius < 0.01:                            # and above, in grown cells
        assert (ka // gather.G ** 2 == gather.G - 1).any()


def test_radius_schedule_matches_jax():
    for alpha in (0.0, 0.5, 0.7, 1.0):
        for i in range(6):
            assert ppm.ppm_radius_scale(i, alpha) == jppm.ppm_radius_scale(
                i, alpha)


# ---- 2: the gather on matched inputs ----

def _degenerate_problem(js):
    """One hitpoint and two events inside its radius, one with wi = 0
    (a NaN half vector): tests/test_ppm_gather_kernel.py's case."""
    lo = np.asarray(js.scene_min)
    hp_pos = (lo + 0.5 * (np.asarray(js.scene_max) - lo))[None, :].astype(
        np.float32)
    up = np.array([[0.0, 1.0, 0.0]], np.float32)
    hp = jppm.HitPoints(
        pos=jnp.asarray(hp_pos), normal=jnp.asarray(up), wo=jnp.asarray(up),
        mtl=JMaterial(base_color=jnp.full((1, 3), 0.5),
                      roughness=jnp.full((1,), 0.8),
                      metallic=jnp.zeros((1,)), eta=jnp.zeros((1,))),
        throughput=jnp.ones((1, 3)), valid=jnp.ones((1,), bool))
    ev_pos = np.repeat(hp_pos, 2, axis=0) + np.array(
        [[0.01, 0, 0], [-0.01, 0, 0]], np.float32)
    ev = jppm.PhotonEvents(
        pos=jnp.asarray(ev_pos), normal=jnp.asarray(np.repeat(up, 2, 0)),
        wi=jnp.asarray([[0.6, 0.8, 0.0], [0.0, 0.0, 0.0]], jnp.float32),
        flux=jnp.ones((2, 3)), valid=jnp.ones((2,), bool))
    return hp, ev


# case: (seed, B, E, sigma, r2_scale, event cap fraction, max_cells)
GATHER_CASES = {
    "random": (7, 24, 400, 0.03, 1.0, 1.0, 32),
    "shrunk_radius": (11, 24, 300, 0.03, 0.4, 1.0, 32),
    "event_cap": (5, 16, 4096, 0.03, 1.0, 0.25, 32),
    "cell_cap": (3, 24, 100, 0.2, 1.0, 1.0, 4),
    "degenerate_wi": None,
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_plain_matches_pallas(case, jax_knobs):
    js, _, ts, _ = jax_cornell(4, 4)
    spec = GATHER_CASES[case]
    if spec is None:
        hp, ev = _degenerate_problem(js)
        r2_scale, frac, cells = 1.0, 1.0, 8
    else:
        seed, B, E, sigma, r2_scale, frac, cells = spec
        hp, ev = _random_problem(np.random.RandomState(seed), js, B, E,
                                 sigma)
        if case == "event_cap":   # every event valid: the cap bites
            ev = jppm.PhotonEvents(pos=ev.pos, normal=ev.normal, wi=ev.wi,
                                   flux=ev.flux, valid=jnp.ones(E, bool))
    cfg = dict(width=16, height=16, ppm_event_cap_frac=frac)
    jax_knobs(PT_TPU_PPM_EVCHUNK="128")
    fa, ca, oa = jgather.gather_flux_pallas(
        js, JConfig(**cfg), hp, ev, r2_scale, max_cells=cells,
        interpret=True)
    fb, cb, ob = gather.gather_flux_plain(
        ts, RenderConfig(**cfg), _port_hp(hp), _port_events(ev), r2_scale,
        max_cells=cells)
    assert int(oa) == int(ob)
    np.testing.assert_array_equal(np.asarray(ca), cb.numpy())
    assert np.isfinite(fb.numpy()).all()
    np.testing.assert_allclose(np.asarray(fa), fb.numpy(), rtol=2e-3,
                               atol=1e-5)
    if case == "event_cap":
        assert int(ob) == 4096 - 1024
    elif case == "cell_cap":
        assert int(ob) > 0
    elif case == "degenerate_wi":
        assert cb[0].item() >= 1 and fb[0].sum().item() > 0.0
    else:
        assert int(ob) == 0 and cb.sum().item() > 20


def test_gather_candidate_pairs():
    """``candidate_pairs`` counts the windows' events of the gathered rows,
    no fewer than the pairs the join accepts."""
    js, _, ts, _ = jax_cornell(4, 4)
    hp, ev = _random_problem(np.random.RandomState(2), js, 64, 2000, 0.05)
    t = gather.prepare(ts, RenderConfig(), _port_hp(hp), _port_events(ev))
    _, count = gather.join_plain(t)
    lens = t.win[:, 1::2] - t.win[:, 0::2]
    cells = t.hp_cell[t.hp_cell >= 0].long()
    assert t.candidate_pairs() == int(lens[cells].sum())
    assert t.candidate_pairs() > int(count.sum()) > 0


# ---- 3-4: the photon trace ----

def _photon_key(seed=1):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2),
            rng.fold_in(rng.prng_key(seed), 2))


def _per_lane(ev: dict, valid, P):
    """Each photon's valid events in the order it made them (rows grow with
    the iteration, or with the depth, as the photon bounces), and the
    number of them per photon."""
    r = np.nonzero(valid)[0]
    r = r[np.lexsort((r // P, r % P))]
    return r % P, {k: v[r] for k, v in ev.items()}, np.bincount(r % P,
                                                                 minlength=P)


def test_photon_trace_matches_xla_scan(jax_knobs):
    js, _, ts, _ = jax_cornell(4, 4)
    jkey, tkey = _photon_key()
    jax_knobs(PT_TPU_NO_PHOTON_MEGA="1")
    a = jppm.ppm_photon_trace(js, JConfig(**TRACE_CFG), PHOTONS, PHOTON_SPL,
                              jkey)
    b = ppm.ppm_photon_trace(ts, RenderConfig(**TRACE_CFG), PHOTONS,
                             PHOTON_SPL, tkey)
    cfg = RenderConfig(**TRACE_CFG)
    slots = cuda_photon.event_slots(cfg.light_depth, cfg.max_light_iters)
    assert b.table.shape == (slots * PHOTONS, 12)
    va, vb = np.asarray(a.valid), b.valid.numpy()
    assert vb.sum() > 2 * PHOTONS
    assert abs(int(va.sum()) - int(vb.sum())) <= 1e-3 * va.sum()
    la, ea, na = _per_lane({f: np.asarray(getattr(a, f)) for f in EV}, va,
                           PHOTONS)
    lb, eb, nb = _per_lane({f: getattr(b, f).numpy() for f in EV}, vb,
                           PHOTONS)
    same = na == nb
    assert same.mean() >= 0.999, np.nonzero(~same)
    ka, kb = same[la], same[lb]
    tight = np.ones(int(ka.sum()), bool)
    loose = tight.copy()
    for f in EV:
        x, y = ea[f][ka], eb[f][kb]
        tight &= np.isclose(x, y, rtol=1e-5, atol=1e-6).all(axis=1)
        loose &= np.isclose(x, y, rtol=1e-3, atol=1e-5).all(axis=1)
    assert loose.mean() >= 0.995, loose.mean()
    assert tight.mean() >= 0.9, tight.mean()


def test_photon_trace_statistical_vs_jax_megakernel(jax_knobs):
    js, _, ts, _ = jax_cornell(4, 4)
    jkey, tkey = _photon_key(1)
    cfg = dict(light_depth=3, delta_budget=2)
    jax_knobs(PT_TPU_INTERPRET="1")
    a = jppm.ppm_photon_trace(js, JConfig(**cfg), PHOTONS, PHOTON_SPL, jkey)
    b = ppm.ppm_photon_trace(ts, RenderConfig(**cfg), PHOTONS, PHOTON_SPL,
                             tkey)
    va, vb = np.asarray(a.valid), b.valid.numpy()
    fa, fb = np.asarray(a.flux)[va], b.flux.numpy()[vb]
    assert np.isfinite(fb).all()
    assert abs(int(va.sum()) - int(vb.sum())) / va.sum() < 0.05
    assert abs(fa.sum() - fb.sum()) / fa.sum() < 0.05


def test_photon_trace_window_is_slice_of_full_pass():
    """Photons [start, start + P) of a total-photon pass are those rows of
    the whole pass (light index and Threefry counters are global)."""
    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(**TRACE_CFG)
    key = rng.prng_key(5)
    full = ppm.ppm_photon_trace(ts, cfg, 256, 64, key)
    part = ppm.ppm_photon_trace(ts, cfg, 96, 64, key, start=128, total=256)
    slots = cuda_photon.event_slots(cfg.light_depth, cfg.max_light_iters)
    for s in range(slots):
        rows = slice(s * 256 + 128, s * 256 + 224)
        assert torch.equal(part.valid[s * 96:(s + 1) * 96], full.valid[rows])
        assert torch.equal(part.table[s * 96:(s + 1) * 96], full.table[rows])


# ---- 5-6: the eye pass and one whole pass ----

def _pixels(w, h):
    idx = np.arange(w * h, dtype=np.int32)
    return idx % w, idx // w


def test_eye_trace_matches_jax():
    js, jc, ts, tc = jax_cornell(W, H)
    px, py = _pixels(W, H)
    cfg = dict(width=W, height=H)
    key = 9
    da, ha = jppm.ppm_eye_trace(js, jc, JConfig(**cfg), jnp.asarray(px),
                                jnp.asarray(py),
                                jax.random.fold_in(jax.random.PRNGKey(key), 1))
    db, hb = ppm.ppm_eye_trace(ts, tc, RenderConfig(**cfg), _t(px), _t(py),
                               rng.fold_in(rng.prng_key(key), 1))
    valid_same = np.asarray(ha.valid) == hb.valid.numpy()
    assert valid_same.mean() >= 0.99 and hb.valid.float().mean() > 0.5
    both = np.asarray(ha.valid) & hb.valid.numpy()

    def share(x, y, mask):
        x, y = np.asarray(x), np.asarray(y)
        ok = np.isclose(x, y, rtol=1e-5, atol=1e-6)
        ok = ok.all(axis=1) if ok.ndim > 1 else ok
        return ok[mask].mean()

    assert share(da, db.numpy(), np.ones(W * H, bool)) >= 0.99
    assert (db.numpy() > 0).any()      # the chains reach the light balls
    rough_first = both & (np.asarray(ha.throughput) == 1.0).all(axis=1)
    assert rough_first.sum() > 0.3 * both.sum()
    fields = [(getattr(ha, f), getattr(hb, f)) for f in
              ("pos", "normal", "wo", "throughput")]
    fields += [(getattr(ha.mtl, f), getattr(hb.mtl, f)) for f in MTL]
    for x, y in fields:
        x, y = np.asarray(x), y.numpy()
        assert share(x, y, rough_first) >= 0.99
        loose = np.isclose(x, y, rtol=1e-3, atol=1e-5)
        loose = loose.all(axis=1) if loose.ndim > 1 else loose
        assert loose[both].mean() >= 0.99


def _jax_pass(js, jc, cfg, key, r2_scale):
    """One JAX PPM pass assembled as ``render_ppm_with_stats`` assembles it
    (ppm.py:448-461), with the exact Pallas gather in interpret mode."""
    px, py = _pixels(cfg.width, cfg.height)
    direct, hp = jppm.ppm_eye_trace(js, jc, cfg, jnp.asarray(px),
                                    jnp.asarray(py),
                                    jax.random.fold_in(key, 1))
    events = jppm.ppm_photon_trace(js, cfg, js.num_lights * cfg.spl, cfg.spl,
                                   jax.random.fold_in(key, 2))
    flux, count, overflow = jgather.gather_flux_pallas(
        js, cfg, hp, events, r2_scale, interpret=True)
    radiance = flux / jnp.maximum(
        JPI * cfg.ppm_radius * cfg.ppm_radius * jnp.float32(r2_scale), 1e-6)
    radiance = jnp.where((hp.valid & is_valid_color(radiance))[:, None],
                         clamp_radiance(radiance, cfg.clamp), 0.0)
    return np.asarray(direct + radiance), np.asarray(count), int(overflow)


@pytest.mark.parametrize("pass_index", [0, 1])
def test_render_pass_matches_jax(pass_index, jax_knobs):
    """Passes 0 and 1 of 32x24 at spl 1024 with the radius shrinking at
    alpha 0.5; the JAX gather covers at most 1024 cells (768 hitpoints)."""
    js, jc, ts, tc = jax_cornell(W, H)
    cfg = dict(width=W, height=H, spl=PHOTON_SPL, ppm_alpha=0.5,
               ppm_max_cells=1024)
    scale = ppm.ppm_radius_scale(pass_index, 0.5)
    jax_knobs(PT_TPU_NO_PHOTON_MEGA="1", PT_TPU_PPM_EVCHUNK="128")
    a, ca, oa = _jax_pass(
        js, jc, JConfig(**cfg),
        jax.random.fold_in(jax.random.PRNGKey(0), pass_index), scale)
    b, cb, ob = ppm.render_ppm_with_stats(
        ts, tc, W, H, PHOTON_SPL, RenderConfig(**cfg),
        rng.fold_in(rng.prng_key(0), pass_index), scale)
    b = b.numpy()
    assert oa == int(ob) == 0
    assert np.isfinite(b).all() and b.mean() > 0.0
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-3
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert (ca == cb.numpy()).mean() >= 0.99


def test_render_tiers_identical_on_cpu():
    _, _, ts, tc = jax_cornell(8, 6)
    cfg = RenderConfig(width=8, height=6, spl=64)
    imgs = [ppm.render_ppm(ts, tc, 8, 6, 64, cfg, rng.prng_key(2), tier=t)
            for t in ("auto", "mega", "plain")]
    assert torch.equal(imgs[0], imgs[1]) and torch.equal(imgs[0], imgs[2])


# ---- 7: the NumPy oracle ----

def test_port_matches_numpy_oracle():
    from ppm_numpy_oracle import render_ppm_numpy
    from test_ppm_oracle import H as OH
    from test_ppm_oracle import RADIUS
    from test_ppm_oracle import W as OW
    from test_ppm_oracle import _box_scene

    scene, cam, np_scene, np_cam = _box_scene()
    ts, tc = scene_from_jax_arrays(jax_arrays(scene, cam), "cpu")
    cfg = RenderConfig(width=OW, height=OH, eye_depth=4, light_depth=4,
                       delta_budget=0, ppm_radius=RADIUS)
    spl, passes = 4096, 4
    img = np.zeros((OW * OH, 3))
    ref = np.zeros((OW * OH, 3))
    for i in range(passes):
        img += ppm.render_ppm(ts, tc, OW, OH, spl, cfg,
                              rng.prng_key(7 + i)).numpy()
        ref += render_ppm_numpy(np_scene, np_cam, OW, OH, spl, RADIUS,
                                eye_depth=4, light_depth=4, seed=11 + i)
    img /= passes
    ref /= passes
    assert np.isfinite(img).all()
    c_img = float(np.clip(img, 0, 1).mean())
    c_ref = float(np.clip(ref, 0, 1).mean())
    assert c_ref > 0.05
    assert abs(c_img - c_ref) / c_ref < 0.05, (c_img, c_ref)
    m_img, m_ref = float(img.mean()), float(ref.mean())
    assert abs(m_img - m_ref) / m_ref < 0.35, (m_img, m_ref)
    rmse = float(np.sqrt(np.mean((np.clip(img, 0, 1)
                                  - np.clip(ref, 0, 1)) ** 2)))
    assert rmse < 0.25 * c_ref, (rmse, c_ref)


# ---- 8: tiers, wrappers and the CLI ----

def test_resolve_tier():
    _, _, ts, _ = jax_cornell(4, 4)
    assert ppm.resolve_tier(ts, "auto") == "mega"
    for t in ("mega", "plain"):
        assert ppm.resolve_tier(ts, t) == t
    with pytest.raises(ValueError, match="fused"):
        ppm.resolve_tier(ts, "fused")


def test_kernel_wrappers_refuse_tensors_off_cpu():
    """Tensors off the CPU go to the kernels, whose wrappers check the
    device and raise (meta tensors stand in for a device here)."""
    _, _, ts, _ = jax_cornell(4, 4)
    pk = pack_scene(ts)
    z3 = torch.zeros(16, 3, device="meta")
    real = torch.ones(16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_photon.photon_trace(pk, z3, z3, z3, real, rng.prng_key(0), 4, 12)
    with pytest.raises(ValueError, match="Threefry"):
        cuda_photon.photon_trace(pk, z3, z3, z3, real, rng.prng_key(0), 4, 12,
                                 total=2 ** 31)
    i32 = dict(dtype=torch.int32, device="meta")
    t = gather.GatherTables(
        hp=torch.zeros(16, 20, device="meta"), hp_cell=torch.zeros(16, **i32),
        perm=torch.zeros(16, **i32), win=torch.zeros(4, 18, **i32),
        ev=torch.zeros(8, 12, device="meta"), r2=0.0025,
        overflow=torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        gather.join(t)


EYE_REFUSALS = {
    "device": ("CUDA", lambda px: dict(px=px, py=px)),
    "dtype": ("CUDA", lambda px: dict(px=px.long(), py=px)),
    "contiguity": ("CUDA", lambda px: dict(
        px=torch.zeros(32, dtype=torch.int32, device="meta")[::2], py=px)),
    "window": ("Threefry", lambda px: dict(px=px, py=px, start=8, total=20)),
}


@pytest.mark.parametrize("case", sorted(EYE_REFUSALS))
def test_ppm_eye_wrapper_refuses_what_its_kernel_does_not_take(case):
    """Tensors off the CPU go to ``ppm_eye``'s kernel, whose wrapper raises
    on lane tensors off a CUDA device, whatever their type or layout (the
    card tests hold it to its dtype, shape and layout messages), or on a
    window past its pass (meta tensors stand in for a device here)."""
    _, _, ts, tc = jax_cornell(4, 4)
    match, make = EYE_REFUSALS[case]
    kw = make(torch.zeros(16, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=match):
        cuda_ppm_eye.ppm_eye(pack_scene(ts), tc, RenderConfig(width=4,
                                                              height=4),
                             kw.pop("px"), kw.pop("py"), rng.prng_key(0),
                             **kw)


@pytest.mark.parametrize("lo,n", [(0, 256), (200, 300), (700, 68)])
def test_eye_loop_window_equals_the_slice_of_the_full_pass(lo, n):
    """Lanes [lo, lo + n) of a pass run alone with ``start=lo`` and the
    pass's ``total`` give the full pass's rows, bit for bit: every draw is
    a function of the lane's column, and a chain of its own lane."""
    _, _, ts, tc = jax_cornell(W, H)
    px, py = (_t(x) for x in _pixels(W, H))
    args = (pack_scene(ts), tc, RenderConfig(width=W, height=H))
    key = rng.fold_in(rng.prng_key(5), 1)
    full = cuda_ppm_eye.ppm_eye_plain(*args, px, py, key)
    part = cuda_ppm_eye.ppm_eye_plain(*args, px[lo:lo + n], py[lo:lo + n],
                                      key, start=lo, total=W * H)
    assert torch.equal(eye_pass_bits(full)[lo:lo + n], eye_pass_bits(part))
    assert bool(part[1].valid.any())


def test_eye_loop_counts_the_kernels_work():
    """Given ``counts``, the loop walks on the plain nearest hit, whose
    rows equal the wrapper's, and counts the kernel's work: a walk a chain
    link (the links of iteration 0 are the pixels), a sample and three
    draws a delta link beside two jitter draws a pixel, one hitpoint a
    deposit; the walk's tests equal the plain nearest hit's counts of the
    same rays."""
    from path_tracing_tpu_torch.ops import cuda_connect, cuda_intersect

    _, _, ts, tc = jax_cornell(W, H)
    px, py = (_t(x) for x in _pixels(W, H))
    pk = pack_scene(ts)
    args = (pk, tc, RenderConfig(width=W, height=H), px, py,
            rng.fold_in(rng.prng_key(5), 1))
    rays = []
    own = cuda_intersect.nearest_hit_plain

    def record(packed, ro, rd, with_uv=False, live=None, counts=None):
        rays.append((ro.clone(), rd.clone(), live.clone()))
        return own(packed, ro, rd, with_uv, live, counts)

    c = cuda_ppm_eye.new_counts()
    cuda_ppm_eye.nearest_hit_plain = record
    try:
        out = cuda_ppm_eye.ppm_eye_plain(*args, counts=c)
    finally:
        cuda_ppm_eye.nearest_hit_plain = own
    assert torch.equal(eye_pass_bits(out),
                       eye_pass_bits(cuda_ppm_eye.ppm_eye_plain(*args)))
    B = W * H
    assert c["pixels"] == B and c["deposits"] == int(out[1].valid.sum())
    assert c["links"] == sum(int(live.sum()) for _, _, live in rays) > B
    # every link after a chain's first follows a delta sample
    assert c["links"] - B <= c["bsdf_samples"] < c["links"]
    assert c["draws"] == 2 * B + 3 * c["bsdf_samples"]
    assert 0 < c["iteration_keys"] <= len(rays)
    walk = cuda_connect.new_counts()
    for ro, rd, live in rays:
        own(pk, ro, rd, live=live, counts=walk)
    assert all(c[k] == walk[k] > 0
               for k in ("hit_spheres", "hit_boxes", "hit_tris"))


def test_cli_ppm_writes_png_deterministically(tmp_path, capsys):
    from path_tracing_tpu_torch.film import read_png

    def run(seed, name):
        return cli.run(["--input", str(CORNELL), "--mode", "ppm", "--spl",
                        "256", "--iters", "2", "--ppm-alpha", "0.5",
                        "--width", str(W), "--height", str(H), "--seed",
                        str(seed), "--device", "cpu", "--output",
                        str(tmp_path / name)])

    _kernels.reset_counts()
    a = run(3, "a.png")
    assert _kernels.plain_calls["photon_trace"] == 2
    assert _kernels.plain_calls["gather_flux"] == 2
    out = capsys.readouterr().out
    assert "ppm (mega tier)" in out and "Mphotons/s" in out
    assert a["image"].shape == (W * H, 3) and np.isfinite(a["image"]).all()
    assert a["image"].mean() > 0.0
    assert read_png(str(tmp_path / "a.png")).shape == (H, W, 3)
    np.testing.assert_array_equal(a["image"], run(3, "b.png")["image"])
    assert not np.array_equal(a["image"], run(4, "c.png")["image"])
    # pass i renders from fold_in(PRNGKey(seed), i) with pass i's radius
    _, _, ts, tc = jax_cornell(W, H)
    cfg = RenderConfig(width=W, height=H, ppm_alpha=0.5)
    frames = [ppm.render_ppm(ts, tc, W, H, 256, cfg,
                             rng.fold_in(rng.prng_key(3), i), pass_index=i)
              for i in range(2)]
    np.testing.assert_array_equal(a["image"],
                                  ((frames[0] + frames[1]) / 2).numpy())


def test_cli_ppm_textured_scene_exits_nonzero(tmp_path, capsys):
    """A textured scene renders in PPM's mega tier (#10's textured
    instance, here its plain version); a tier PPM does not have exits
    non-zero without writing the image."""
    from conftest import make_textured_quad_obj

    inp = make_textured_quad_obj(tmp_path)
    out = tmp_path / "t.png"
    rc = cli.main(["--input", inp, "--mode", "ppm", "--tier", "split",
                   "--device", "cpu", "--spl", "16", "--width", "4",
                   "--height", "4", "--output", str(out)])
    assert rc != 0 and not out.exists()
    assert "split" in capsys.readouterr().err
    _kernels.reset_counts()
    res = cli.run(["--input", inp, "--mode", "ppm", "--tier", "mega",
                   "--device", "cpu", "--spl", "64", "--width", "4",
                   "--height", "4", "--output", str(out)])
    assert out.exists() and res["tier"] == "mega"
    assert res["image"].shape == (16, 3) and np.isfinite(res["image"]).all()
    assert _kernels.plain_calls["photon_trace"] == 1
