"""The port's hash-grid photon gather (``integrators/ppm.py``: ``hash_cell``,
``_cell_coords``, ``gather_flux_hash`` and the ``hash`` tier) against the
JAX package's (``path_tracing_tpu.integrators.ppm``), which is its PPM
gather on every backend but the TPU, so on the CPU here.

Bars, each with its reason:

- ``hash_cell`` and ``_cell_coords``: bit-equal (integer arithmetic, and
  one float32 product and floor on both sides: under ``jit`` XLA turns the
  JAX package's division by the constant cell size into a product with its
  float32 reciprocal, so positions an ulp from a cell boundary are taken
  at and beside boundaries);
- ``gather_flux_hash`` on the same hitpoints and events (the JAX eye pass
  and photon scan on cornell at 32x32, 4 x 2,048 photons): counts and
  overflow equal, flux within rtol 1e-5 / atol 1e-6 (the same candidates
  in the same order; the half vector and the 27-term sums round an ulp
  apart between the frameworks);
- the brute-force walk of the reference (``tests/test_ppm.py``'s, on
  cornell, here with the port's ``bsdf_evaluate``), at the default table
  and at a 7-entry one where neighbouring cells collide and are counted
  twice: counts equal, flux within rtol 1e-5 / atol 1e-6;
- a whole ``--tier hash`` pass against the JAX ``render_ppm_with_stats``:
  the bar of ``tests/test_torch_ppm.py``'s exact-tier pass (image within
  rtol 1e-3 / atol 1e-5 on >= 99% of pixels, mean within 1e-3 relative,
  overflow equal), for the eye pass and photon trace it shares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.integrators import ppm as jppm
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import ppm
from path_tracing_tpu_torch.ops import rng
from path_tracing_tpu_torch.ops.bsdf import bsdf_evaluate
from path_tracing_tpu_torch.scene.types import Material

from test_torch_ppm import _port_events, _port_hp, jax_knobs  # noqa: F401
from test_torch_scene import CORNELL, jax_cornell

W = H = 32
SPL = 2048                       # cornell's 4 lights: 8,192 photons a pass


def _ints(x):
    return torch.from_numpy(np.asarray(x, np.int32))


@pytest.mark.parametrize("table", [1000003, 7, 2 ** 31 - 1])
def test_hash_cell_matches_jax(table):
    rs = np.random.RandomState(3)
    small = rs.randint(-600, 600, (3, 2000))
    # products past int32 (they wrap) and the int32 extremes
    big = rs.randint(-2 ** 31, 2 ** 31 - 1, (3, 2000), dtype=np.int64)
    edge = np.array([[-2 ** 31, 2 ** 31 - 1, -1, 0, 29, -29]] * 3)
    c = np.concatenate([small, big, edge], axis=1).astype(np.int32)
    want = np.asarray(jppm.hash_cell(*(jnp.asarray(v) for v in c), table))
    got = ppm.hash_cell(*(_ints(v) for v in c), table).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < table).all()


@pytest.mark.parametrize("cell", [0.05, 0.002, 0.3])
def test_cell_coords_match_jax_at_boundaries(cell):
    """Positions on a cell boundary and one ulp either side of it land in
    the JAX package's cells, as its gather computes them (under ``jit``,
    the cell size a constant)."""
    origin = np.array([-5.0, -3.0, -5.0], np.float32)
    k = np.arange(-3, 220, dtype=np.float32)
    on = origin[None] + (k * np.float32(cell))[:, None]
    pos = np.concatenate([on, np.nextafter(on, np.float32(np.inf)),
                          np.nextafter(on, np.float32(-np.inf))]
                         ).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda p, o: jppm._cell_coords(p, o, cell))(jnp.asarray(pos),
                                                     jnp.asarray(origin)))
    got = ppm._cell_coords(torch.from_numpy(pos), torch.from_numpy(origin),
                           cell).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def traced():
    """The JAX eye pass and photon scan of one cornell pass, and the port's
    copies of their hitpoints and events."""
    js, jc, ts, _ = jax_cornell(W, H)
    cfg = JConfig(width=W, height=H)
    idx = jnp.arange(W * H, dtype=jnp.int32)
    key = jax.random.PRNGKey(5)
    _, hp = jppm.ppm_eye_trace(js, jc, cfg, idx % W, idx // W,
                               jax.random.fold_in(key, 1))
    # the XLA photon scan: the JAX package's route off the TPU
    events = jppm.ppm_photon_trace(js, cfg, js.num_lights * SPL, SPL,
                                   jax.random.fold_in(key, 2))
    return js, ts, hp, events


GATHER_KNOBS = {"budget_64": {}, "budget_2": {"ppm_max_per_cell": 2},
                "cell_samples_4": {"ppm_cell_samples": 4},
                "shrunk_radius": {"_r2_scale": 0.5}}


@pytest.mark.parametrize("case", sorted(GATHER_KNOBS))
def test_gather_hash_matches_jax(case, traced):
    js, ts, hp, events = traced
    knobs = dict(GATHER_KNOBS[case])
    r2_scale = knobs.pop("_r2_scale", 1.0)
    fa, ca, oa = jax.jit(jppm.gather_flux, static_argnames=("cfg",))(
        js, JConfig(**knobs), hp, events, r2_scale)
    fb, cb, ob = ppm.gather_flux_hash(ts, RenderConfig(**knobs),
                                      _port_hp(hp), _port_events(events),
                                      r2_scale)
    assert int(oa) == int(ob)
    np.testing.assert_array_equal(np.asarray(ca), cb.numpy())
    np.testing.assert_allclose(np.asarray(fa), fb.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert cb.dtype == torch.int32 and int(cb.sum()) > 100
    if case == "budget_2":
        assert int(ob) > 0
    else:
        assert int(ob) == 0


def _random_problem(scene, B=24, E=200, seed=1):
    rs = np.random.RandomState(seed)
    lo = scene.scene_min.numpy()
    span = scene.scene_max.numpy() - lo
    hp_pos = (lo + rs.rand(B, 3) * span).astype(np.float32)
    hp_n = rs.randn(B, 3).astype(np.float32)
    hp_n /= np.linalg.norm(hp_n, axis=-1, keepdims=True)
    ev_pos = (hp_pos[rs.randint(0, B, E)]
              + rs.randn(E, 3).astype(np.float32) * 0.05)
    ev_n = np.tile(np.array([[0, 1, 0]], np.float32), (E, 1))
    ev_wi = rs.randn(E, 3).astype(np.float32)
    ev_wi /= np.linalg.norm(ev_wi, axis=-1, keepdims=True)
    ev_flux = rs.rand(E, 3).astype(np.float32)
    ev_valid = rs.rand(E) > 0.2
    t = torch.from_numpy
    hp = ppm.HitPoints(
        pos=t(hp_pos), normal=t(hp_n),
        wo=t(np.tile(np.array([[0, 1, 0]], np.float32), (B, 1))),
        mtl=Material(base_color=torch.full((B, 3), 0.5),
                     roughness=torch.full((B,), 0.5),
                     metallic=torch.zeros(B), eta=torch.zeros(B)),
        throughput=torch.ones(B, 3), valid=torch.ones(B, dtype=torch.bool))
    ev = ppm.PhotonEvents.from_fields(t(ev_pos), t(ev_n), t(ev_wi),
                                      t(ev_flux), t(ev_valid))
    return hp, ev


@pytest.mark.parametrize("table", [1000003, 7])
def test_gather_hash_matches_bruteforce(table):
    """The reference's walk: each of the 27 neighbour cells' hash chains in
    turn, so two neighbours that share a hash count its events twice
    (certain with a 7-entry table)."""
    _, _, ts, _ = jax_cornell(4, 4)
    cfg = RenderConfig(ppm_hash_size=table, ppm_max_per_cell=256)
    hp, ev = _random_problem(ts)
    flux, count, overflow = ppm.gather_flux_hash(ts, cfg, hp, ev)
    assert int(overflow) == 0

    cell = cfg.ppm_radius
    lo = ts.scene_min
    ev_hash = ppm.hash_cell(*ppm._cell_coords(ev.pos, lo, cell).T, table)
    B = hp.pos.shape[0]
    want = torch.zeros(B, 3)
    want_n = torch.zeros(B, dtype=torch.int32)
    doubled = 0
    for b in range(B):
        hc = ppm._cell_coords(hp.pos[b:b + 1], lo, cell)[0]
        seen = set()
        for off in ppm._OFFS:
            c = hc + torch.tensor(off, dtype=torch.int32)
            hh = int(ppm.hash_cell(c[0:1], c[1:2], c[2:3], table))
            doubled += hh in seen
            seen.add(hh)
            for e in torch.nonzero(ev_hash == hh)[:, 0].tolist():
                if not ev.valid[e]:
                    continue
                if float(hp.normal[b] @ ev.normal[e]) <= 0.01:
                    continue
                d = hp.pos[b] - ev.pos[e]
                if float(d @ d) >= cfg.ppm_radius ** 2:
                    continue
                m = Material(*(getattr(hp.mtl, f)[b:b + 1] for f in (
                    "base_color", "roughness", "metallic", "eta")))
                brdf = bsdf_evaluate(m, hp.wo[b:b + 1], ev.wi[e:e + 1],
                                     hp.normal[b:b + 1])[0]
                want[b] += ev.flux[e] * brdf
                want_n[b] += 1
    if table == 7:
        assert doubled > 0
    assert int(want_n.sum()) > 10
    np.testing.assert_array_equal(count.numpy(), want_n.numpy())
    np.testing.assert_allclose(flux.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_hash_tier_pass_matches_jax(jax_knobs):  # noqa: F811
    """A whole pass of the port's hash tier against the JAX package's pass
    on the CPU (its XLA photon scan and its hash gather)."""
    js, jc, ts, tc = jax_cornell(W, H)
    jax_knobs(PT_TPU_NO_PHOTON_MEGA="1")
    key = 3
    a, ca, oa = jppm.render_ppm_with_stats(
        js, jc, W, H, SPL, JConfig(width=W, height=H),
        jax.random.PRNGKey(key))
    b, cb, ob = ppm.render_ppm_with_stats(
        ts, tc, W, H, SPL, RenderConfig(width=W, height=H),
        rng.prng_key(key), tier="hash")
    a, b = np.asarray(a), b.numpy()
    assert int(oa) == int(ob)
    assert np.isfinite(b).all() and b.mean() > 0.0
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-3
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert (np.asarray(ca) == cb.numpy()).mean() >= 0.99


def test_resolve_tier_and_dispatch():
    _, _, ts, _ = jax_cornell(4, 4)
    assert ppm.resolve_tier(ts, "hash") == "hash"
    assert ppm.resolve_tier(ts, "auto") == "mega"
    hp, ev = _random_problem(ts)
    cfg = RenderConfig()
    want = ppm.gather_flux_hash(ts, cfg, hp, ev)
    got = ppm.gather_flux_dispatch(ts, cfg, hp, ev, tier="hash")
    for x, y in zip(want, got):
        assert torch.equal(x, y)
    exact = ppm.gather_flux_dispatch(ts, cfg, hp, ev, tier="auto")
    np.testing.assert_array_equal(exact[1].numpy(), want[1].numpy())


def test_cli_hash_tier(tmp_path, capsys):
    """``--tier hash`` through the CLI: the tier's image, deterministic;
    the PT tiers refuse it."""
    args = ["--input", str(CORNELL), "--mode", "ppm", "--spl", "256",
            "--iters", "2", "--width", "16", "--height", "12", "--device",
            "cpu", "--tier", "hash"]
    a = cli.run(args + ["--output", str(tmp_path / "a.png")])
    b = cli.run(args + ["--output", str(tmp_path / "b.png")])
    assert a["tier"] == "hash" and "(hash tier)" in capsys.readouterr().out
    np.testing.assert_array_equal(a["image"], b["image"])
    assert np.isfinite(a["image"]).all() and a["image"].mean() > 0.0
    assert cli.main(["--input", str(CORNELL), "--width", "8", "--height",
                     "6", "--device", "cpu", "--tier", "hash", "--output",
                     str(tmp_path / "c.png")]) != 0
