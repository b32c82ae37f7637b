"""The port's sharded renders (``parallel/shard.py``) on the CPU, gloo ranks
spawned with ``torch.multiprocessing`` (one spawn per mesh shape, every
case rendered inside it by ``torch_shard_worker.run``), against the port's
single-process renders and the JAX package's sharded renders on the
conftest's virtual devices.

Bars, each with its reason:

- PT (auto: the megakernel's plain version) and BDPT fused with global RIS
  or the exact mega sweep: bit-equal to the single-process render, on 2
  and 4 ranks (global Threefry counters: a rank draws its slice's bits);
- BDPT mega with tile-local RIS: each rank's slice bit-equal to
  ``eye_pass`` over the same window in one process (the rank's offset is
  folded into the RIS key, as the JAX package folds it);
- PPM (exact and hash gathers): within rtol 1e-5 / atol 1e-6 of the
  single-process pass (each rank sums its own events' flux first);
- a 2x2 ``("dcn", "dp")`` mesh: PT and BDPT bit-equal to the flat 4, PPM
  within rtol 1e-5 / atol 1e-6;
- every rank returns the same whole image;
- 3 ranks pad the light paths and photons; the pad rows trace nothing, so
  the 3-rank renders meet the same bars;
- the port's 2-rank images against ``path_tracing_tpu``'s
  ``render_*_sharded`` on ``make_mesh(2)``: the bars of the single-device
  port-against-JAX tests of the same routes (PT against the JAX XLA tier:
  mean within 1e-3 relative, 95% of pixels within rtol 1e-4 / atol 1e-5,
  ``tests/test_torch_pt.py``; BDPT fused against the JAX scan tier with
  its kernels in interpret mode: mean within 1e-3, 97% of pixels within
  1e-3 relative, ``tests/test_torch_bdpt.py``; the port's hash-tier PPM
  against the JAX hash gather: mean within 1e-3, 99% of pixels within
  rtol 1e-3 / atol 1e-5, ``tests/test_torch_ppm.py``).
"""
import socket

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.parallel import shard as jshard
from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
from path_tracing_tpu_torch.ops import rng

import torch_shard_worker as worker
from test_torch_scene import jax_cornell

W, H = worker.W, worker.H
EXACT = ("pt", "bdpt_fused_ris", "bdpt_mega_exact")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world: int, dcn: int, out_dir) -> list:
    mp.spawn(worker.run, args=(world, _free_port(), dcn, str(out_dir)),
             nprocs=world, join=True)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Each mesh shape's rank outputs, one spawn a shape."""
    out = {}
    for name, world, dcn in (("2", 2, 1), ("3", 3, 1), ("4", 4, 1),
                             ("2x2", 4, 2)):
        d = tmp_path_factory.mktemp(f"mesh{name}")
        out[name] = _spawn(world, dcn, d)
    return out


@pytest.fixture(scope="module")
def single():
    """The single-process renders of the same cases."""
    scene, cam, cfg, key = worker.setup()
    ris = cfg.with_(bdpt_resample_vertices=worker.K)
    return {
        "pt": pt.render_pt(scene, cam, W, H, worker.PT_SPP, cfg, key),
        "bdpt_fused_ris": bdpt.render_bdpt(
            scene, cam, W, H, worker.BDPT_SPP, worker.BDPT_SPL, ris, key,
            tier="fused"),
        "bdpt_mega_exact": bdpt.render_bdpt(
            scene, cam, W, H, worker.BDPT_SPP, worker.BDPT_SPL, cfg, key),
        "ppm": ppm.render_ppm(scene, cam, W, H, worker.PPM_SPL, cfg, key),
        "ppm_hash": ppm.render_ppm(scene, cam, W, H, worker.PPM_SPL, cfg,
                                   key, tier="hash"),
    }


@pytest.mark.parametrize("mesh", ["2", "3", "4"])
def test_every_rank_returns_the_whole_image(mesh, sharded):
    ranks = sharded[mesh]
    assert sorted(int(r["linear_index"]) for r in ranks) == \
        list(range(len(ranks)))
    images = set(ranks[0]) - {"linear_index", "mesh_names"}
    assert len(images) == 6
    for r in ranks[1:]:
        for k in images:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    assert ranks[0]["pt"].shape == (W * H, 3)


@pytest.mark.parametrize("mesh", ["2", "3", "4"])
@pytest.mark.parametrize("case", EXACT)
def test_sharded_bit_equal_to_single_process(mesh, case, sharded, single):
    got = sharded[mesh][0][case]
    want = single[case].numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", ["2", "3", "4"])
def test_tile_ris_equals_its_windows(mesh, sharded):
    """Tile-local RIS folds the rank's first lane into its key: each slice
    is ``eye_pass`` over that window with the whole light trace."""
    scene, cam, cfg, key = worker.setup()
    cfg = cfg.with_(bdpt_resample_vertices=worker.K)
    scene_used, lv, scale = bdpt.light_side(scene, cfg, worker.BDPT_SPL, key)
    n, B = len(sharded[mesh]), W * H
    got = sharded[mesh][0]["bdpt_mega_tile_ris"]
    for me in range(n):
        lo = me * (B // n)
        idx = torch.arange(lo, lo + B // n, dtype=torch.int32)
        want = bdpt.eye_pass(scene_used, lv, cam, cfg, idx % W, idx // W,
                             worker.BDPT_SPP, key, scale, start=lo, total=B,
                             tier="mega")
        np.testing.assert_array_equal(got[lo:lo + B // n], want.numpy())
    whole = bdpt.render_bdpt(scene, cam, W, H, worker.BDPT_SPP,
                             worker.BDPT_SPL, cfg, key)
    assert not np.array_equal(got, whole.numpy())


@pytest.mark.parametrize("mesh", ["2", "3", "4"])
@pytest.mark.parametrize("case", ["ppm", "ppm_hash"])
def test_sharded_ppm_matches_single_process(mesh, case, sharded, single):
    got = sharded[mesh][0][case]
    want = single[case].numpy()
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_hybrid_mesh_matches_flat(sharded):
    hybrid, flat = sharded["2x2"], sharded["4"]
    assert tuple(hybrid[0]["mesh_names"]) == ("dcn", "dp")
    assert tuple(flat[0]["mesh_names"]) == ("dp",)
    assert [int(r["linear_index"]) for r in hybrid] == [0, 1, 2, 3]
    for k in EXACT + ("bdpt_mega_tile_ris",):
        np.testing.assert_array_equal(hybrid[0][k], flat[0][k], err_msg=k)
    for k in ("ppm", "ppm_hash"):
        np.testing.assert_allclose(hybrid[0][k], flat[0][k], rtol=1e-5,
                                   atol=1e-6)


def test_global_light_assignment():
    """Shards trace rows of the global sequence (light = global index %
    Nl): 8 one-path shards on cornell's 4 lights concatenate to the full
    trace (tests/test_sharding.py's check)."""
    scene, _, cfg, _ = worker.setup()
    key = rng.prng_key(7)
    full = bdpt.trace_light_paths(scene, cfg, 8, 2, key)
    parts = [bdpt.trace_light_paths(scene, cfg, 1, 2, key, start=s, total=8)
             for s in range(8)]
    for f in full.__dataclass_fields__:
        a, b = getattr(full, f), [getattr(p, f) for p in parts]
        if f == "mtl":
            for g in a.__dataclass_fields__:
                torch.testing.assert_close(
                    torch.cat([getattr(x, g) for x in b]), getattr(a, g),
                    rtol=0, atol=0)
        else:
            torch.testing.assert_close(torch.cat(b), a, rtol=0, atol=0)
    # every light emits: vertex 0's emission direction is its light's
    dirs = full.emit_dir[:, 0]
    assert len({tuple(d.tolist()) for d in dirs[:4]}) == 4


def test_padding_lanes_are_dead(sharded, single):
    """On 3 ranks the 2,048 photons and 64 light paths pad to 2,049 and 66
    rows; the pad rows trace nothing, so no light's share grows: the
    renders equal the single-process ones (the 3-rank cases above), and a
    rank's rows are its slice of the global sequence."""
    assert (4 * worker.PPM_SPL) % 3 and \
        (4 * worker.BDPT_SPL * worker.BDPT_SPL) % 3

    class Mesh3:
        def __init__(self, me):
            self.me = me

        def size(self):
            return 3

    from path_tracing_tpu_torch.parallel import shard

    rows = []
    for me in range(3):
        shard._linear_index, saved = (lambda m: m.me), shard._linear_index
        try:
            rows.append(shard._rows(64, Mesh3(me)))
        finally:
            shard._linear_index = saved
    assert rows == [(0, 22, 22), (22, 22, 22), (44, 20, 22)]
    got = sharded["3"][0]
    np.testing.assert_array_equal(got["bdpt_fused_ris"],
                                  single["bdpt_fused_ris"].numpy())
    np.testing.assert_allclose(got["ppm"], single["ppm"].numpy(), rtol=1e-5,
                               atol=1e-6)


def _bar(ref, img, share, rtol, atol):
    ref = np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(ref.mean() - img.mean()) / ref.mean() < 1e-3
    close = np.isclose(ref, img, rtol=rtol, atol=atol).all(axis=1)
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def jax_setup():
    js, jc, _, _ = jax_cornell(W, H)
    return (js, jc, JConfig(**worker.CFG), jax.random.PRNGKey(worker.SEED),
            jshard.make_mesh(2))


def test_two_ranks_pt_match_jax_sharded(sharded, jax_setup):
    js, jc, cfg, key, mesh = jax_setup
    _bar(jshard.render_pt_sharded(js, jc, W, H, worker.PT_SPP, cfg, key,
                                  mesh), sharded["2"][0]["pt"], 0.95, 1e-4,
         1e-5)


def test_two_ranks_ppm_match_jax_sharded(sharded, jax_setup):
    js, jc, cfg, key, mesh = jax_setup
    _bar(jshard.render_ppm_sharded(js, jc, W, H, worker.PPM_SPL, cfg, key,
                                   mesh), sharded["2"][0]["ppm_hash"], 0.99,
         1e-3, 1e-5)


def test_two_ranks_bdpt_match_jax_sharded(sharded, jax_setup):
    js, jc, cfg, key, mesh = jax_setup
    ref = np.asarray(jshard.render_bdpt_sharded(
        js, jc, W, H, worker.BDPT_SPP, worker.BDPT_SPL,
        cfg.with_(bdpt_resample_vertices=worker.K), key, mesh))
    img = sharded["2"][0]["bdpt_fused_ris"]
    assert abs(ref.mean() - img.mean()) / ref.mean() < 1e-3
    rel = np.abs(ref - img) / (np.abs(ref) + 1e-3)
    assert (rel.max(axis=1) < 1e-3).mean() >= 0.97
