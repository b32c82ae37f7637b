"""The plain versions' work counters of the PPM photon trace (#10
``photon_trace_plain``) and gather (#11 ``join_plain``), which the card's
counting builds are held to, and the gather kernel's work list: all on a
small cornell pass built by the integrator's own functions."""
import dataclasses

import numpy as np
import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import ppm
from path_tracing_tpu_torch.ops import cuda_photon
from path_tracing_tpu_torch.ops import cuda_ppm_gather as gather
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.ops import rng
from path_tracing_tpu_torch.scene.camera import make_camera
from path_tracing_tpu_torch.scene.parser import load_scene

from test_torch_scene import CORNELL


def _pass(radius, w=16, h=16, spl=1024):
    """The gather tables of one 16x16 pass of 4 x 1,024 = 4,096 photons."""
    p = load_scene(str(CORNELL))
    scene = p.to_device("cpu")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h, device="cpu")
    cfg = RenderConfig(width=w, height=h, spp=1, spl=spl, eye_depth=4,
                       light_depth=4, ppm_radius=radius)
    key = rng.fold_in(rng.prng_key(3), 0)
    idx = torch.arange(w * h, dtype=torch.int32)
    _, hp = ppm.ppm_eye_trace(scene, cam, cfg, idx % w, idx // w,
                              rng.fold_in(key, 1))
    events = ppm.ppm_photon_trace(scene, cfg, scene.num_lights * spl, spl,
                                  rng.fold_in(key, 2))
    return gather.prepare(scene, cfg, hp, events)


@pytest.fixture(scope="module")
def tables():
    return _pass(0.15)


def test_join_plain_counts_match_brute_force(tables):
    """Candidate pairs equal ``candidate_pairs()``, accepted pairs the sum
    of the counts, and the pairs past the distance gate and past both gates
    a float32 numpy brute force over the same windows; every pair past
    both gates is evaluated; counting leaves flux and counts alone."""
    t = tables
    counts = gather.new_counts()
    flux, count = gather.join_plain(t, counts=counts)
    f0, c0 = gather.join_plain(t)
    assert torch.equal(flux, f0) and torch.equal(count, c0)
    assert counts["pairs"] == t.candidate_pairs() > 0
    assert counts["accepted"] == int(count.sum()) > 0
    hp, ev, win = t.hp.numpy(), t.ev.numpy(), t.win.numpy()
    r2 = np.float32(t.r2)
    near = facing = 0
    for j in np.nonzero(t.hp_cell.numpy() >= 0)[0]:
        w = win[t.hp_cell[j]]
        e = np.concatenate([np.arange(w[2 * o], w[2 * o + 1])
                            for o in range(9)])
        d = hp[j, 0:3] - ev[e, 0:3]
        close = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < r2
        n = hp[j, 3:6]
        cos = (n[0] * ev[e, 3] + n[1] * ev[e, 4]) + n[2] * ev[e, 5]
        near += int(close.sum())
        facing += int((close & (cos > np.float32(0.01))).sum())
    assert counts["near"] == near > counts["facing"] == facing > 0
    assert counts["evals"] == facing >= counts["accepted"]
    assert all(counts[k] == 0 for k in counts
               if k not in gather.PLAIN_COUNTS)


@pytest.fixture(scope="module")
def wide():
    return _pass(0.3)


@pytest.mark.parametrize("rows", [gather.GATHER_ROWS, 2])
def test_work_list_covers_every_gathered_row_once(rows, wide):
    """Every gathered row lies in exactly one item; an item's rows are one
    cell's, at most ``rows`` of them, with that cell's candidate events;
    items come heaviest first (rows x events) and the padding last; at
    ``GATHER_ROWS`` the list is ``prepare``'s own."""
    t = wide
    items = gather.work_list(t.hp_cell, t.win, rows)
    if rows == gather.GATHER_ROWS:
        assert t.rows == rows and torch.equal(items, t.items)
    items = items.long()
    assert items.shape[0] == t.win.shape[0] + t.hp.shape[0] // rows
    real = items[items[:, 2] > 0]
    assert int((items[:, 2] > 0).sum()) == real.shape[0]
    assert bool((items[real.shape[0]:, 2] == 0).all())
    covered = torch.cat([torch.arange(a, a + n) for a, n in
                         real[:, 1:3].tolist()])
    gathered = torch.nonzero(t.hp_cell >= 0)[:, 0]
    assert torch.equal(torch.sort(covered).values, gathered)
    assert bool((real[:, 2] <= rows).all())
    if rows == 2:
        assert bool((real[:, 2] == 2).any()) and real.shape[0] > len(
            set(real[:, 0].tolist()))
    lens = (t.win[:, 1::2] - t.win[:, 0::2]).long().sum(dim=1)
    for cell, a, n, e in real.tolist():
        assert bool((t.hp_cell[a:a + n] == cell).all())
        assert e == int(lens[cell])
    cost = real[:, 2] * real[:, 3]
    assert bool((cost[:-1] >= cost[1:]).all())
    staged = dataclasses.replace(t, items=items.int(), rows=rows)
    assert staged.staged_bytes() == int(real[:, 3].sum()) * 48


def test_photon_trace_plain_counts_match_a_per_photon_recount():
    """On 4 x 512 = 2,048 cornell photons: counting leaves the events
    alone; the deposits equal the valid rows, every real photon starts,
    each bounce tests every sphere and cluster box, each sample takes 3
    draws; and a window of 96 of those photons, traced one photon at a
    time (each at its own Threefry lane), sums to the same bounces,
    samples, draws, deposits and walk tests as the window traced at
    once."""
    p = load_scene(str(CORNELL))
    scene = p.to_device("cpu")
    spl = 512
    cfg = RenderConfig(width=16, height=16, spl=spl, eye_depth=4,
                       light_depth=4)
    kp = rng.fold_in(rng.fold_in(rng.prng_key(3), 0), 2)
    emit = ppm.photon_emission(scene, scene.num_lights * spl, spl, kp)
    pk = pack_scene(scene)
    P = emit[0].shape[0]
    rest = (kp, cfg.light_depth, cfg.max_light_iters)
    counts = cuda_photon.new_counts()
    ev, valid = cuda_photon.photon_trace_plain(pk, *emit, *rest,
                                               counts=counts)
    ev0, valid0 = cuda_photon.photon_trace_plain(pk, *emit, *rest)
    assert torch.equal(ev, ev0) and torch.equal(valid, valid0)
    assert counts["photons"] == P
    assert counts["deposits"] == int(valid.sum()) > 0
    clusters = int((pk.cl[:, 7] > 0).sum())
    assert counts["hit_spheres"] == counts["bounces"] * (pk.ns + pk.nl)
    assert counts["hit_boxes"] == counts["bounces"] * clusters
    assert counts["draws"] == 3 * counts["bsdf_samples"]
    assert (counts["bounces"] > counts["bsdf_samples"] > counts["deposits"]
            and counts["hit_tris"] > 0)
    assert counts["bounces"] <= counts["photon_warp_slots"]
    assert 0 < counts["iteration_keys"] <= cfg.max_light_iters

    lo, hi = 64, 160
    window = cuda_photon.new_counts()
    cuda_photon.photon_trace_plain(pk, *(x[lo:hi] for x in emit), *rest,
                                   start=lo, total=P, counts=window)
    singles = cuda_photon.new_counts()
    for i in range(lo, hi):
        cuda_photon.photon_trace_plain(pk, *(x[i:i + 1] for x in emit),
                                       *rest, start=i, total=P,
                                       counts=singles)
    assert {k: singles[k] for k in cuda_photon.PLAIN_COUNTS} == {
        k: window[k] for k in cuda_photon.PLAIN_COUNTS}
    assert window["bounces"] > hi - lo
