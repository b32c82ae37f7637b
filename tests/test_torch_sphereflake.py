"""SPD's sphereflake (``scene/synth.py``) and the sphere index it forces.

The generator gives 1 + 9 + ... + 9^levels spheres, each child touching
its parent, and writes the committed benchmark scene byte for byte.  From
``SPHERE_INDEX_MIN`` spheres on ``scene_from_numpy`` clusters the spheres
(every sphere in exactly one cluster, inside its box), and the scene's
tables (``scene.packed``) carry the index beside the triangles' tables;
below it the tables are the parent's.  The plain models of the kernels' walks through the index
(``_count_nearest_walk``, ``_count_shadow_walk``, which the card's
counting builds are held to) find the linear loop's nearest hit, row and
verdicts, with fewer sphere tests, also on rays whose direction is not of
unit length (the sphere test then reports hits off the sphere, which the
walk's pad keeps).  The port's plain PT on a small flake equals the
benchmark's plain reference, which tests every sphere in turn.  Rays come
from seeds; everything runs on the CPU."""
from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import pt
from path_tracing_tpu_torch.ops import bvh, cuda_connect, rng
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops.intersect import INF
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.camera import make_camera, primary_ray_dirs
from path_tracing_tpu_torch.scene.parser import load_scene, parse_scene_text

REPO = Path(__file__).resolve().parent.parent
FLAKE_TXT = REPO / "benchmark" / "configs" / "sphereflake.txt"
CORNELL = REPO / "scenes" / "cornell.txt"
_FLAKES = {}


def _clusters(scene):
    """The sphere index's cluster boxes (M, 6) and ranges (M, 2) in the
    builder's order: the scene's index rows without their padding rows
    (count 0) and its bounds row."""
    rows = scene.packed.scl[:scene.packed.nsc]
    rows = rows[rows[:, 7] > 0]
    return rows[:, 0:6], rows[:, 6:8].int()


def _flake(levels, glass_every=0):
    """The sphereflake of ``levels`` on the CPU (every ``glass_every``-th
    sphere glass, so that the two can-block rules differ): (parsed, scene,
    packed)."""
    key = (levels, glass_every)
    if key not in _FLAKES:
        p = synth.sphereflake_scene(levels)
        if glass_every:
            p.sph_mtl = [[1.0, 1.0, 1.0, 0.0, 0.0, 1.5] if i % glass_every
                         == 0 else m for i, m in enumerate(p.sph_mtl)]
        scene = p.to_device("cpu")
        _FLAKES[key] = (p, scene, scene.packed)
    return _FLAKES[key]


@pytest.mark.parametrize("levels,n", [(0, 1), (1, 10), (2, 91), (3, 820),
                                      (4, 7381)])
def test_sphere_counts_and_every_child_touches_its_parent(levels, n):
    c, r = synth.sphereflake_spheres(levels)
    assert len(r) == n and r[0] == 0.5 and not c[0].any()
    child = np.arange(1, n)
    parent = (child - 1) // 9          # level by level, nine a parent
    d = np.linalg.norm(c[child] - c[parent], axis=1)
    np.testing.assert_allclose(r[child], r[parent] / 3.0, rtol=1e-15)
    np.testing.assert_allclose(d, r[parent] + r[child], rtol=1e-12)
    # and as the text scene stores them, in float32 (a few ulps off)
    p = parse_scene_text(synth.scene_text(synth.sphereflake_scene(levels)))
    c32 = np.asarray(p.sph_center, np.float64)
    r32 = np.asarray(p.sph_radius, np.float64)
    d32 = np.linalg.norm(c32[child] - c32[parent], axis=1)
    np.testing.assert_allclose(d32, r32[parent] + r32[child], rtol=4e-6)


def test_the_generators_text_is_the_committed_scene():
    assert synth.sphereflake_text(4).encode() == FLAKE_TXT.read_bytes()
    p = load_scene(str(FLAKE_TXT))
    assert (len(p.sph_center), len(p.tri_verts), len(p.lights)) == \
        (7381, 2, 3)


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_index_puts_every_sphere_in_one_cluster_inside_its_box(levels):
    p, scene, pk = _flake(levels)
    ns = scene.num_spheres
    assert ns >= bvh.SPHERE_INDEX_MIN and pk.nsc > 0
    box_t, rng_t = _clusters(scene)
    rng_, box = rng_t.numpy(), box_t.numpy()
    start, count = rng_[:, 0], rng_[:, 1]
    assert count.sum() == ns and count.max() <= bvh.SPHERE_LEAF
    covered = np.zeros(ns, int)
    for (a, k), b in zip(rng_, box):
        covered[a:a + k] += 1
        c = scene.sph_center[a:a + k].numpy()
        r = scene.sph_radius[a:a + k].numpy()[:, None]
        assert (b[0:3] < c - r).all() and (c + r < b[3:6]).all()
    assert (covered == 1).all()
    # the spheres reordered with their materials: the same set of rows
    rows = np.concatenate([scene.sph_center.numpy(),
                           scene.sph_radius.numpy()[:, None],
                           scene.sph_mtl.base_color.numpy()], 1)
    want = np.concatenate([np.asarray(p.sph_center, np.float32),
                           np.asarray(p.sph_radius, np.float32)[:, None],
                           np.asarray(p.sph_mtl, np.float32)[:, 0:3]], 1)
    assert sorted(map(tuple, rows)) == sorted(map(tuple, want))
    # the builder's clusters, then padding rows, then the bounds row
    b_order, b_box, b_rng = bvh.build_sphere_clusters(
        np.asarray(p.sph_center, np.float32),
        np.asarray(p.sph_radius, np.float32), bvh.SPHERE_LEAF)
    np.testing.assert_array_equal(box, b_box)
    np.testing.assert_array_equal(rng_, b_rng)
    assert (pk.scl[len(box):pk.nsc, 7] == 0).all()
    m = pk.scl[pk.nsc]
    assert torch.equal(m[0:3], box_t[:, 0:3].amin(0))
    assert torch.equal(m[3:6], box_t[:, 3:6].amax(0))
    assert m[6] == scene.sph_radius.min()
    assert (pk.n_ssuper > 0) == (pk.nsc >= CI.SUPER_MIN_CLUSTERS)


@pytest.mark.parametrize("levels", [2, 4])
def test_pack_scene_carries_the_index_built_at_set_up(levels, monkeypatch):
    """The index's tables, supers and bounds row are built once, by
    ``scene_from_numpy``, with the triangles' (two super tables); a frame
    builds none and takes the scene's own tensors; they are the tables
    ``super_table`` gives over the builder's clusters."""
    p, _, _ = _flake(levels)
    calls = []
    real = CI.super_table
    monkeypatch.setattr(CI, "super_table",
                        lambda cl: calls.append(cl.shape) or real(cl))
    scene = p.to_device("cpu")
    pk = scene.packed
    assert [c[0] for c in calls] == [
        CI._padded_rows(scene.tri_cluster_aabb.shape[0]),
        CI._padded_rows(_clusters(scene)[0].shape[0])]
    W, H = 8, 6
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H, device="cpu")
    pt.render_pt(scene, cam, W, H, 1, RenderConfig(width=W, height=H, spp=1,
                                                   eye_depth=2),
                 rng.prng_key(1), tier="mega")
    assert len(calls) == 2 and scene.packed is pk
    box, rng_ = _clusters(scene)
    cl, sup, use = real(CI._rowpad(torch.cat([box, rng_.float()], 1),
                                   CI._padded_rows(box.shape[0])))
    assert torch.equal(pk.scl[:-1], cl) and torch.equal(pk.ssup, sup)
    assert use == (pk.n_ssuper > 0) and pk.nsc == cl.shape[0]


def _rays(p, scene, n, seed):
    """Seeded rays through the flake: from the eye through jittered pixels,
    from points inside the scene's bounds in every direction, and those
    again with directions of length 1 +- 2% (as the reference's sphere
    normals, which are not of unit length, pass on)."""
    g = torch.Generator().manual_seed(seed)
    W, H = 96, 54
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H, device="cpu")
    idx = torch.randint(0, W * H, (n,), generator=g)
    rd0 = primary_ray_dirs(cam, (idx % W).int(), (idx // W).int(),
                           torch.rand(n, generator=g),
                           torch.rand(n, generator=g))
    ro0 = cam.eye.expand(n, 3)
    lo, hi = scene.packed.scl[-1, 0:3], scene.packed.scl[-1, 3:6]
    ro1 = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    rd1 = torch.randn(n, 3, generator=g)
    rd1 = rd1 / rd1.norm(dim=1, keepdim=True)
    rd2 = rd1 * (1.0 + 0.04 * (torch.rand(n, 1, generator=g) - 0.5))
    return (torch.cat([ro0, ro1, ro1]).contiguous(),
            torch.cat([rd0, rd1, rd2]).contiguous())


@pytest.mark.parametrize("levels", [2, 3])
def test_walk_model_finds_the_linear_loops_nearest_hit(levels):
    p, scene, pk = _flake(levels)
    ro, rd = _rays(p, scene, 4000, levels)
    counts = cuda_connect.new_counts()
    t, row = CI._count_nearest_walk(pk, ro, rd, counts, winner=True)
    want = CI.nearest_hit_plain(pk, ro, rd)
    assert torch.equal(t, want["t"])
    hit = t < INF
    assert 0.3 < hit.float().mean().item() < 0.95
    # the row that won is the brute force's first nearest, so normal and
    # material are its record's
    n_s = pk.ns + pk.nl
    all_t = torch.cat([
        CI.sphere_ts(ro, rd, pk.sph[:n_s, 0:3], pk.sph[:n_s, 3], INF),
        CI.triangle_ts(ro, rd, pk.tri[:pk.nt, 0:3], pk.tri[:pk.nt, 3:6],
                       pk.tri[:pk.nt, 6:9], INF)], 1)
    assert torch.equal(row[hit], torch.argmin(all_t, dim=1)[hit])
    assert (row[~hit] == -1).all()
    srow = pk.sph[row[hit].clamp(max=n_s - 1)]
    on_sphere = row[hit] < n_s
    for k, col in (("bcr", 8), ("rough", 11), ("metal", 12)):
        assert torch.equal(want[k][hit][on_sphere], srow[on_sphere, col])
    # with fewer sphere tests than every ray testing every sphere
    assert counts["hit_spheres"] * 2 < ro.shape[0] * n_s
    assert counts["hit_boxes"] > 0


@pytest.mark.parametrize("levels", [2, 3])
def test_warp_walk_model_finds_the_lane_walks_hit_and_counts_wide_rays(
        levels):
    """#5's indexed instance walks a wide ray's index with its whole warp
    (the flat index at level 2, the supers at level 3): the model of that
    walk finds the brute force's t and the lane walk's row on every ray,
    the directions of length 1 +- 2% among them, and counts a walk for
    each ray ``sphere_pad`` calls wide, with at least one step each and
    no fewer box tests than the lane walk makes."""
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    p, scene, pk = _flake(levels)
    assert (pk.n_ssuper > 0) == (levels == 3)
    ro, rd = _rays(p, scene, 4000, 20 + levels)
    lane, warp = cuda_connect.new_counts(), cw.new_counts()
    t_l, row_l = CI._count_nearest_walk(pk, ro, rd, lane, winner=True)
    t_w, row_w = CI._count_nearest_walk(pk, ro, rd, warp, winner=True,
                                        warp=True)
    assert torch.equal(t_w, CI.nearest_hit_plain(pk, ro, rd)["t"])
    assert torch.equal(t_w, t_l) and torch.equal(row_w, row_l)
    wide = int((CI.sphere_pad(pk, ro, rd)[1] > 0).sum())
    assert 0.1 * ro.shape[0] < wide < 0.9 * ro.shape[0]
    assert warp["wide_walks"] == wide
    assert warp["wide_steps"] >= 2 * wide
    # the warp culls with the least t of its steps before, so it tests at
    # least the boxes and spheres of the lane walk
    assert warp["hit_boxes"] >= lane["hit_boxes"]
    assert warp["hit_spheres"] >= lane["hit_spheres"]
    assert warp["hit_tris"] == lane["hit_tris"]
    # narrow rays alone: the lane walk's counts, no warp walk
    narrow = CI.sphere_pad(pk, ro, rd)[1] == 0
    a, b = cuda_connect.new_counts(), cw.new_counts()
    CI._count_nearest_walk(pk, ro[narrow], rd[narrow], a)
    CI._count_nearest_walk(pk, ro[narrow], rd[narrow], b, warp=True)
    assert b["wide_walks"] == b["wide_steps"] == 0
    assert all(a[k] == b[k] for k in a)


@pytest.mark.parametrize("dielectrics_block", [True, False])
@pytest.mark.parametrize("levels", [2, 3])
def test_walk_model_finds_the_linear_loops_shadow_verdicts(levels,
                                                           dielectrics_block):
    p, scene, pk = _flake(levels, glass_every=5)
    ro, rd = _rays(p, scene, 4000, 10 + levels)
    g = torch.Generator().manual_seed(levels)
    md = 0.05 + 2.5 * torch.rand(ro.shape[0], generator=g)
    col = 4 if dielectrics_block else 5
    counts = cuda_connect.new_counts()
    got = CI._count_shadow_walk(pk, ro, rd, md, col, counts)
    want = CI.any_blocker_plain(pk, ro, rd, md, dielectrics_block)
    assert torch.equal(got, want)
    assert 0.1 < want.float().mean().item() < 0.9
    # glass blocks under one rule alone, so the verdicts differ between them
    other = CI.any_blocker_plain(pk, ro, rd, md, not dielectrics_block)
    assert not torch.equal(want, other)
    assert 0 < counts["shadow_spheres"] * 2 < ro.shape[0] * pk.ns


def test_plain_pt_on_a_small_flake_equals_the_benchmarks_reference(
        tmp_path):
    """The port's plain tier (the index's reordered spheres, culled walks
    nowhere: brute force) against the benchmark's frozen reference (the
    text scene's order), 32x24 spp 2, two iterations."""
    from benchmark import check

    path = tmp_path / "flake2.txt"
    path.write_text(synth.sphereflake_text(2))
    traffic = dict(mode="pt", width=32, height=24, spp=2, eye_depth=4)
    seed = 2 ** 31 + 9
    ref = check.Reference(traffic, path, seed, "cpu")
    p = load_scene(str(path))
    scene = p.to_device("cpu")
    assert scene.packed.nsc > 0
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 32, 24,
                      device="cpu")
    cfg = RenderConfig(width=32, height=24, spp=2, eye_depth=4, seed=seed)
    for i in (0, 3):
        key = rng.fold_in(rng.prng_key(seed), i)
        img = pt.render_pt(scene, cam, 32, 24, 2, cfg, key, tier="plain")
        assert img.abs().sum() > 0
        assert torch.equal(img, ref.frame(i, 0, 32 * 24))


def test_pack_scene_on_cornell_is_the_parents():
    """Below SPHERE_INDEX_MIN spheres nothing is reordered and the tables
    are those of the benchmark's frozen copy of the parent's
    ``pack_scene``, on the same scene; the index's are empty."""
    from benchmark.reference.ops.cuda_intersect import pack_scene as frozen

    scene = load_scene(str(CORNELL)).to_device("cpu")
    p = load_scene(str(CORNELL))
    assert torch.equal(scene.sph_center,
                       torch.tensor(p.sph_center, dtype=torch.float32))
    pk, old = scene.packed, frozen(scene)
    for f in ("sph", "tri", "uv", "cl", "sup", "atlas", "tex_size"):
        assert torch.equal(getattr(pk, f), getattr(old, f)), f
    for f in ("ns", "nl", "nt", "n_super"):
        assert getattr(pk, f) == getattr(old, f), f
    assert pk.nsc == pk.n_ssuper == 0
    assert pk.scl.shape == (0, CI.CL_COLS) and pk.ssup.shape[0] == 0
