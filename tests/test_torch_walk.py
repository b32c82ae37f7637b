"""The resident walk's super-cluster tables and the plain models of the
kernels' walks, against the JAX package and against brute force.

From 64 clusters on, ``pack_scene`` builds what the JAX package's
``super_table`` builds for its resident kernels (16-column cluster rows
with each octant's child order, and the super table), and the kernels walk
the supers first; below 64 clusters nothing changes.  The walk models
(``_count_nearest_walk``, ``_count_shadow_walk`` and the streamed
blocker's ``_count_stream_shadow_walk``) are what the card's counting
builds are held to: their t and verdicts must be the brute force's bit for
bit (culling never changes either), their counts those of the flat walk
below 64 clusters and fewer box tests above.  The textured bounce above 64
clusters is held to JAX's ``shade_step_tex_pallas`` in interpret mode at
``test_torch_texture.py``'s tolerances.  Rays and segments come from numpy
seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.integrators.pt import _light_table as j_light_table
from path_tracing_tpu.ops import pallas_intersect as PI
from path_tracing_tpu.ops import texture as jtexture
from path_tracing_tpu.ops.pallas_intersect import nearest_hit_pallas
from path_tracing_tpu.ops.pallas_shade import shade_step_tex_pallas
from path_tracing_tpu.scene import synth as jsynth
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.ops import (cuda_connect, cuda_shade,
                                        cuda_wavefront, rng)
from path_tracing_tpu_torch.ops import cuda_stream as CS
from path_tracing_tpu_torch.ops.intersect import (INF, SHADOW_EPS,
                                                  shadow_ray, sphere_ts,
                                                  triangle_ts)
from path_tracing_tpu_torch.ops.math3 import EPSILON
from path_tracing_tpu_torch.scene.parser import parse_scene_text
from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

from test_torch_bdpt_counts import BLOCKER
from test_torch_scene import jax_arrays, jax_cornell

WALK = ("hit_spheres", "hit_boxes", "hit_tris")
SHADOW = ("shadow_spheres", "shadow_boxes", "shadow_tris")


def _icosphere(n_tris=17000, textured=False):
    """The JAX package's icosphere and the same tables on the port's CPU."""
    p = jsynth.icosphere_scene(n_tris, textured=textured)
    js = p.to_device()
    return p, js, scene_from_jax_arrays(jax_arrays(js), "cpu")[0]


def _aimed_rays(p, scene, n=256, seed=0):
    """``test_pallas_interpret.py``'s super-walk rays: from the eye toward
    points scattered around the mesh's centre."""
    rs = np.random.default_rng(seed)
    lo, hi = scene.scene_min.numpy(), scene.scene_max.numpy()
    ctr, ext = (lo + hi) / 2, float((hi - lo).max())
    tgt = ctr + rs.normal(size=(n, 3)).astype(np.float32) * 0.35 * ext
    ro = np.broadcast_to(np.asarray(p.eye, np.float32), (n, 3))
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.from_numpy(np.ascontiguousarray(ro, np.float32)),
            torch.from_numpy(rd.astype(np.float32)))


def _segments(scene, n, seed):
    """Shadow segments through the mesh: origins in a box 1.5 times its
    bounds, half aimed at its centre, lengths 0.05 to 1.55 half-extents."""
    rs = np.random.default_rng(seed)
    lo, hi = scene.scene_min.numpy(), scene.scene_max.numpy()
    c, half = (lo + hi) / 2, (hi - lo) / 2
    p1 = (c + rs.uniform(-1.5, 1.5, (n, 3)) * half).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::2] = (c - p1)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p2 = p1 + d * ((0.05 + 1.5 * rs.uniform(size=(n, 1)))
                   * half.max()).astype(np.float32)
    p1 = torch.from_numpy(p1)
    srd, _, md = shadow_ray(p1, torch.from_numpy(p2))
    return p1, srd, md


def _flat(pk):
    """The same scene without supers: the flat walk over its clusters."""
    return dataclasses.replace(pk, cl=pk.cl[:, :8].contiguous(),
                               n_super=0)


# ---------------------------------------------------------------------------
# the resident super table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["icosphere_17000", "cornell"])
def test_resident_super_table_matches_jax(which):
    if which == "cornell":
        js, _, ts, _ = jax_cornell(8, 8)
    else:
        _, js, ts = _icosphere()
    j_cl = PI.pack_scene(js)[2]
    jcl, jsup, juse = PI.super_table(j_cl)
    pk = CI.pack_scene(ts)
    assert juse == (which != "cornell")
    assert pk.n_super == (jcl.shape[0] // PI.SUPER if juse else 0)
    np.testing.assert_array_equal(np.asarray(jcl), pk.cl.numpy())
    if juse:
        assert pk.cl.shape[1] == 16 and pk.n_super == 32   # 512 clusters
        np.testing.assert_array_equal(np.asarray(jsup), pk.sup.numpy())
    else:     # cornell: the 8-column rows of before, no super rows
        np.testing.assert_array_equal(np.asarray(j_cl), pk.cl.numpy())
        assert not pk.sup.any()


# ---------------------------------------------------------------------------
# the walk models
# ---------------------------------------------------------------------------

def test_resident_walk_models_find_the_brute_force_answers():
    p, _, ts = _icosphere()
    pk = CI.pack_scene(ts)
    ro, rd = _aimed_rays(p, ts)
    walk, flat = cuda_connect.new_counts(), cuda_connect.new_counts()
    t = CI._count_nearest_walk(pk, ro, rd, walk)
    assert torch.equal(t, CI.nearest_hit_plain(pk, ro, rd)["t"])
    assert torch.equal(CI._count_nearest_walk(_flat(pk), ro, rd, flat), t)
    assert (t < INF).float().mean().item() > 0.5    # the rays hit the mesh
    assert walk["hit_spheres"] == flat["hit_spheres"] == 256 * (pk.ns + pk.nl)
    assert flat["hit_boxes"] == 256 * int((pk.cl[:, 7] > 0).sum())
    assert walk["hit_boxes"] < flat["hit_boxes"] / 4
    assert 0 < walk["hit_tris"] < flat["hit_tris"]

    p1, srd, md = _segments(ts, 1024, 3)
    for rule, col in ((True, 4), (False, 5)):
        blocked = CI._count_shadow_walk(pk, p1, srd, md, col, walk)
        assert torch.equal(blocked,
                           CI.any_blocker_plain(pk, p1, srd, md, rule))
        assert 0.05 < blocked.float().mean().item() < 0.95
        assert torch.equal(CI._count_shadow_walk(_flat(pk), p1, srd, md, col,
                                                 flat), blocked)
    assert 0 < walk["shadow_boxes"] < flat["shadow_boxes"]


def _flat_reference(pk, ro, rd, p1, srd, md, col):
    """The flat walk's counts as the models counted them before the super
    walk, from brute-force distances to every primitive."""
    c = cuda_connect.new_counts()
    n_s = pk.ns + pk.nl
    tri = pk.tri[:pk.nt]
    sph_t = sphere_ts(ro, rd, pk.sph[:n_s, 0:3], pk.sph[:n_s, 3], INF)
    tri_t = triangle_ts(ro, rd, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], INF)
    clusters = [(a, n) for a, n in pk.cl[:, 6:8].long().tolist() if n > 0]
    c["hit_spheres"] = ro.shape[0] * n_s
    best, inv = sph_t.amin(dim=1), CI._safe_inv(rd)
    for k, (a, n) in enumerate(clusters):
        c["hit_boxes"] += ro.shape[0]
        ent = CI._slab_hit(pk.cl[k], ro, inv, EPSILON, best)
        c["hit_tris"] += int(ent.sum()) * n
        best = torch.where(ent, torch.minimum(best, tri_t[:, a:a + n]
                                              .amin(dim=1)), best)
    t = triangle_ts(p1, srd, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                    md[:, None])
    tri_occ = (t < INF) & (t > SHADOW_EPS) & (tri[:, col + 5] > 0.0)[None]
    sph = pk.sph[:pk.ns]
    t = sphere_ts(p1, srd, sph[:, 0:3], sph[:, 3], md[:, None])
    sph_occ = (t < INF) & (t > SHADOW_EPS) & (sph[:, col] > 0.0)[None]
    sph_cb = torch.cumsum((sph[:, col] > 0.0).long(), 0)
    hit = sph_occ.any(dim=1)
    c["shadow_spheres"] = int(torch.where(
        hit, sph_cb[torch.argmax(sph_occ.int(), dim=1)], sph_cb[-1]).sum())
    alive, inv = ~hit, CI._safe_inv(srd)
    tri_cb = tri[:, col + 5] > 0.0
    for k, (a, n) in enumerate(clusters):
        c["shadow_boxes"] += int(alive.sum())
        ent = alive & CI._slab_hit(pk.cl[k], p1, inv, SHADOW_EPS, md)
        cb = torch.cumsum(tri_cb[a:a + n].long(), 0)
        occ = tri_occ[:, a:a + n]
        hit = ent & occ.any(dim=1)
        c["shadow_tris"] += int(torch.where(
            hit, cb[torch.argmax(occ.int(), dim=1)],
            torch.where(ent, cb[-1], 0)).sum())
        alive = alive & ~hit
    return c


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_walk_models_count_cornell_as_before(dielectrics_block):
    """Below 64 clusters the walk is the flat one: cornell's counts equal
    the flat walk's as it was counted before the supers."""
    _, _, ts, _ = jax_cornell(8, 8)
    pk = CI.pack_scene(ts)
    assert pk.n_super == 0
    rs = np.random.default_rng(11)
    ro = torch.from_numpy(rs.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32))
    rd, _, _ = shadow_ray(torch.zeros_like(ro), torch.from_numpy(
        rs.normal(size=(2048, 3)).astype(np.float32)))
    p1 = torch.from_numpy(rs.uniform(-0.95, 0.95, (2048, 3))
                          .astype(np.float32))
    srd, _, md = shadow_ray(p1, torch.from_numpy(
        rs.uniform(-0.95, 0.95, (2048, 3)).astype(np.float32)))
    col = 4 if dielectrics_block else 5
    got = cuda_connect.new_counts()
    CI._count_nearest_walk(pk, ro, rd, got)
    CI._count_shadow_walk(pk, p1, srd, md, col, got)
    assert got == _flat_reference(pk, ro, rd, p1, srd, md, col)
    assert all(got[k] > 0 for k in WALK + SHADOW)


@pytest.mark.parametrize("mask", ["all", "none", "random"])
@pytest.mark.parametrize("walk", ["flat", "super"])
def test_plain_counts_with_live_are_the_live_lanes_walks(walk, mask):
    """Given ``live``, the plain versions count the walk model's tests of
    the live lanes and nothing for the others (what the counting builds
    of #1 and #2 are held to), under both blocking rules."""
    if walk == "flat":
        _, _, ts, _ = jax_cornell(8, 8)
        rs = np.random.default_rng(12)
        ro = torch.from_numpy(rs.uniform(-0.9, 0.9, (1024, 3))
                              .astype(np.float32))
        rd, _, _ = shadow_ray(torch.zeros_like(ro), torch.from_numpy(
            rs.normal(size=(1024, 3)).astype(np.float32)))
        p1, srd, md = _segments(ts, 1024, 13)
    else:
        p, _, ts = _icosphere()
        ro, rd = _aimed_rays(p, ts, n=1024, seed=14)
        p1, srd, md = _segments(ts, 1024, 15)
    pk = CI.pack_scene(ts)
    assert (pk.n_super > 0) == (walk == "super")
    live = (torch.from_numpy(np.random.default_rng(16).uniform(size=1024)
                             < 0.4) if mask == "random"
            else torch.full((1024,), mask == "all", dtype=torch.bool))
    got, want = cuda_connect.new_counts(), cuda_connect.new_counts()
    hit = CI.nearest_hit_plain(pk, ro, rd, live=live, counts=got)
    t = CI._count_nearest_walk(pk, ro[live], rd[live], want)
    assert torch.equal(hit["t"][live], t)
    for rule, col in ((True, 4), (False, 5)):
        blocked = CI.any_blocker_plain(pk, p1, srd, md, rule, live=live,
                                       counts=got)
        assert torch.equal(blocked[live], CI._count_shadow_walk(
            pk, p1[live], srd[live], md[live], col, want))
        assert not blocked[~live].any()
    assert got == want
    assert (got["hit_spheres"] == 0) == (mask == "none")
    assert got["hit_spheres"] == int(live.sum()) * (pk.ns + pk.nl)


def test_stream_shadow_walk_hand_counted():
    """#7's walk model on a floor of two triangles (one cluster, one
    block: the flat walk) under a sphere: (a) the sphere blocks first;
    (b) the first triangle blocks; (c) the second does, after the first is
    tested; (d) the segment ends before the floor's box."""
    st = CS.pack_scene_stream(parse_scene_text(BLOCKER).to_device("cpu"))
    assert st.n_super == 0 and st.ns == 1
    p1 = torch.tensor([[0.0, 1.0, 0.0], [1.5, 1.0, 0.0], [-1.5, 1.0, 0.5],
                       [1.5, 1.0, 0.0]])
    rd = torch.tensor([[0.0, -1.0, 0.0]] * 4)
    md = torch.tensor([3.0, 3.0, 3.0, 1.0])
    for rule in (True, False):
        counts = CS.new_counts()
        blocked = CS._count_stream_shadow_walk(st, p1, rd, md, rule, counts)
        assert blocked.tolist() == [True, True, True, False]
        assert torch.equal(blocked, CS.any_blocker_stream_plain(
            st, p1, rd, md, rule))
        assert counts == dict(rays=4, spheres=4, supers=0, clusters=3,
                              blocks=2, tris=3, tri_lanes=0, tri_slots=0)


def test_stream_shadow_walk_matches_the_brute_force():
    """On the 17,000-triangle icosphere (512 clusters: the super walk),
    the model's verdicts are the brute force's under both rules, and its
    counts a sum over segments."""
    _, _, ts = _icosphere()
    st = CS.pack_scene_stream(ts)
    assert st.use_super
    p1, srd, md = _segments(ts, 2000, 9)
    for rule in (True, False):
        counts = CS.new_counts()
        blocked = CS._count_stream_shadow_walk(st, p1, srd, md, rule, counts)
        assert torch.equal(blocked, CS.any_blocker_stream_plain(
            st, p1, srd, md, rule))
        assert 0.05 < blocked.float().mean().item() < 0.95
        assert counts["rays"] == 2000
        assert 0 < counts["supers"] <= 2000 * st.n_super
        assert 0 < counts["clusters"] <= CS.SUPER * counts["supers"]
        assert 0 < counts["tris"] <= 2000 * st.nt
        perm = torch.from_numpy(np.random.default_rng(10).permutation(2000))
        again = CS.new_counts()
        assert torch.equal(CS._count_stream_shadow_walk(
            st, p1[perm], srd[perm], md[perm], rule, again), blocked[perm])
        assert again == counts


# ---------------------------------------------------------------------------
# the textured bounce above 64 clusters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tex_mesh():
    return _icosphere(17000, textured=True)


def _state(ro, rd):
    B = ro.shape[0]
    return dict(ro=ro, rd=rd, tp=torch.ones(B, 3), eta=torch.ones(B),
                depth=torch.zeros(B, dtype=torch.int32),
                alive=torch.ones(B, dtype=torch.bool),
                last_is_delta=torch.ones(B, dtype=torch.bool),
                last_pdf=torch.ones(B))


def test_shade_step_tex_above_64_clusters_matches_pallas(tex_mesh):
    """256 lanes on the textured 17,000-triangle icosphere (the super walk
    on both sides): half at their aimed ray, half after one bounce."""
    p, js, ts = tex_mesh
    pk, lt = CI.pack_scene(ts), ts.packed.light
    assert pk.n_super == 32 and pk.textured
    ro, rd = _aimed_rays(p, ts)
    key = rng.prng_key(12)
    kw = dict(clamp_val=15.0, stub_mis=False, dielectrics_block=True)
    st = _state(ro, rd)
    u = rng.uniform_rows(rng.iter_key(key, 0), 256, 8)
    out = cuda_shade.shade_step_tex(pk, lt, *st.values(), u, **kw)
    cam_lane = torch.arange(256) % 2 == 0
    st = {k: torch.where(cam_lane if v.dim() == 1 else cam_lane[:, None],
                         v, out[k]) for k, v in st.items()}
    u = rng.uniform_rows(rng.iter_key(key, 1), 256, 8)
    got = cuda_shade.shade_step_tex(pk, lt, *st.values(), u, **kw)

    j = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    ju = tuple(jnp.asarray(u[i].numpy()) for i in range(6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_TPU_INTERPRET", "1")
        jax.clear_caches()
        h = nearest_hit_pallas(js, j["ro"], j["rd"], with_uv=True)
        tex_id = h["tex"].astype(jnp.int32)
        texel = jtexture.sample_bilinear(js.tex_atlas, js.tex_size, tex_id,
                                         jnp.stack([h["iu"], h["iv"]], -1))
        bc = jnp.stack([h["bcr"], h["bcg"], h["bcb"]], -1)
        bc_mod = jnp.where((tex_id >= 0)[:, None], bc * texel, bc)
        ref = shade_step_tex_pallas(js, j_light_table(js), h, bc_mod,
                                    *j.values(), ju, **kw)
    jax.clear_caches()
    # the aimed half hits the mesh; the bounced half mostly leaves it
    assert (np.asarray(h["flag"]) > 0).mean() > 0.3
    for f in got:
        a, b = np.asarray(ref[f]), got[f].numpy()
        assert a.shape == b.shape, f
        ok = np.isclose(a.astype(np.float64), b.astype(np.float64),
                        rtol=1e-4, atol=1e-5)
        if ok.ndim > 1:
            ok = ok.all(axis=1)
        assert ok.mean() >= 0.999, (f, ok.mean())
    assert float(got["radiance"].sum()) > 0.0


def test_shade_step_tex_plain_counts_its_walks(tex_mesh):
    """The textured bounce's plain counts (``STEP_COUNTS``): its active
    lanes, their nearest-hit walks and the NEE lanes' shadow walks as the
    walk models count them, and the outputs unchanged by counting."""
    p, _, ts = tex_mesh
    pk, lt = CI.pack_scene(ts), ts.packed.light
    ro, rd = _aimed_rays(p, ts, 512, 4)
    st = _state(ro, rd)
    st["alive"] = torch.arange(512) % 4 != 0
    u = rng.uniform_rows(rng.iter_key(rng.prng_key(13), 0), 512, 8)
    kw = dict(clamp_val=15.0, stub_mis=True, dielectrics_block=False)
    c = cuda_wavefront.new_counts()
    out = cuda_shade.shade_step_tex_plain(pk, lt, *st.values(), u, **kw,
                                          counts=c)
    ref = cuda_shade.shade_step_tex_plain(pk, lt, *st.values(), u, **kw)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    walk = cuda_connect.new_counts()
    CI._count_nearest_walk(pk, ro[st["alive"]], rd[st["alive"]], walk)
    assert c["iterations"] == 384
    assert {k: c[k] for k in WALK} == {k: walk[k] for k in WALK}
    assert c["shadow_rays"] == c["evals"] == c["pdfs"] > 0
    assert c["iterations"] >= c["bsdf_samples"] >= c["shadow_rays"]
    assert c["shadow_spheres"] == 0 < c["shadow_boxes"]   # no spheres block
    assert all(c[k] == 0 for k in c
               if k not in cuda_shade.STEP_COUNTS + ("draws",))
