"""The CUDA kernels against their plain versions on the card, the PT and
BDPT megakernels' images against their fused tiers', the PPM kernels
launched twice on the same inputs, the streamed mesh kernels against #1/#2
and their plain versions, and the fetch probe against ``tab[:, idx]``.

These need an NVIDIA card, nvcc and the port's build, so they skip
without a card.  This file imports neither jax nor the JAX package; where
jax is not installed, run it without the suite's conftest (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators.pt import _light_table, render_pt
from path_tracing_tpu_torch.ops import (_kernels, cuda_connect,
                                        cuda_intersect, cuda_shade)
from path_tracing_tpu_torch.ops import intersect, rng
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.camera import make_camera, primary_ray_dirs
from path_tracing_tpu_torch.scene.parser import load_scene

CORNELL = Path(__file__).resolve().parent.parent / "scenes" / "cornell.txt"
SPHERE_OBJ = Path(__file__).resolve().parent / "fixtures" / "sphere.obj"
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _kernels.library()          # builds, or raises with nvcc's output
    scene = load_scene(str(CORNELL)).to_device("cuda")
    return scene, cuda_intersect.pack_scene(scene)


def _rays(n, seed, lo=-0.9, hi=0.9):
    u = rng.uniform_rows(rng.prng_key(seed), n, 8, device="cuda")
    ro = (lo + (hi - lo) * u[0:3]).T.contiguous()
    rd = (u[3:6] - 0.5).T.contiguous()
    return ro, intersect.shadow_ray(torch.zeros_like(rd), rd)[0]


def test_nearest_hit_kernel_matches_plain(card):
    _, pk = card
    ro, rd = _rays(1 << 16, 0)
    a = cuda_intersect.nearest_hit(pk, ro, rd)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd)
    torch.cuda.synchronize()
    assert torch.equal(a["flag"], b["flag"])
    same = torch.isclose(a["t"], b["t"], rtol=1e-5)
    assert same.float().mean().item() >= 0.9995


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_any_blocker_kernel_matches_plain(card, dielectrics_block):
    _, pk = card
    p1, _ = _rays(1 << 16, 1, -0.95, 0.95)
    p2, _ = _rays(1 << 16, 2, -0.95, 0.95)
    rd, _, md = intersect.shadow_ray(p1, p2)
    a = cuda_intersect.any_blocker(pk, p1, rd, md, dielectrics_block)
    b = cuda_intersect.any_blocker_plain(pk, p1, rd, md, dielectrics_block)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# #1 and #2 with a lane mask, and their counting builds
# ---------------------------------------------------------------------------

MASKS = ("all", "none", "random")


@pytest.fixture(scope="module")
def super_mesh(card):
    """The textured 17,000-triangle icosphere: 512 clusters, the super
    walk."""
    scene = synth.icosphere_scene(17000, textured=True).to_device("cuda")
    pk = cuda_intersect.pack_scene(scene)
    assert pk.n_super > 0
    return pk


def _walk_case(card, super_mesh, walk, seed):
    """The scene of a walk and 65,536 rays through it: cornell's (the flat
    walk) from inside the box, the icosphere's (the super walk) from a
    box three times its size, half of them aimed at its centre."""
    n = 1 << 16
    if walk == "flat":
        return card[1], _rays(n, seed)
    ro, rd = _rays(n, seed, -3.0, 3.0)
    aim = intersect.shadow_ray(ro, -0.1 * ro)[0]
    half = (torch.arange(n, device="cuda") % 2 == 0)[:, None]
    return super_mesh, (ro, torch.where(half, aim, rd).contiguous())


def _mask(kind, n, seed):
    if kind == "random":
        return rng.uniform_rows(rng.prng_key(seed), n, 1,
                                device="cuda")[0] < 0.4
    return torch.full((n,), kind == "all", dtype=torch.bool, device="cuda")


def _same_bits(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
               if a[k].dtype == torch.float32 else torch.equal(a[k], b[k])
               for k in b)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("with_uv", [False, True])
@pytest.mark.parametrize("walk", ["flat", "super"])
def test_nearest_hit_with_a_mask_matches_plain_bit_for_bit(
        card, super_mesh, walk, with_uv, mask):
    """#1 given ``live``: every lane's record the plain version's bit for
    bit (the lanes that are not live the miss record), and its counting
    build's records #1's and its counters the plain version's count of the
    live lanes' walks exactly."""
    pk, (ro, rd) = _walk_case(card, super_mesh, walk, 20)
    live = _mask(mask, ro.shape[0], 21)
    a = cuda_intersect.nearest_hit(pk, ro, rd, with_uv, live)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd, with_uv, live)
    assert _same_bits(a, b)
    assert (a["flag"][~live] == 0).all()
    if mask != "none":
        assert (a["flag"][live] > 0).float().mean().item() > 0.3
    k, kc = cuda_intersect.nearest_hit_counts(pk, ro, rd, with_uv, live)
    assert _same_bits(k, a)
    pc = cuda_connect.new_counts()
    cuda_intersect.nearest_hit_plain(pk, ro, rd, with_uv, live, counts=pc)
    for name in ("hit_spheres", "hit_boxes", "hit_tris"):
        assert kc[name] == pc[name], name
    assert (kc["hit_spheres"] == 0) == (mask == "none")


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dielectrics_block", [True, False])
@pytest.mark.parametrize("walk", ["flat", "super"])
def test_any_blocker_with_a_mask_matches_plain_bit_for_bit(
        card, super_mesh, walk, dielectrics_block, mask):
    """#2 given ``live``: every lane's verdict the plain version's (the
    lanes that are not live false), and its counting build's verdicts #2's
    and its counters the plain version's count of the live lanes' walks
    exactly."""
    pk, (p1, d) = _walk_case(card, super_mesh, walk, 22)
    length = 0.05 + 1.5 * rng.uniform_rows(rng.prng_key(23), p1.shape[0], 1,
                                            device="cuda")[0]
    rd, _, md = intersect.shadow_ray(p1, p1 + d * length[:, None])
    live = _mask(mask, p1.shape[0], 24)
    a = cuda_intersect.any_blocker(pk, p1, rd, md, dielectrics_block, live)
    b = cuda_intersect.any_blocker_plain(pk, p1, rd, md, dielectrics_block,
                                         live)
    assert torch.equal(a, b)
    assert not a[~live].any()
    if mask != "none":
        assert 0.05 < a[live].float().mean().item() < 0.95
    k, kc = cuda_intersect.any_blocker_counts(pk, p1, rd, md,
                                              dielectrics_block, live)
    assert torch.equal(k, a)
    pc = cuda_connect.new_counts()
    cuda_intersect.any_blocker_plain(pk, p1, rd, md, dielectrics_block, live,
                                     counts=pc)
    for name in ("shadow_spheres", "shadow_boxes", "shadow_tris"):
        assert kc[name] == pc[name], name


@pytest.fixture(scope="module")
def mesh(card):
    scene = synth.icosphere_scene(1280, textured=True).to_device("cuda")
    return scene, cuda_intersect.pack_scene(scene)


def _state(ro, rd):
    B = ro.shape[0]
    return (ro, rd, torch.ones(B, 3, device="cuda"),
            torch.ones(B, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, device="cuda"))


@pytest.mark.parametrize("textured", [False, True])
def test_shade_step_kernels_match_plain(card, mesh, textured):
    scene, pk = mesh if textured else card
    fast, plain = ((cuda_shade.shade_step_tex, cuda_shade.shade_step_tex_plain)
                   if textured else
                   (cuda_shade.shade_step, cuda_shade.shade_step_plain))
    lt = _light_table(scene)
    B = 1 << 15
    ro, rd = _rays(B, 3)
    if textured:   # rays from outside toward the icosphere
        rd = intersect.shadow_ray(ro * 4.0, -ro)[0]
        ro = (ro * 4.0).contiguous()
    u = rng.uniform_rows(rng.prng_key(4), B, 8, device="cuda")
    kw = dict(clamp_val=RenderConfig().clamp, stub_mis=True,
              dielectrics_block=True)
    a = fast(pk, lt, *_state(ro, rd), u, **kw)
    b = plain(pk, lt, *_state(ro, rd), u, **kw)
    for k in a:
        ok = torch.isclose(a[k].double(), b[k].double(), rtol=1e-4,
                           atol=1e-5)
        if ok.dim() > 1:
            ok = ok.all(dim=1)
        assert ok.float().mean().item() >= 0.999, k


def test_nearest_hit_with_uv_kernel_matches_plain(mesh):
    _, pk = mesh
    ro, rd = _rays(1 << 16, 5, -3.0, 3.0)
    a = cuda_intersect.nearest_hit(pk, ro, rd, with_uv=True)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd, with_uv=True)
    assert torch.equal(a["flag"], b["flag"]) and torch.equal(a["tex"],
                                                             b["tex"])
    hit = b["flag"] > 0
    for f in ("iu", "iv"):
        ok = (a[f] - b[f]).abs() <= 1e-5
        assert ok[hit].float().mean().item() >= 0.9995, f


def test_threefry_rows_kernel_is_bit_exact(card):
    k = rng.iter_key(rng.make_key(3, 1), 9)
    a = rng.uniform_rows(k, 100_000, 8, start=7, total=200_000,
                         device="cuda")
    b = rng.uniform_rows_plain(k, 100_000, 8, start=7, total=200_000,
                               device="cuda")
    assert torch.equal(a, b)
    assert a[3, 11].item() == rng.uniform_at(k, 3, 11, 7, 200_000)


def test_megakernel_equals_fused_tier(card):
    scene, _ = card
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48,
                      device="cuda")
    cfg = RenderConfig(width=64, height=48, eye_depth=4)
    key = rng.prng_key(0)
    imgs = [render_pt(scene, cam, 64, 48, 4, cfg, key, tier=t)
            for t in ("mega", "fused")]
    assert torch.equal(imgs[0], imgs[1])


def _bdpt_table(scene, key, K=0, cam=None, w=0, h=0):
    """The spl 4 light-vertex table of a w x h BDPT frame on ``scene``, as
    the mega tier builds it: the compacted (V, 40) one, or with K > 0 the
    tile-local RIS tables; with the scene whose flux it scaled."""
    from path_tracing_tpu_torch.integrators import bdpt

    cfg = RenderConfig(width=w, height=h, eye_depth=4, light_depth=4,
                       bdpt_resample_vertices=K)
    used, lv, _ = bdpt.light_side(scene, cfg, 4, key)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % w, idx // w, key)
    return used, tab, nv


def test_connect_kernel_matches_plain(card):
    from path_tracing_tpu_torch.ops import cuda_connect
    from path_tracing_tpu_torch.ops.math3 import normalize

    scene, _ = card
    key = rng.prng_key(6)
    used, tab, nv = _bdpt_table(scene, key)
    pk = cuda_intersect.pack_scene(used)
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 128, 96,
                      device="cuda")
    B = 128 * 96
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    u = rng.uniform_rows(key, B, 6, device="cuda")
    rd = primary_ray_dirs(cam, idx % 128, idx // 128, u[0], u[1])
    ro = cam.eye[None].expand(B, 3).contiguous()
    hit = intersect.hit_from_fields(cuda_intersect.nearest_hit(pk, ro, rd),
                                    ro, rd)
    act = hit.hit & ~hit.is_light
    eye_f = torch.where(hit.mtl.eta > 0.0, torch.zeros_like(u[2]),
                        1e8 * (1.0 + 4.0 * u[2]))
    args = (pk, tab, nv, hit.pos, hit.normal, (0.5 + 0.5 * u[3:6].T)
            .contiguous(), hit.mtl, -rd, normalize(cam.eye[None] - hit.pos),
            eye_f, act)
    a = cuda_connect.connect(*args, clamp_val=15.0, dielectrics_block=True)
    b = cuda_connect.connect_plain(*args, clamp_val=15.0,
                                   dielectrics_block=True)
    rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
    assert act.float().mean().item() > 0.9
    assert (rel < 1e-3).all().item(), rel.max().item()


@pytest.mark.parametrize("K", [0, 32])
def test_bdpt_eye_kernel_matches_plain(card, K):
    """#9 against its plain version on the same table (shared, or
    tile-local RIS): mean within 1e-3, 99% of pixels within rtol 1e-4 /
    atol 1e-5 (they draw the same numbers and add in the same order)."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye

    scene, _ = card
    w, h = 160, 120
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    key = rng.prng_key(7)
    used, tab, nv = _bdpt_table(scene, key, K, cam, w, h)
    pk = cuda_intersect.pack_scene(used)
    cfg = RenderConfig(width=w, height=h, eye_depth=4, light_depth=4)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    args = (pk, tab, nv, cam, idx % w, idx // w, 2, cfg, key, 4.0)
    a = cuda_bdpt_eye.bdpt_eye(*args)
    b = cuda_bdpt_eye.bdpt_eye_plain(*args)
    assert abs(a.mean().item() - b.mean().item()) < 1e-3 * b.mean().item()
    ok = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=1)
    assert ok.float().mean().item() >= 0.99


def _bdpt_args(parsed, K, w=128, h=72, spp=4):
    """#9's arguments for a w x h spp 4 BDPT frame (spl 8, depths 4, seed
    0) on a parsed scene, as the mega tier builds them."""
    from path_tracing_tpu_torch.integrators import bdpt

    scene = parsed.to_device("cuda")
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      w, h, device="cuda")
    cfg = RenderConfig(width=w, height=h, spp=spp, spl=8, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=K)
    key = rng.fold_in(rng.prng_key(0), 0)
    used, lv, scale = bdpt.light_side(scene, cfg, 8, key)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % w, idx // w, key)
    return (cuda_intersect.pack_scene(used), tab, nv, cam, idx % w, idx // w,
            spp, cfg, key, scale)


BDPT_CASES = {"tile-RIS K=32": (CORNELL, 32), "exact": (CORNELL, 0),
              "icosphere tile-RIS K=32": (None, 32)}


@pytest.mark.parametrize("case", sorted(BDPT_CASES))
def test_bdpt_eye_kernel_matches_plain_at_128x72(card, case):
    """The warp-cooperative #9 against its plain version at 128x72 spp 4:
    tile-RIS K = 32 and the exact sweep on cornell, and tile-RIS K = 32 on
    a second scene, the 1,280-triangle icosphere.  Mean within 1e-3 and
    >= 99% of pixels within rtol 1e-4 / atol 1e-5 (chip_smoke.py's bar)."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye

    path, K = BDPT_CASES[case]
    parsed = load_scene(str(path)) if path else synth.icosphere_scene(1280)
    args = _bdpt_args(parsed, K)
    a = cuda_bdpt_eye.bdpt_eye(*args)
    b = cuda_bdpt_eye.bdpt_eye_plain(*args)
    assert b.mean().item() > 0
    assert abs(a.mean().item() - b.mean().item()) < 1e-3 * b.mean().item()
    ok = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=1)
    assert ok.float().mean().item() >= 0.99


@pytest.mark.parametrize("K", [32, 0])
def test_bdpt_eye_counting_build_matches_plain_counts(card, K):
    """The counting build's counters equal the plain version's count of
    the same work, the walks' tests in the kernels' cluster order, within
    0.1% (a rounding flip may move a rare lane), its image is the
    plain build's bit for bit, and its SIMT efficiencies are shares."""
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye, cuda_connect

    args = _bdpt_args(load_scene(str(CORNELL)), K)
    img, kc = cuda_bdpt_eye.bdpt_eye_counts(*args)
    assert torch.equal(img, cuda_bdpt_eye.bdpt_eye(*args))
    pc = cuda_connect.new_counts()
    cuda_bdpt_eye.bdpt_eye_plain(*args, counts=pc)
    for k in cuda_connect.PLAIN_COUNTS:
        assert pc[k] > 0 and abs(kc[k] - pc[k]) <= 1e-3 * pc[k], k
    assert kc["shadow_tris"] > 0 and kc["hit_boxes"] > 0
    for k in ("row", "shadow"):
        assert 0 < kc[f"{k}_lanes"] <= kc[f"{k}_slots"]


def test_connect_counting_build_matches_plain_counts(card):
    from path_tracing_tpu_torch.ops import cuda_connect
    from path_tracing_tpu_torch.ops.math3 import normalize

    pk, tab, nv, cam, px, py, _, _, key, _ = _bdpt_args(
        load_scene(str(CORNELL)), 0)
    u = rng.uniform_rows(key, px.shape[0], 6, device="cuda")
    rd = primary_ray_dirs(cam, px, py, u[0], u[1])
    ro = cam.eye[None].expand(px.shape[0], 3).contiguous()
    hit = intersect.hit_from_fields(cuda_intersect.nearest_hit(pk, ro, rd),
                                    ro, rd)
    act = hit.hit & ~hit.is_light
    args = (pk, tab, nv, hit.pos, hit.normal, (0.5 + 0.5 * u[3:6].T)
            .contiguous(), hit.mtl, -rd, normalize(cam.eye[None] - hit.pos),
            1e8 * (1.0 + u[2]) * (hit.mtl.eta <= 0.0), act)
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    out, kc = cuda_connect.connect_counts(*args, **kw)
    assert torch.equal(out, cuda_connect.connect(*args, **kw))
    pc = cuda_connect.new_counts()
    cuda_connect.connect_plain(*args, **kw, counts=pc)
    for k in cuda_connect.PLAIN_COUNTS:
        # connect draws no samples and casts no nearest-hit rays
        assert (pc[k] > 0) == (k != "samples" and not k.startswith("hit_")), k
        assert abs(kc[k] - pc[k]) <= 1e-3 * pc[k], k


@pytest.mark.parametrize("D,rows", [(4352, 0), (4352, 3), (1003, 5)])
def test_onehot_fetch_kernel_edges(card, D, rows):
    """#12 at no rows, at the indices -1, 0, D - 1 and D (outside [0, D)
    gives 0), and at a D that is not a multiple of 32."""
    from path_tracing_tpu_torch.ops import probes

    g = torch.Generator(device="cuda").manual_seed(D + rows)
    tab = torch.rand((12, D), device="cuda", generator=g)
    idx = torch.randint(-1, D + 1, (rows, 128), device="cuda", generator=g,
                        dtype=torch.int32)
    if rows:
        idx[0, :4] = torch.tensor([-1, 0, D - 1, D], dtype=torch.int32)
    out = probes.onehot_fetch(tab, idx)
    assert out.shape == (rows * 12, 128)
    assert torch.equal(out, probes.onehot_fetch_plain(tab, idx))
    inside = (idx >= 0) & (idx < D)
    ref = (tab[:, idx.clamp(0, D - 1).long()] * inside).permute(1, 0, 2)
    assert torch.equal(out, ref.reshape(rows * 12, 128))
    if rows:
        assert (out[0:12, [0, 3]] == 0).all()
        assert torch.equal(out[0:12, 1], tab[:, 0])
        assert torch.equal(out[0:12, 2], tab[:, D - 1])


def test_bdpt_megakernel_equals_fused_tier(card):
    """The exact sweep in one bdpt_eye launch and in the per-bounce tier
    (nearest_hit + connect + threefry_rows): the same numbers drawn and
    added in the same order."""
    from path_tracing_tpu_torch.integrators.bdpt import render_bdpt

    scene, _ = card
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48,
                      device="cuda")
    cfg = RenderConfig(width=64, height=48, eye_depth=4, light_depth=4)
    a, b = (render_bdpt(scene, cam, 64, 48, 2, 4, cfg, rng.prng_key(0),
                        tier=t) for t in ("mega", "fused"))
    ok = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=1)
    assert ok.float().mean().item() >= 0.999


@pytest.fixture(scope="module")
def stream_mesh(card):
    """sphere.obj at leaf 32 (72 clusters: the super walk is on), packed
    for #1/#2 and for #6/#7."""
    from path_tracing_tpu_torch.ops import cuda_stream
    from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

    scene = load_any_scene(str(SPHERE_OBJ)).to_device("cuda",
                                                      cluster_leaf_size=32)
    st = cuda_stream.pack_scene_stream(scene)
    assert st.use_super
    return cuda_intersect.pack_scene(scene), st


def _mesh_rays(n, seed):
    """Rays from inside the box around the sphere: half of them aimed at
    its centre, the rest in random directions."""
    ro, rd = _rays(n, seed)
    aim = intersect.shadow_ray(ro, -0.1 * ro)[0]
    half = (torch.arange(n, device="cuda") % 2 == 0)[:, None]
    return ro, torch.where(half, aim, rd).contiguous()


def test_nearest_hit_stream_matches_nearest_hit_and_plain(stream_mesh):
    """#6 against #1 (flags equal on >= 99.99% of rays, t bit-equal on
    >= 99.95%: the same Moller-Trumbore on the same edges; ties at one t
    may pick another triangle) and against its plain brute force (t, idx
    and kind equal on >= 99.95%), on sorted rays as the path runs it."""
    from path_tracing_tpu_torch.ops import cuda_stream as cst

    pk, st = stream_mesh
    ro, rd = _mesh_rays(1 << 16, 8)
    a = cst.stream_hit(st, ro, rd, with_uv=True)
    b = cuda_intersect.nearest_hit(pk, ro, rd, with_uv=True)
    assert (a["flag"] == b["flag"]).float().mean().item() >= 0.9999
    assert (a["t"] == b["t"]).float().mean().item() >= 0.9995
    tri = (a["flag"] == 1) & (a["t"] == b["t"])
    assert tri.float().mean().item() > 0.3
    for f in ("iu", "iv"):
        ok = (a[f] - b[f]).abs() <= 1e-5
        assert ok[tri].float().mean().item() >= 0.999, f
    k = cst.nearest_hit_stream(st, ro, rd)
    p = cst.nearest_hit_stream_plain(st, ro, rd)
    same = (k[0] == p[0]) & (k[1] == p[1]) & (k[2] == p[2])
    assert same.float().mean().item() >= 0.9995


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_any_blocker_stream_matches_any_blocker_and_plain(
        stream_mesh, dielectrics_block):
    from path_tracing_tpu_torch.ops import cuda_stream as cst

    pk, st = stream_mesh
    p1, d = _mesh_rays(1 << 16, 9)
    length = 0.05 + 1.5 * rng.uniform_rows(rng.prng_key(10), 1 << 16, 1,
                                            device="cuda")[0]
    rd, _, md = intersect.shadow_ray(p1, p1 + d * length[:, None])
    a = cst.stream_blocked(st, p1, rd, md, dielectrics_block)
    b = cuda_intersect.any_blocker(pk, p1, rd, md, dielectrics_block)
    c = cst.any_blocker_stream_plain(st, p1, rd, md, dielectrics_block)
    assert 0.05 < b.float().mean().item() < 0.95
    assert (a == b).float().mean().item() >= 0.9999
    assert (a == c).float().mean().item() >= 0.9999


def test_onehot_fetch_kernel_is_exact(card):
    """#12 equals ``tab[:, idx]`` and its one-hot plain version bit for
    bit, at the probe's first shape (rows 128, D 4,352)."""
    from path_tracing_tpu_torch.ops import probes

    g = torch.Generator(device="cuda").manual_seed(0)
    tab = torch.rand((12, 4352), device="cuda", generator=g)
    idx = torch.randint(0, 4352, (128, 128), device="cuda", generator=g,
                        dtype=torch.int32)
    out = probes.onehot_fetch(tab, idx)
    ref = tab[:, idx.long()].permute(1, 0, 2).reshape(128 * 12, 128)
    assert torch.equal(out, ref)
    assert torch.equal(out, probes.onehot_fetch_plain(tab, idx))


def _ppm_frame(scene, w=128, h=72, spl=16384):
    """The first pass of a w x h PPM render of cornell (4 lights x spl
    photons, seed 0), as the integrator builds it: the frame's config, the
    eye pass's hitpoints, the packed scene, the photons' emission and the
    photon key."""
    from path_tracing_tpu_torch.integrators import ppm

    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    cfg = RenderConfig(width=w, height=h, spl=spl)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    _, hp = ppm.ppm_eye_trace(scene, cam, cfg, idx % w, idx // w,
                              rng.fold_in(key, 1))
    kp = rng.fold_in(key, 2)
    emit = ppm.photon_emission(scene, scene.num_lights * spl, spl, kp)
    return cfg, hp, cuda_intersect.pack_scene(scene), emit, kp


def test_photon_trace_kernel_matches_plain(card):
    """#10 against its plain version on 65,536 photons: the same Threefry
    draws and the same rounding, so the same events (bar: valid flags and
    every field within rtol 1e-5 / atol 1e-6 on >= 99.99% of rows, as
    chip_smoke.py holds it); two launches give bit-equal events."""
    from path_tracing_tpu_torch.ops import cuda_photon

    scene, _ = card
    cfg, _, pk, emit, kp = _ppm_frame(scene)
    args = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    ev, valid = cuda_photon.photon_trace(*args)
    ev_p, valid_p = cuda_photon.photon_trace_plain(*args)
    assert (valid == valid_p).float().mean().item() >= 0.9999
    both = valid & valid_p
    ok = torch.isclose(ev[both], ev_p[both], rtol=1e-5, atol=1e-6).all(dim=1)
    assert both.sum().item() > 65536 and ok.float().mean().item() >= 0.9999
    ev2, valid2 = cuda_photon.photon_trace(*args)
    assert torch.equal(valid, valid2) and torch.equal(ev[valid], ev2[valid])


def test_gather_flux_kernel_matches_plain(card):
    """#11 against its plain version on the hitpoints of a 128x72 eye pass
    and #10's events (counts equal on >= 99.99% of hitpoints, flux within
    rtol 1e-4 / atol 1e-6 on >= 99.9%, means within 1e-5 relative: the
    same pairs in the same order, summed in another order by the plain
    index_add_); two launches give bit-equal results."""
    from path_tracing_tpu_torch.integrators.ppm import PhotonEvents
    from path_tracing_tpu_torch.ops import cuda_photon
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as gather

    scene, _ = card
    cfg, hp, pk, emit, kp = _ppm_frame(scene)
    events = PhotonEvents(*cuda_photon.photon_trace(
        pk, *emit, kp, cfg.light_depth, cfg.max_light_iters))
    t = gather.prepare(scene, cfg, hp, events)
    assert int(t.overflow) == 0 and t.candidate_pairs() > 0
    flux, count = gather.join(t)
    flux_p, count_p = gather.join_plain(t)
    assert (count == count_p).float().mean().item() >= 0.9999
    assert count.sum().item() > 0
    ok = torch.isclose(flux, flux_p, rtol=1e-4, atol=1e-6).all(dim=1)
    assert ok.float().mean().item() >= 0.999
    mean, mean_p = flux.double().mean().item(), flux_p.double().mean().item()
    assert abs(mean - mean_p) <= 1e-5 * abs(mean_p)
    flux2, count2 = gather.join(t)
    assert torch.equal(flux, flux2) and torch.equal(count, count2)


def test_render_wavefront_counting_build_matches_plain_counts(card):
    """#5's counting build gives the megakernel's image bit for bit, and
    its counters equal the plain loop's count of the same work exactly on
    a 64x48 spp 4 frame (the walks' tests in the kernel's cluster order);
    its SIMT and busy-lane shares are shares."""
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    scene, pk = card
    p = load_scene(str(CORNELL))
    w, h = 64, 48
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    cfg = RenderConfig(width=w, height=h, eye_depth=4)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    args = (pk, _light_table(scene), cam, idx % w, idx // w, 4, cfg,
            rng.prng_key(0))
    img, kc = cw.render_wavefront_counts(*args)
    assert torch.equal(img, cw.render_wavefront(*args))
    pc = cw.new_counts()
    cw.render_wavefront_plain(*args, counts=pc)
    assert {k: kc[k] for k in cw.PLAIN_COUNTS} == {
        k: pc[k] for k in cw.PLAIN_COUNTS}
    for k in ("walk", "shade", "shadow"):
        assert 0 < kc[f"{k}_lanes"] <= kc[f"{k}_slots"], k
    assert 0 < kc["iterations"] <= kc["warp_iter_slots"]


def test_shade_step_counting_build_matches_plain_counts(card):
    """#3's counting build over every bounce of a 64x48 spp 4 fused frame:
    its outputs #3's bit for bit, its counters (``STEP_COUNTS``) summed
    over the bounces equal to the plain version's exactly, and to the
    megakernel's plain counts of the same frame; its SIMT shares are
    shares."""
    from path_tracing_tpu_torch.integrators.pt import wavefront_loop
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    scene, pk = card
    p = load_scene(str(CORNELL))
    w, h = 64, 48
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    cfg = RenderConfig(width=w, height=h, eye_depth=4)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    lt = _light_table(scene)
    kc, pc = cw.new_counts(), cw.new_counts()

    def step(*args, **kw):
        out, c = cuda_shade.shade_step_counts(*args, **kw)
        ref = cuda_shade.shade_step(*args, **kw)
        for k in ref:   # bit for bit (a NaN throughput equals itself)
            assert torch.equal(
                out[k].view(torch.int32), ref[k].view(torch.int32)
            ) if ref[k].dtype == torch.float32 else torch.equal(out[k],
                                                                ref[k]), k
        cuda_shade.shade_step_plain(*args, **kw, counts=pc)
        for k in c:
            kc[k] += c[k]
        return out

    img = wavefront_loop(pk, lt, cam, cfg, idx % w, idx // w, 4,
                         rng.prng_key(0), 0, None, step)
    mega = cw.new_counts()
    assert torch.equal(img, cw.render_wavefront(
        pk, lt, cam, idx % w, idx // w, 4, cfg, rng.prng_key(0)))
    cw.render_wavefront_plain(pk, lt, cam, idx % w, idx // w, 4, cfg,
                              rng.prng_key(0), counts=mega)
    for k in cuda_shade.STEP_COUNTS:
        assert kc[k] == pc[k] == mega[k], k
    for k in ("walk", "shade", "shadow"):
        assert 0 < kc[f"{k}_lanes"] <= kc[f"{k}_slots"], k


def test_connect_kernel_on_sparse_lanes(card):
    """#8 with about a third of its lanes active (as later iterations hand
    them over): every inactive lane 0, every active lane within 1e-3 of
    the plain version, its counting build's sums #8's bit for bit and its
    counters the plain version's exactly; a sweep's busy lanes a share."""
    from path_tracing_tpu_torch.ops import cuda_connect
    from path_tracing_tpu_torch.ops.math3 import normalize

    pk, tab, nv, cam, px, py, _, _, key, _ = _bdpt_args(
        load_scene(str(CORNELL)), 0)
    B = px.shape[0]
    u = rng.uniform_rows(key, B, 7, device="cuda")
    rd = primary_ray_dirs(cam, px, py, u[0], u[1])
    ro = cam.eye[None].expand(B, 3).contiguous()
    hit = intersect.hit_from_fields(cuda_intersect.nearest_hit(pk, ro, rd),
                                    ro, rd)
    act = hit.hit & ~hit.is_light & (u[6] < 0.3)
    args = (pk, tab, nv, hit.pos, hit.normal, (0.5 + 0.5 * u[3:6].T)
            .contiguous(), hit.mtl, -rd, normalize(cam.eye[None] - hit.pos),
            1e8 * (1.0 + u[2]) * (hit.mtl.eta <= 0.0), act)
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    a = cuda_connect.connect(*args, **kw)
    pc = cuda_connect.new_counts()
    b = cuda_connect.connect_plain(*args, **kw, counts=pc)
    assert 0.2 < act.float().mean().item() < 0.4
    assert bool((a[~act] == 0).all())
    rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
    assert (rel < 1e-3).all().item(), rel.max().item()
    out, kc = cuda_connect.connect_counts(*args, **kw)
    assert torch.equal(out, a)
    assert {k: kc[k] for k in cuda_connect.PLAIN_COUNTS} == {
        k: pc[k] for k in cuda_connect.PLAIN_COUNTS}
    assert kc["vertices"] == int(act.sum())
    assert kc["vertices"] == kc["sweep_lanes"] <= kc["sweep_slots"]


def test_connect_kernel_streams_a_table_too_large_to_stage(card):
    """A light-vertex table above the block's shared memory (spl 16: more
    than 1,068 rows) streams through per-warp chunks: #8 against its plain
    version on 64x48 primary hits, its counting build's counters the plain
    version's exactly."""
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops import cuda_connect
    from path_tracing_tpu_torch.ops.math3 import normalize

    scene, _ = card
    p = load_scene(str(CORNELL))
    w, h = 64, 48
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    cfg = RenderConfig(width=w, height=h, eye_depth=4, light_depth=4,
                       bdpt_resample_vertices=0)
    key = rng.prng_key(9)
    used, lv, _ = bdpt.light_side(scene, cfg, 16, key)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % w, idx // w, key)
    assert nv > 1100
    pk = cuda_intersect.pack_scene(used)
    u = rng.uniform_rows(key, w * h, 6, device="cuda")
    rd = primary_ray_dirs(cam, idx % w, idx // w, u[0], u[1])
    ro = cam.eye[None].expand(w * h, 3).contiguous()
    hit = intersect.hit_from_fields(cuda_intersect.nearest_hit(pk, ro, rd),
                                    ro, rd)
    act = hit.hit & ~hit.is_light
    args = (pk, tab, nv, hit.pos, hit.normal, (0.5 + 0.5 * u[3:6].T)
            .contiguous(), hit.mtl, -rd, normalize(cam.eye[None] - hit.pos),
            1e8 * (1.0 + u[2]) * (hit.mtl.eta <= 0.0), act)
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    a = cuda_connect.connect(*args, **kw)
    pc = cuda_connect.new_counts()
    b = cuda_connect.connect_plain(*args, **kw, counts=pc)
    rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
    assert (rel < 1e-3).all().item(), rel.max().item()
    out, kc = cuda_connect.connect_counts(*args, **kw)
    assert torch.equal(out, a)
    assert {k: kc[k] for k in cuda_connect.PLAIN_COUNTS} == {
        k: pc[k] for k in cuda_connect.PLAIN_COUNTS}


def test_gather_flux_counting_build_matches_plain_counts(card):
    """#11's counting build gives the kernel's flux and counts bit for
    bit, and its counters equal the plain join's count of the same work
    exactly; its SIMT shares are shares and its largest warp is at least
    the mean."""
    from path_tracing_tpu_torch.integrators.ppm import PhotonEvents
    from path_tracing_tpu_torch.ops import cuda_photon
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as gather

    scene, _ = card
    cfg, hp, pk, emit, kp = _ppm_frame(scene)
    events = PhotonEvents(*cuda_photon.photon_trace(
        pk, *emit, kp, cfg.light_depth, cfg.max_light_iters))
    t = gather.prepare(scene, cfg, hp, events)
    flux, count, kc = gather.join_counts(t)
    f, c = gather.join(t)
    assert torch.equal(flux, f) and torch.equal(count, c)
    pc = gather.new_counts()
    gather.join_plain(t, counts=pc)
    assert {k: kc[k] for k in gather.PLAIN_COUNTS} == {
        k: pc[k] for k in gather.PLAIN_COUNTS}
    assert kc["accepted"] == int(count.sum()) > 0
    for k in ("pair", "eval"):
        assert 0 < kc[f"{k}_lanes"] <= kc[f"{k}_slots"], k
    assert kc["warp_pairs_max"] * kc["warps"] >= kc["pairs"] > 0


def test_gather_flux_raises_on_another_row_limit(card):
    """``prepare`` cuts the card's work list to the kernel's block of rows;
    a list cut to another limit (whose rows past the block would keep their
    zeros) makes ``join`` and ``join_counts`` raise before any launch."""
    import dataclasses

    from path_tracing_tpu_torch.integrators.ppm import PhotonEvents
    from path_tracing_tpu_torch.ops import cuda_photon
    from path_tracing_tpu_torch.ops import cuda_ppm_gather as gather

    scene, _ = card
    cfg, hp, pk, emit, kp = _ppm_frame(scene)
    events = PhotonEvents(*cuda_photon.photon_trace(
        pk, *emit, kp, cfg.light_depth, cfg.max_light_iters))
    t = gather.prepare(scene, cfg, hp, events)
    block = gather.kernel_rows()
    assert t.rows == block > 0
    wide = dataclasses.replace(
        t, items=gather.work_list(t.hp_cell, t.win, 2 * block),
        rows=2 * block)
    launched = dict(_kernels.launches)
    with pytest.raises(ValueError, match="work list"):
        gather.join(wide)
    with pytest.raises(ValueError, match="work list"):
        gather.join_counts(wide)
    assert _kernels.launches == launched


def test_photon_trace_counting_build_matches_plain_counts(card):
    """#10's counting build gives the kernel's events bit for bit, and its
    counters equal the plain loop's count of the same work exactly on
    65,536 photons (the walk's tests in the kernel's cluster order); its
    SIMT and busy-lane shares are shares; a launch with photons that are
    not real leaves their rows empty."""
    from path_tracing_tpu_torch.ops import cuda_photon as cp

    scene, _ = card
    cfg, _, pk, emit, kp = _ppm_frame(scene)
    args = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    ev, valid, kc = cp.photon_trace_counts(*args)
    ev0, valid0 = cp.photon_trace(*args)
    assert torch.equal(valid, valid0) and torch.equal(ev[valid], ev0[valid])
    pc = cp.new_counts()
    cp.photon_trace_plain(*args, counts=pc)
    assert {k: kc[k] for k in cp.PLAIN_COUNTS} == {
        k: pc[k] for k in cp.PLAIN_COUNTS}
    assert kc["deposits"] == int(valid.sum()) > 0
    assert 0 < kc["bounce_lanes"] <= kc["bounce_slots"]
    assert 0 < kc["bounces"] <= kc["warp_bounce_slots"]
    real = emit[3] & (torch.arange(emit[3].shape[0], device="cuda") % 3 > 0)
    ev_r, valid_r = cp.photon_trace(pk, *emit[:3], real, kp,
                                    cfg.light_depth, cfg.max_light_iters)
    lanes = torch.arange(valid_r.shape[0], device="cuda") % emit[3].shape[0]
    assert not valid_r[~real[lanes]].any()
    keep = valid_r & valid
    assert torch.equal(valid_r, valid & real[lanes])
    assert torch.equal(ev_r[keep], ev[keep])


def test_nearest_hit_stream_counting_build_matches_plain_counts(stream_mesh):
    """#6's counting build gives the kernel's (t, idx, kind) bit for bit,
    and its counters equal the plain model of its walk
    (``_count_stream_walk``) exactly on 65,536 sorted rays with a third of
    them dead; the model's t is the kernel's; the triangle test's SIMT is
    a share."""
    from path_tracing_tpu_torch.ops import cuda_stream as cst
    from path_tracing_tpu_torch.ops.intersect import sorted_call

    _, st = stream_mesh
    ro, rd = _mesh_rays(1 << 16, 11)
    live = torch.arange(1 << 16, device="cuda") % 3 > 0
    got = {}

    def keep(a, b, n_live):
        got.update(ro=a.contiguous(), rd=b.contiguous(), n_live=n_live)
        return a

    sorted_call(st.bounds, ro, rd, keep, live=live)
    sro, srd, n_live = got["ro"], got["rd"], got["n_live"]
    *k, kc = cst.nearest_hit_stream_counts(st, sro, srd, n_live)
    k0 = cst.nearest_hit_stream(st, sro, srd, n_live)
    assert all(torch.equal(a, b) for a, b in zip(k, k0))
    pc = cst.new_counts()
    n = int(n_live)
    t = cst._count_stream_walk(st, sro[:n], srd[:n], pc)
    assert {k: kc[k] for k in cst.PLAIN_COUNTS} == {
        k: pc[k] for k in cst.PLAIN_COUNTS}
    assert kc["rays"] == n and torch.equal(t, k[0][:n])
    assert bool((k[2][n:] == 0).all())
    assert 0 < kc["tri_lanes"] <= kc["tri_slots"]


# ---------------------------------------------------------------------------
# the resident super walk (64 clusters on) and the counting builds of #4, #7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_resident_kernels_walk_supers_as_plain(stream_mesh,
                                               dielectrics_block):
    """#1 and #2 on the 72-cluster sphere (the super walk): flags equal,
    t within rtol 1e-5 on >= 99.95% of rays, verdicts equal; the counting
    walk model's t is the kernel's bit for bit."""
    pk, _ = stream_mesh
    assert pk.n_super > 0
    ro, rd = _mesh_rays(1 << 16, 12)
    a = cuda_intersect.nearest_hit(pk, ro, rd, with_uv=True)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd, with_uv=True)
    assert torch.equal(a["flag"], b["flag"])
    assert torch.isclose(a["t"], b["t"], rtol=1e-5).float().mean().item() \
        >= 0.9995
    t = cuda_intersect._count_nearest_walk(pk, ro, rd,
                                           {k: 0 for k in ("hit_spheres",
                                                           "hit_boxes",
                                                           "hit_tris")})
    assert torch.equal(t, a["t"])
    p1, d = _mesh_rays(1 << 16, 13)
    rd2, _, md = intersect.shadow_ray(p1, p1 + d * 0.8)
    assert torch.equal(
        cuda_intersect.any_blocker(pk, p1, rd2, md, dielectrics_block),
        cuda_intersect.any_blocker_plain(pk, p1, rd2, md, dielectrics_block))


def test_shade_step_tex_counting_build_matches_plain_counts(card):
    """#4's counting build on the textured 17,000-triangle icosphere (512
    clusters: the super walk): its outputs #4's bit for bit and the plain
    version's within rtol 1e-4 / atol 1e-5 on >= 99.9% of lanes, its
    counters (``STEP_COUNTS``) the plain version's exactly."""
    from path_tracing_tpu_torch.ops import cuda_wavefront as cw

    scene = synth.icosphere_scene(17000, textured=True).to_device("cuda")
    pk, lt = cuda_intersect.pack_scene(scene), _light_table(scene)
    assert pk.n_super == 32
    B = 1 << 14
    ro, rd = _rays(B, 14)
    rd = intersect.shadow_ray(ro * 4.0, -ro + 0.3 * rd)[0]
    ro = (ro * 4.0).contiguous()
    u = rng.uniform_rows(rng.prng_key(15), B, 8, device="cuda")
    kw = dict(clamp_val=RenderConfig().clamp, stub_mis=False,
              dielectrics_block=True)
    out, kc = cuda_shade.shade_step_tex_counts(pk, lt, *_state(ro, rd), u,
                                               **kw)
    a = cuda_shade.shade_step_tex(pk, lt, *_state(ro, rd), u, **kw)
    assert all(torch.equal(out[k], a[k]) for k in a)
    pc = cw.new_counts()
    b = cuda_shade.shade_step_tex_plain(pk, lt, *_state(ro, rd), u, **kw,
                                        counts=pc)
    for k in a:
        ok = torch.isclose(a[k].double(), b[k].double(), rtol=1e-4,
                           atol=1e-5)
        if ok.dim() > 1:
            ok = ok.all(dim=1)
        assert ok.float().mean().item() >= 0.999, k
    assert {k: kc[k] for k in cuda_shade.STEP_COUNTS} == {
        k: pc[k] for k in cuda_shade.STEP_COUNTS}
    assert kc["iterations"] == B and kc["shadow_rays"] > 0
    for k in ("walk", "shade", "shadow"):
        assert 0 < kc[f"{k}_lanes"] <= kc[f"{k}_slots"], k


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_any_blocker_stream_counting_build_matches_the_model(
        stream_mesh, dielectrics_block):
    """#7's counting build on 65,536 sorted segments, a third of them
    dead: its verdicts #7's, its counters the plain model's
    (``_count_stream_shadow_walk``) exactly, the model's verdicts the
    kernel's."""
    from path_tracing_tpu_torch.ops import cuda_stream as cst
    from path_tracing_tpu_torch.ops.intersect import sorted_call

    _, st = stream_mesh
    p1, d = _mesh_rays(1 << 16, 16)
    rd, _, md = intersect.shadow_ray(p1, p1 + d * 0.8)
    live = torch.arange(1 << 16, device="cuda") % 3 > 0
    got = {}

    def keep(a, b, m, n_live):
        got.update(args=(a.contiguous(), b.contiguous(), m.contiguous()),
                   n_live=n_live)
        return a

    sorted_call(st.bounds, p1, rd, keep, md, live=live)
    (sp1, srd, smd), n_live = got["args"], got["n_live"]
    v, kc = cst.any_blocker_stream_counts(st, sp1, srd, smd,
                                          dielectrics_block, n_live)
    assert torch.equal(v, cst.any_blocker_stream(st, sp1, srd, smd,
                                                 dielectrics_block, n_live))
    n = int(n_live)
    pc = cst.new_counts()
    m = cst._count_stream_shadow_walk(st, sp1[:n], srd[:n], smd[:n],
                                      dielectrics_block, pc)
    assert torch.equal(m, v[:n]) and not bool(v[n:].any())
    assert 0.05 < m.float().mean().item() < 0.95
    assert {k: kc[k] for k in cst.PLAIN_COUNTS} == {
        k: pc[k] for k in cst.PLAIN_COUNTS}


# ---- the big-mesh routes and the CLI's front-ends on the card ----

def test_ppm_on_the_super_walk_matches_plain(card):
    """A PPM pass on the 17,000-triangle icosphere (512 clusters: #1 and
    #10 on the super walk) in the kernels' tier against the plain tier."""
    from path_tracing_tpu_torch.integrators import ppm

    p = synth.icosphere_scene(17000)
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48,
                      device="cuda")
    cfg = RenderConfig(width=64, height=48, spl=8192)
    key = rng.prng_key(4)
    a, ca, _ = ppm.render_ppm_with_stats(scene, cam, 64, 48, 8192, cfg, key)
    b, cb, _ = ppm.render_ppm_with_stats(scene, cam, 64, 48, 8192, cfg, key,
                                         tier="plain")
    assert a.mean().item() > 0
    assert abs(a.mean().item() - b.mean().item()) / b.mean().item() < 1e-3
    close = torch.isclose(a, b, rtol=1e-3, atol=1e-5).all(dim=1)
    assert close.float().mean().item() >= 0.99
    assert (ca == cb).float().mean().item() >= 0.99


def test_cli_oracle_and_checkpoint_on_the_card(card, tmp_path):
    """``--device oracle`` renders bit-equal twice (the fused tier); a
    checkpoint resume equals an uninterrupted render bit for bit."""
    from path_tracing_tpu_torch import cli

    def run(*extra, out="o.png"):
        return cli.run(["--input", str(CORNELL), "--spp", "2", "--width",
                        "48", "--height", "32", "--output",
                        str(tmp_path / out), *extra])

    a = run("--device", "oracle", "--spl", "4")
    b = run("--device", "oracle", "--spl", "4")
    assert a["tier"] == "fused" and (a["image"] == b["image"]).all()
    ck = str(tmp_path / "ck.npz")
    full = run("--iters", "3")
    run("--iters", "2", "--checkpoint", ck)
    resumed = run("--iters", "1", "--checkpoint", ck)
    assert (resumed["image"] == full["image"]).all()


# ---------------------------------------------------------------------------
# the RGB shadow, #8's RGB and sampled instances, #10's textured instance
# ---------------------------------------------------------------------------

GLASS = "M 1 1 1 0.0 0.0 1.5     // glass\n"


@pytest.fixture(scope="module")
def legacy(card):
    """cornell with a K record on its glass sphere's material."""
    from path_tracing_tpu_torch.scene.parser import parse_scene_text

    txt = CORNELL.read_text().replace(GLASS, GLASS + "K 0.9 0.6 0.3 1.5\n")
    scene = parse_scene_text(txt).to_device("cuda")
    assert scene.has_legacy_ks
    return scene, cuda_intersect.pack_scene(scene)


def test_transmittance_rgb_kernel_matches_plain(legacy):
    """On 65,536 segments through the room, every lane and then a third of
    them live (the others 1): rtol 1e-6 / atol 1e-7."""
    _, pk = legacy
    p1, _ = _rays(1 << 16, 3, -0.95, 0.95)
    p2, _ = _rays(1 << 16, 4, -0.95, 0.95)
    rd, _, md = intersect.shadow_ray(p1, p2)
    live = rng.uniform_rows(rng.prng_key(5), 1 << 16, 1,
                            device="cuda")[0] < 1.0 / 3.0
    for mask in (None, live):
        a = cuda_intersect.transmittance_rgb(pk, p1, rd, md, mask)
        b = cuda_intersect.transmittance_rgb_plain(pk, p1, rd, md, mask)
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    assert bool((a[~live] == 1.0).all())
    tinted = ((b > 0) & (b < 1)).any(dim=1)[live].float().mean().item()
    assert tinted > 0.001


@pytest.mark.parametrize("which", ["rgb", "sampled", "sampled_rgb"])
def test_connect_instances_match_plain(card, legacy, which):
    """#8's RGB and sampled instances on the primary hits of a 64x64
    frame against a light trace's compacted table: max-channel relative
    error < 1e-3 on every active lane, every inactive lane 0."""
    from path_tracing_tpu_torch.integrators import bdpt
    from path_tracing_tpu_torch.ops.math3 import normalize

    scene, pk = legacy if which != "sampled" else card
    cfg = RenderConfig(width=64, height=64, eye_depth=3, light_depth=3)
    lv = bdpt.trace_light_paths(scene, cfg, scene.num_lights * 16, 4,
                                rng.prng_key(6))
    flat, nv = bdpt.compact_flat(lv.flat())
    tab = cuda_connect.pack_light_vertices(flat)
    n = 64 * 64
    cam = make_camera(*(getattr(load_scene(str(CORNELL)), k)
                        for k in ("eye", "look_at", "view_up", "fov")),
                      64, 64, device="cuda")
    u = rng.uniform_rows(rng.prng_key(7), n, 8, device="cuda")
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    rd = primary_ray_dirs(cam, idx % 64, idx // 64, u[6], u[7])
    ro = cam.eye[None].expand(n, 3).contiguous()
    hit = intersect.hit_from_fields(cuda_intersect.nearest_hit(pk, ro, rd),
                                    ro, rd)
    act = hit.hit & ~hit.is_light
    eye_f = torch.where(hit.mtl.eta > 0.0, torch.zeros_like(u[0]),
                        1e8 * (1.0 + u[0] * 4.0))
    args = (pk, tab, nv, hit.pos, hit.normal,
            (u[1:4].T * 0.5 + 0.5).contiguous(), hit.mtl, -rd,
            normalize(cam.eye[None] - hit.pos), eye_f, act)
    kw = dict(clamp_val=15.0, dielectrics_block=True)
    if which != "rgb":
        kw["vidx"] = cuda_connect.sample_rows(
            rng.uniform_rows, rng.prng_key(8), n, 6, nv, device="cuda")
    _kernels.reset_counts()
    a = cuda_connect.connect(*args, **kw)
    name = "connect_rgb" if which == "rgb" else "connect_sampled"
    assert _kernels.launches[name] == 1 and _kernels.launches["connect"] == 0
    b = cuda_connect.connect_plain(*args, **kw)
    rel = ((a - b).abs() / (b.abs() + 1e-3)).max(dim=1).values[act]
    assert bool((rel < 1e-3).all()) and bool((a[~act] == 0).all())
    assert a[act].abs().sum().item() > 0


def test_photon_trace_tex_matches_plain(card):
    """#10's textured instance on 16,384 photons of cornell's lights with
    the 1,280-triangle textured icosphere in its room (photons bounce off
    the sphere onto the walls): valid flags equal, fields within rtol 1e-5
    / atol 1e-6 on >= 99.99% of the valid rows."""
    from path_tracing_tpu_torch.integrators import ppm
    from path_tracing_tpu_torch.ops import cuda_photon

    room = load_scene(str(CORNELL))
    mesh = synth.icosphere_scene(1280, textured=True)
    n_room = len(room.tri_verts)
    room.tri_verts += [[[c * 0.35 + o for c, o in zip(v, (0, -0.65, -0.55))]
                        for v in tri] for tri in mesh.tri_verts]
    room.tri_mtl += mesh.tri_mtl
    room.tri_group += [0] * len(mesh.tri_verts)
    room.tri_uv = [[0.0] * 6] * n_room + list(mesh.tri_uv)
    room.tri_tex = [-1] * n_room + list(mesh.tri_tex)
    room.textures = list(mesh.textures)
    scene = room.to_device("cuda")
    pk = cuda_intersect.pack_scene(scene)
    key = rng.prng_key(9)
    emit = ppm.photon_emission(scene, 1 << 14, 1 << 12, key)
    _kernels.reset_counts()
    ev, valid = cuda_photon.photon_trace(pk, *emit, key, 4, 12)
    assert _kernels.launches["photon_trace_tex"] == 1
    ev_p, valid_p = cuda_photon.photon_trace_plain(pk, *emit, key, 4, 12)
    assert torch.equal(valid, valid_p) and int(valid[1 << 14:].sum()) > 0
    close = torch.isclose(ev[valid], ev_p[valid], rtol=1e-5, atol=1e-6)
    assert close.all(dim=1).float().mean().item() >= 0.9999


# ---- the integrators' spans on the card's clock ----------------------------

HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _traced(fn, tmp_path):
    """Run ``fn`` once untraced (warm-up), then under ``torch.profiler`` with
    the card's activity: the Chrome trace's complete events."""
    import json

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _interval(e):
    return e["ts"], e["ts"] + e["dur"], e.get("tid")


def _within(e, outer):
    a, b, tid = _interval(e)
    oa, ob, otid = _interval(outer)
    return tid == otid and oa <= a and b <= ob


def _host_waits(events):
    """The runtime calls in which the host waits on the card: synchronises
    and copies to the host (by their copy's correlation)."""
    to_host = {e["args"].get("correlation") for e in events
               if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    return [e for e in events if e.get("cat") == "cuda_runtime" and (
        e["name"] in HOST_WAITS or (e["name"].startswith("cudaMemcpy")
                                    and e["args"].get("correlation")
                                    in to_host))]


@pytest.mark.parametrize("mode", ["ppm", "bdpt", "pt"])
def test_every_host_wait_in_a_frame_lies_under_a_sync_span(card, mode,
                                                           tmp_path):
    """A traced cornell PPM pass (128x72, 65,536 photons), BDPT frame
    (128x72 spp 2, K 32) and PT frame of the per-bounce fused tier (128x72
    spp 2): each ``cudaStreamSynchronize`` (or device-wide synchronise) and
    copy to the host inside the frame's span lies within a ``sync.*``
    span, and the frame has some."""
    from path_tracing_tpu_torch.integrators import bdpt, ppm

    scene, _ = card
    p = load_scene(str(CORNELL))
    w, h = 128, 72
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    key = rng.prng_key(3)
    if mode == "ppm":
        cfg = RenderConfig(width=w, height=h, spl=16384)
        frame_name = "ppm.pass"

        def fn():
            ppm.render_ppm_with_stats(scene, cam, w, h, 16384, cfg, key)
    elif mode == "bdpt":
        cfg = RenderConfig(width=w, height=h, spp=2, spl=4,
                           bdpt_resample_vertices=32)
        frame_name = "bdpt.frame"

        def fn():
            bdpt.render_bdpt(scene, cam, w, h, 2, 4, cfg, key)
    else:
        cfg = RenderConfig(width=w, height=h, spp=2)
        frame_name = "pt.frame"

        def fn():
            render_pt(scene, cam, w, h, 2, cfg, key, tier="fused")
    events = _traced(fn, tmp_path)
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    frames = [e for e in ann if e["name"] == frame_name]
    syncs = [e for e in ann if e["name"].startswith("sync.")]
    assert len(frames) == 1 and syncs
    waits = [e for e in _host_waits(events) if _within(e, frames[0])]
    assert waits
    # each wait outside a sync span, with the innermost span around it
    loose = [(e["name"], max(((a["ts"], a["name"]) for a in ann
                              if _within(e, a)), default=(0, None))[1])
             for e in waits if not any(_within(e, s) for s in syncs)]
    assert not loose, loose


def test_megakernel_span_encloses_its_launch_on_one_clock(card, tmp_path):
    """A traced 1080p cornell PT frame (mega): a ``pt.megakernel`` span
    encloses the launch of ``render_wavefront_kernel``, and the kernel
    starts on the card after the span started (host and device events on
    the trace's one clock)."""
    scene, _ = card
    p = load_scene(str(CORNELL))
    w, h = 1920, 1080
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h,
                      device="cuda")
    cfg = RenderConfig(width=w, height=h, spp=4)
    events = _traced(lambda: render_pt(scene, cam, w, h, 4, cfg,
                                       rng.prng_key(5)), tmp_path)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "pt.megakernel"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "render_wavefront_kernel" in e["name"]]
    assert len(spans) == 1 and len(kernels) == 1
    corr = kernels[0]["args"]["correlation"]
    launch = [e for e in events if e.get("cat") == "cuda_runtime"
              and e["args"].get("correlation") == corr]
    assert len(launch) == 1 and _within(launch[0], spans[0])
    assert kernels[0]["ts"] > spans[0]["ts"]
