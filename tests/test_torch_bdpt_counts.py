"""The plain versions' work counters of the BDPT connection sweep (#8
``connect_plain``, #9 ``bdpt_eye_plain``), which the card's counting builds
are held to: what they must satisfy on cornell, exact values on a
hand-built scene with one light row and one blocker, and images that do
not change when counted."""
import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt
from path_tracing_tpu_torch.ops import cuda_bdpt_eye, cuda_connect, rng
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene.camera import make_camera
from path_tracing_tpu_torch.scene.parser import load_scene, parse_scene_text
from path_tracing_tpu_torch.scene.types import Material

from test_torch_scene import CORNELL


def _frame(K, w=16, h=12, spp=2):
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h, device="cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, spl=2, eye_depth=3,
                       light_depth=3, bdpt_resample_vertices=K)
    key = rng.fold_in(rng.prng_key(4), 0)
    used, lv, scale = bdpt.light_side(p.to_device("cpu"), cfg, 2, key)
    idx = torch.arange(w * h, dtype=torch.int32)
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % w, idx // w, key)
    return (pack_scene(used), tab, nv, cam, idx % w, idx // w, spp, cfg, key,
            scale)


@pytest.mark.parametrize("K", [0, 8])
def test_bdpt_eye_plain_counts_hold_together(K):
    """rows = vertices x n_valid; gated rows >= shadow rays >=
    contributions; an evaluation on every gated row and two pdfs on every
    shadow ray; every cast tests every sphere and every non-empty box; every
    sample counted; the image unchanged by counting."""
    args = _frame(K)
    counts = cuda_connect.new_counts()
    img = cuda_bdpt_eye.bdpt_eye_plain(*args, counts=counts)
    assert torch.equal(img, cuda_bdpt_eye.bdpt_eye_plain(*args))
    n_valid, B, spp = args[2], args[4].shape[0], args[6]
    c = counts
    assert c["samples"] == B * spp
    assert c["vertices"] >= c["samples"] // 2
    assert c["rows"] == c["vertices"] * n_valid
    assert c["rows"] > c["rows_gated"] >= c["shadow_rays"]
    assert c["shadow_rays"] >= c["contributions"] > 0
    assert 2 * c["rows_gated"] >= c["evals"] > c["rows_gated"]
    assert c["pdfs"] >= 2 * c["shadow_rays"]
    pk = args[0]
    casts, rem = divmod(c["hit_spheres"], pk.ns + pk.nl)
    assert rem == 0 and casts >= c["vertices"]
    assert c["hit_boxes"] == casts * int((pk.cl[:, 7] > 0).sum())
    assert 0 < c["hit_tris"] <= casts * pk.nt
    assert c["shadow_spheres"] <= c["shadow_rays"] * pk.ns
    assert 0 < c["shadow_tris"] <= c["shadow_rays"] * pk.nt
    assert all(c[k] == 0 for k in c if k not in cuda_connect.PLAIN_COUNTS)


# a floor at y = -1 under a diffuse sphere of radius 0.3 at the origin; the
# light ball of the one spot light never blocks
BLOCKER = """
E 0 0 5
V 0 0 0  0 1 0
F 50
R 4 4
M 0.7 0.7 0.7 1.0 0.0 0.0
T -2 -1 -2  2 -1 -2  2 -1 2
T -2 -1 -2  2 -1 2  -2 -1 2
S 0 0 0  0.3
L 0 1.5 0  0 -1 0  5 5 5  80 0 0.05
"""


def _one_row_table(pos, normal):
    """The packed table of one emitter vertex at ``pos`` emitting along
    ``normal`` (no cone), throughput 1."""
    def v(*x):
        return torch.tensor([x], dtype=torch.float32)

    z = torch.zeros(1)
    lv = bdpt.LightVertices(
        pos=v(*pos), normal=v(*normal), throughput=v(1.0, 1.0, 1.0),
        mtl=Material(v(0.0, 0.0, 0.0), z.clone(), z.clone(), z.clone()),
        pdf_fwd=z.clone(), pdf_rev=z.clone(),
        is_light_source=torch.ones(1, dtype=torch.bool),
        source_cutoff=z.clone(), is_parallel=torch.zeros(1, dtype=torch.bool),
        emit_dir=v(*normal), wo=v(*normal), mis_a=z.clone(),
        valid=torch.ones(1, dtype=torch.bool))
    return cuda_connect.pack_light_vertices(lv)


def test_nearest_plain_counts_the_cluster_walk():
    """The kernels' nearest-hit walk tests every sphere and light ball and
    every non-empty box, and a box's triangles only where the ray enters
    it before its nearest hit so far: down onto the floor (2 triangles),
    up away from it (box missed) and down through the sphere, which hits
    before the floor's box; a lane that is not live is not counted and
    gets the miss record."""
    from path_tracing_tpu_torch.ops.cuda_intersect import nearest_hit_plain

    pk = pack_scene(parse_scene_text(BLOCKER).to_device("cpu"))
    ro = torch.tensor([[1.5, 1.0, 0.0], [1.5, 1.0, 0.0], [0.0, 1.0, 0.0],
                       [1.5, 1.0, 0.0]])
    rd = torch.tensor([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                       [0.0, -1.0, 0.0]])
    live = torch.tensor([True, True, True, False])
    counts = cuda_connect.new_counts()
    hit = nearest_hit_plain(pk, ro, rd, live=live, counts=counts)
    assert hit["flag"].tolist() == [1, 0, 1, 0]
    assert {k: counts[k] for k in ("hit_spheres", "hit_boxes",
                                   "hit_tris")} == dict(
        hit_spheres=3 * (pk.ns + pk.nl), hit_boxes=3, hit_tris=2)
    assert torch.equal(hit["t"][live],
                       nearest_hit_plain(pk, ro, rd)["t"][live])
    assert hit["t"][3] == torch.tensor(1e20)


def test_connect_plain_counts_one_row_one_blocker():
    """Five lanes against one light row at (0, 1, 0): under the sphere
    (gated in, its shadow ray blocked), two beside it (clear), one whose
    normal faces away (gated out) and one inactive lane.  (Not straight
    under the light: at normal incidence the reference's eta = 0 Fresnel
    edge makes the evaluation NaN, and the zero-eval gate closes.)  The
    emitter row needs no light-side evaluation; the sphere ends the first
    walk, the two clear walks test it and the floor's flat box, which a
    segment leaving the floor never enters."""
    scene = parse_scene_text(BLOCKER).to_device("cpu")
    pk = pack_scene(scene)
    tab = _one_row_table((0.0, 1.0, 0.0), (0.0, -1.0, 0.0))
    pos = torch.tensor([[0.1, -1.0, 0.0], [1.5, -1.0, 0.0], [-1.5, -1.0, 0.0],
                        [1.5, -1.0, 0.5], [0.5, -1.0, 0.5]])
    up = torch.tensor([0.0, 1.0, 0.0])
    nrm = torch.stack([up, up, up, -up, up])
    B = pos.shape[0]
    m = Material(torch.full((B, 3), 0.7), torch.ones(B), torch.zeros(B),
                 torch.zeros(B))
    wo = up.expand(B, 3).contiguous()
    act = torch.tensor([True, True, True, True, False])
    counts = cuda_connect.new_counts()
    out = cuda_connect.connect_plain(
        pk, tab, 1, pos, nrm, torch.ones(B, 3), m, wo, wo, torch.zeros(B),
        act, clamp_val=15.0, dielectrics_block=True, counts=counts)
    assert {k: counts[k] for k in cuda_connect.PLAIN_COUNTS} == dict(
        samples=0, vertices=4, rows=4, rows_gated=3, evals=3, pdfs=6,
        shadow_rays=3, contributions=2, hit_spheres=0, hit_boxes=0,
        hit_tris=0, shadow_spheres=3, shadow_boxes=2, shadow_tris=0)
    assert (out[0] == 0).all() and (out[3:] == 0).all()
    assert (out[1] > 0).all() and torch.equal(out[1], out[2])
    plain = cuda_connect.connect_plain(
        pk, tab, 1, pos, nrm, torch.ones(B, 3), m, wo, wo, torch.zeros(B),
        act, clamp_val=15.0, dielectrics_block=True)
    assert torch.equal(out, plain)
