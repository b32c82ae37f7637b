"""The plain PT loop's work counters of the megakernel (#5
``render_wavefront_plain``), which the card's counting build is held to,
against what the per-bounce loop itself does on cornell at 16x12 spp 2."""
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.ops import cuda_intersect, cuda_shade, rng
from path_tracing_tpu_torch.ops import cuda_wavefront as cw
from path_tracing_tpu_torch.scene.camera import make_camera
from path_tracing_tpu_torch.scene.parser import load_scene

from test_torch_scene import CORNELL

WALKS = ("hit_spheres", "hit_boxes", "hit_tris", "shadow_spheres",
         "shadow_boxes", "shadow_tris")


def test_render_wavefront_plain_counts_the_loop(monkeypatch):
    """Iterations equal the lanes each bounce shades, NEE shadow rays (and
    their evaluations and pdfs) the lanes each bounce hands its shadow
    walk, the walks' tests what the counting nearest-hit and any-blocker
    plain versions count for those lanes; every pixel starts spp paths,
    the draws add up, and counting leaves the image alone."""
    p = load_scene(str(CORNELL))
    scene = p.to_device("cpu")
    w, h, spp = 16, 12, 2
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h, device="cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, eye_depth=4)
    key = rng.fold_in(rng.prng_key(5), 0)
    idx = torch.arange(w * h, dtype=torch.int32)
    args = (cuda_intersect.pack_scene(scene), scene.packed.light, cam,
            idx % w, idx // w, spp, cfg, key)

    seen, walks = dict(act=0, elig=0), cw.new_counts()

    def nearest(packed, ro, rd, with_uv=False, live=None):
        seen["act"] += int(live.sum())
        return cuda_intersect.nearest_hit_plain(packed, ro, rd, with_uv,
                                                live=live, counts=walks)

    def blocker(packed, p1, rd, max_d, dielectrics_block, live=None):
        seen["elig"] += int(live.sum())
        return cuda_intersect.any_blocker_plain(
            packed, p1, rd, max_d, dielectrics_block, live=live,
            counts=walks)

    with monkeypatch.context() as m:
        m.setattr(cuda_shade, "nearest_hit_plain", nearest)
        m.setattr(cuda_shade, "any_blocker_plain", blocker)
        img = cw.render_wavefront_plain(*args)
    c = cw.new_counts()
    assert torch.equal(cw.render_wavefront_plain(*args, counts=c), img)
    assert c["iterations"] == seen["act"] > 0
    assert c["shadow_rays"] == c["evals"] == c["pdfs"] == seen["elig"] > 0
    assert {k: c[k] for k in WALKS} == {k: walks[k] for k in WALKS}
    assert c["hit_spheres"] == c["iterations"] * (args[0].ns + args[0].nl)
    assert c["samples"] == w * h * spp
    assert c["iterations"] > c["bsdf_samples"] > c["shadow_rays"]
    assert c["draws"] == (c["iterations"] + 2 * c["samples"]
                          + 3 * (c["shadow_rays"] + c["bsdf_samples"]))
    assert c["pixel_warp_slots"] >= c["iterations"]
    max_total = spp * cfg.max_eye_iters + cfg.max_eye_iters
    assert 0 < c["iteration_keys"] <= max_total
    assert c["iteration_keys"] * w * h >= c["iterations"]
    assert all(c[k] == 0 for k in c
               if k not in cw.PLAIN_COUNTS + cw.PLAIN_ONLY)


def test_shade_step_plain_counts_sum_to_the_megakernel_counts():
    """#3's plain counts (``STEP_COUNTS``, what its counting build is held
    to), summed over the bounces of a fused frame on cornell at 16x12 spp
    2, equal the megakernel's plain counts of the same frame on every
    counter both fill: it is the same bounce, so the same work."""
    import functools

    from path_tracing_tpu_torch.integrators.pt import wavefront_loop

    p = load_scene(str(CORNELL))
    scene = p.to_device("cpu")
    w, h, spp = 16, 12, 2
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, w, h, device="cpu")
    cfg = RenderConfig(width=w, height=h, spp=spp, eye_depth=4)
    key = rng.fold_in(rng.prng_key(5), 0)
    idx = torch.arange(w * h, dtype=torch.int32)
    pk, lt = cuda_intersect.pack_scene(scene), scene.packed.light
    steps = cw.new_counts()
    img = wavefront_loop(pk, lt, cam, cfg, idx % w, idx // w, spp, key, 0,
                         None, functools.partial(cuda_shade.shade_step_plain,
                                                 counts=steps))
    mega = cw.new_counts()
    assert torch.equal(cw.render_wavefront_plain(
        pk, lt, cam, idx % w, idx // w, spp, cfg, key, counts=mega), img)
    assert steps["iterations"] > steps["shadow_rays"] > 0
    assert {k: steps[k] for k in cuda_shade.STEP_COUNTS} == {
        k: mega[k] for k in cuda_shade.STEP_COUNTS}
    assert steps["samples"] == 0 < mega["samples"]   # the loop's own work
