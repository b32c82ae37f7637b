"""The scene's tables are packed once, when the scene is built, and every
frame takes them from the scene (``scene.packed``).

What the scene holds is, field by field, a fresh ``pack_scene`` of it:
on cornell, a legacy-Ks cornell, a textured icosphere of 80 clusters (the
super walk) and the 91-sphere flake (the sphere index); a scene with its
light flux scaled (``with_illum_scaled``, as BDPT scales it) holds the
pack of the scaled scene and shares every other table with the scene it
came from.  One frame of every tier of PT, BDPT and PPM packs nothing,
and the stream tier builds its tables on its first frame alone.  Tiny
renders on the CPU."""
from pathlib import Path

import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
from path_tracing_tpu_torch.ops import bvh, cuda_stream, rng
from path_tracing_tpu_torch.ops import cuda_intersect as CI
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.camera import make_camera
from path_tracing_tpu_torch.scene.parser import load_scene, parse_scene_text

CORNELL = Path(__file__).resolve().parent.parent / "scenes" / "cornell.txt"
W, H = 8, 6
GLASS = "M 1 1 1 0.0 0.0 1.5     // glass\n"
FIELDS = ("sph", "tri", "uv", "cl", "atlas", "tex_size", "ns", "nl", "nt",
          "sup", "n_super", "legacy", "scl", "nsc", "ssup", "n_ssuper",
          "light")
# the tables a scaled scene shares with the scene it came from
SHARED = ("tri", "uv", "cl", "atlas", "tex_size", "sup", "legacy", "scl",
          "ssup")


def _parsed(name):
    if name in ("cornell", "cornell-scaled"):
        return load_scene(str(CORNELL))
    if name == "legacy":
        txt = CORNELL.read_text()
        assert GLASS in txt
        return parse_scene_text(txt.replace(GLASS,
                                            GLASS + "K 0.9 0.6 0.3 1.5\n"))
    if name == "textured":
        return synth.icosphere_scene(5120, textured=True)
    return synth.sphereflake_scene(2)


def _sphere_clusters(p):
    """The sphere index's clusters of a parsed scene, as the scene build
    takes them (None below ``SPHERE_INDEX_MIN`` spheres)."""
    if len(p.sph_radius) < bvh.SPHERE_INDEX_MIN:
        return None
    _, box, rng_ = bvh.build_sphere_clusters(p.sph_center, p.sph_radius,
                                             bvh.SPHERE_LEAF)
    return torch.from_numpy(box), torch.from_numpy(rng_)


def _assert_same_tables(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            assert x == y, f


@pytest.mark.parametrize("name", ["cornell", "legacy", "textured", "flake",
                                  "cornell-scaled", "flake-scaled"])
def test_scene_holds_a_fresh_pack_of_itself(name):
    p = _parsed(name)
    scene = p.to_device("cpu")
    clusters = _sphere_clusters(p)
    pk = scene.packed
    assert (pk.nsc > 0) == name.startswith("flake")
    assert (pk.n_super > 0) == (name == "textured")
    assert pk.has_legacy == (name == "legacy")
    assert pk.textured == (name == "textured")
    if name.endswith("-scaled"):
        scaled = scene.with_illum_scaled(1.0 / 8.0)
        assert not torch.equal(scaled.light_illum, scene.light_illum)
        _assert_same_tables(scaled.packed, CI.pack_scene(scaled, clusters))
        for f in SHARED:
            assert getattr(scaled.packed, f) is getattr(pk, f), f
        assert scaled.packed.sph is not pk.sph
    _assert_same_tables(pk, CI.pack_scene(scene, clusters))


# (integrator, tier)
FRAMES = [("pt", "mega"), ("pt", "fused"), ("pt", "split"), ("pt", "stream"),
          ("pt", "plain"), ("bdpt", "mega"), ("bdpt", "fused"),
          ("bdpt", "plain"), ("ppm", "mega"), ("ppm", "hash"),
          ("ppm", "plain")]


def _frame(mode, tier, scene, cam, i):
    key = rng.fold_in(rng.prng_key(3), i)
    if mode == "pt":
        cfg = RenderConfig(width=W, height=H, spp=1, eye_depth=3)
        return pt.render_pt(scene, cam, W, H, 1, cfg, key, tier=tier)
    if mode == "bdpt":
        cfg = RenderConfig(width=W, height=H, spp=1, spl=2, light_depth=3,
                           eye_depth=3)
        return bdpt.render_bdpt(scene, cam, W, H, 1, 2, cfg, key, tier=tier)
    cfg = RenderConfig(width=W, height=H, spl=32, light_depth=3)
    return ppm.render_ppm_with_stats(scene, cam, W, H, 32, cfg, key,
                                     tier=tier)[0]


@pytest.mark.parametrize("mode,tier", FRAMES,
                         ids=["-".join(f) for f in FRAMES])
def test_a_frame_builds_no_table(mode, tier, monkeypatch):
    p = load_scene(str(CORNELL))
    scene = p.to_device("cpu")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cpu")
    calls = {"pack_scene": 0, "pack_scene_stream": 0}

    def counted(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, call)

    counted(CI, "pack_scene")
    counted(cuda_stream, "pack_scene_stream")
    packed = scene.packed
    for i in range(2):
        img = _frame(mode, tier, scene, cam, i)
        assert img.shape == (W * H, 3) and bool(torch.isfinite(img).all())
    assert calls == {"pack_scene": 0,
                     "pack_scene_stream": int(tier == "stream")}
    assert scene.packed is packed
    assert (scene.stream is not None) == (tier == "stream")
