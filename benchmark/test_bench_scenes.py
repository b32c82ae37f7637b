"""The scene files that ``scenes.scene_file`` writes: a plain scene and a
generated mesh give the files they always gave, at the paths they always
had, and a mesh placed in a scene parses, by the reference's parser and by
the program's, to the scene's records followed by exactly the placed
mesh's float32 triangles."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from benchmark import scenes
from benchmark.cells import HERE, read_json
from benchmark.conftest import TINY_ENCLOSED

# sha256 of the files that the writer gave before a configuration could
# place a mesh in a scene
CORNELL_SHA = (
    "90f0046f75d1219c1530cedb5a4f0316ff388fc9a631f56788aef8dc01f3b8f5")
TINY_TEXTURED = ("tiny_textured-ea77ec7fcb95", {
    "tiny_textured.mtl":
        "40712ee1df9edb32907e0e4ba987bd74e612542f633622aaf847eb2cb24a70c8",
    "tiny_textured.obj":
        "659be2b13495ea1c6ed63ca24af0ec9e6af1f88ed6d67e107e80c8c228c2954f",
    "tiny_textured_tex0.png":
        "57987a79084dd990de4b54a3eb3180118fe72e10420bf4afb78caa3b34eb5669"})


def _sha(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty scene cache, so that every scene file is written anew."""
    monkeypatch.setattr(scenes, "CACHE", tmp_path / "scenes")
    return tmp_path / "scenes"


def test_scene_and_mesh_files_as_before(tiny_root, cache):
    path = scenes.scene_file("cornell", read_json(
        tiny_root / "configs" / "cornell.json"), tiny_root)
    assert path == tiny_root / "configs" / "cornell.txt"
    assert _sha(path) == CORNELL_SHA
    cornell = HERE / "configs" / "cornell.json"
    assert scenes.scene_file("cornell", read_json(cornell)) == (
        cornell.with_suffix(".txt"))
    path = scenes.scene_file("tiny_textured", read_json(
        tiny_root / "configs" / "tiny_textured.json"), tiny_root)
    d, shas = TINY_TEXTURED
    assert path == cache / d / "tiny_textured.obj"
    assert {f.name: _sha(f) for f in path.parent.iterdir()} == shas


def test_textured_icosphere_path_as_before(cache):
    """A file at the path that the configuration's bytes gave before is
    found there and not written again."""
    cfg = read_json(HERE / "configs" / "textured_icosphere.json")
    want = (cache / "textured_icosphere-7a3830c68e7b"
            / "textured_icosphere.obj")
    want.parent.mkdir(parents=True)
    want.write_text("")
    assert scenes.scene_file("textured_icosphere", cfg) == want


def _records(p) -> dict:
    """A parsed scene's camera, spheres and lights, and its triangles'
    vertices (float32, (N, 3, 3)), materials and groups."""
    out = {k: np.asarray(getattr(p, k), np.float32) for k in (
        "eye", "look_at", "view_up", "sph_center", "sph_radius", "sph_mtl",
        "sph_group", "lights", "tri_mtl", "tri_group")}
    out["fov"] = p.fov
    out["tri_verts"] = np.asarray(p.tri_verts, np.float32).reshape(-1, 3, 3)
    return out


def _parsers():
    from path_tracing_tpu_torch.scene import parser as port_parser
    from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

    from benchmark.reference.scene.parser import load_scene

    # the reference's parser, the program's Python parser and the
    # program's loader (its native parser where the runtime builds)
    return (load_scene, port_parser.load_scene, load_any_scene)


@pytest.mark.parametrize("parser", range(3))
def test_scene_and_mesh_parse_to_the_scene_then_the_mesh(tiny_root, cache,
                                                       parser):
    load = _parsers()[parser]
    room_path = tiny_root / "configs" / "cornell.txt"
    path = scenes.scene_file("tiny_enclosed", read_json(
        tiny_root / "configs" / "tiny_enclosed.json"), tiny_root)
    assert path.parent.parent == cache and path.name == "tiny_enclosed.txt"
    assert path.read_bytes().startswith(room_path.read_bytes())
    v, f = scenes.icosphere(TINY_ENCLOSED["icosphere_tris"])
    mesh = (v[f] * np.float32(TINY_ENCLOSED["radius"])
            + np.asarray(TINY_ENCLOSED["center"], np.float32))
    room, got = _records(load(str(room_path))), _records(load(str(path)))
    n = len(room["tri_verts"])
    assert n == 36 and len(got["tri_verts"]) == n + 320
    for k, want in room.items():
        if k.startswith("tri_"):
            assert np.array_equal(got[k][:n], want), k
        else:
            assert np.array_equal(got[k], want), k
    assert np.array_equal(got["tri_verts"][n:], mesh)
    assert np.array_equal(got["tri_mtl"][n:], np.broadcast_to(
        np.float32(TINY_ENCLOSED["material"]), (320, 6)))
    assert np.array_equal(got["tri_group"][n:], np.zeros(320, np.float32))


def test_placed_digest_covers_the_scenes_bytes(tiny_root, cache):
    cfg = read_json(tiny_root / "configs" / "tiny_enclosed.json")
    a = scenes.scene_file("tiny_enclosed", cfg, tiny_root)
    room = tiny_root / "configs" / "cornell.txt"
    room.write_bytes(room.read_bytes() + b"\n// moved\n")
    b = scenes.scene_file("tiny_enclosed", cfg, tiny_root)
    assert a != b and b.read_bytes().startswith(room.read_bytes())
    assert scenes.scene_file("tiny_enclosed", cfg, tiny_root) == b


def test_textured_mesh_in_a_scene_raises(tiny_root, cache):
    (tiny_root / "configs" / "tex_room.json").write_text(json.dumps(
        {"scene": "cornell.txt", "mesh": dict(TINY_ENCLOSED, textured=True)}))
    cfg = read_json(tiny_root / "configs" / "tex_room.json")
    with pytest.raises(ValueError, match="no UVs"):
        scenes.scene_file("tex_room", cfg, tiny_root)
    assert not cache.exists()
