"""The port's binding of the native C++ host runtime
(``path_tracing_tpu_torch/runtime/native.py``, built from
``csrc/pt_runtime.cc`` into ``path_tracing_tpu_torch/build/``) against the
port's Python parsers and the JAX package's native runtime.

Bars: the parsed tables equal (the same float32 values: both parsers round
the same decimal text); the cluster layouts equal to the JAX package's
default ``build_clusters`` (the native builder of the same source); a
``map_Kd`` path longer than the JAX binding's 4,096-byte buffer recovered;
two processes starting together compile the library once."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from path_tracing_tpu.ops import bvh as jbvh
from path_tracing_tpu.runtime import native as jnative
from path_tracing_tpu_torch.ops import bvh
from path_tracing_tpu_torch.runtime import native
from path_tracing_tpu_torch.scene import obj_loader, parser, synth

from conftest import make_textured_quad_obj
from test_torch_scene import CORNELL

REPO = Path(__file__).resolve().parent.parent


def _equal(a, b):
    """Every field of two ParsedScenes equal, texture images included."""
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "textures":
            assert len(x) == len(y)
            for p, q in zip(x, y):
                np.testing.assert_array_equal(p, q)
        elif f.name.endswith("_legacy") and min(len(x), len(y)) == 0:
            # OBJ files have no legacy record: the Python loader keeps no
            # rows, the native one all-zero rows (the same Scene tables)
            assert not np.asarray(x).any() and not np.asarray(y).any()
        elif f.name in ("fov", "width", "height"):
            assert np.float32(x) == np.float32(y), f.name
        else:
            np.testing.assert_array_equal(np.asarray(x, np.float32),
                                          np.asarray(y, np.float32),
                                          err_msg=f.name)


@pytest.fixture(scope="module")
def ico_obj(tmp_path_factory):
    d = tmp_path_factory.mktemp("ico")
    return synth.write_obj(synth.icosphere_scene(1280, textured=True),
                           str(d / "ico.obj"))


def test_native_is_built_at_first_use():
    assert native.native_available()
    so = Path(native.build_info["path"])
    assert so.parent == native.BUILD_DIR and so.exists()
    assert not (REPO / "csrc" / "libpt_runtime.so").samefile(so)


@pytest.mark.parametrize("which", ["cornell", "quad", "icosphere"])
def test_native_parse_matches_python(which, tmp_path, ico_obj):
    path = {"cornell": str(CORNELL),
            "quad": make_textured_quad_obj(tmp_path),
            "icosphere": ico_obj}[which]
    a = native.parse_scene_native(path)
    b = (parser.load_scene(path) if which == "cornell"
         else obj_loader.load_obj(path))
    _equal(a, b)
    if which == "icosphere":
        assert len(a.tri_verts) == 1280 and len(a.textures) == 1
    # and the JAX package's binding of its own library reads the same
    _equal(a, jnative.parse_scene_native(path))


@pytest.mark.parametrize("which", ["cornell", "icosphere"])
def test_build_clusters_matches_jax(which, ico_obj):
    src = str(CORNELL) if which == "cornell" else ico_obj
    p = parser.load_scene(src) if which == "cornell" else \
        obj_loader.load_obj(src)
    tris = np.asarray(p.tri_verts, np.float32).reshape(-1, 9)
    leaf = 8 if which == "cornell" else 64
    for a, b in zip(jbvh.build_clusters(tris, leaf),
                    bvh.build_clusters(tris, leaf)):
        np.testing.assert_array_equal(a, b)
    order, aabbs, ranges = bvh.build_clusters(tris, leaf)
    assert sorted(order.tolist()) == list(range(len(tris)))
    assert int(ranges[:, 1].sum()) == len(tris)


def test_load_any_scene_prefers_native(tmp_path, monkeypatch):
    """The native parser first; ``PT_TPU_NO_NATIVE=1`` forces the Python
    parsers, which give the same scene."""
    calls = []
    real = native.parse_scene_native
    monkeypatch.setattr(native, "parse_scene_native",
                        lambda p: calls.append(p) or real(p))
    path = make_textured_quad_obj(tmp_path)
    monkeypatch.delenv("PT_TPU_NO_NATIVE", raising=False)
    a = obj_loader.load_any_scene(path)
    ta = obj_loader.load_any_scene(str(CORNELL))
    assert calls == [path, str(CORNELL)]
    monkeypatch.setenv("PT_TPU_NO_NATIVE", "1")
    b = obj_loader.load_any_scene(path)
    tb = obj_loader.load_any_scene(str(CORNELL))
    assert len(calls) == 2
    _equal(a, b)
    _equal(ta, tb)


def test_long_texture_path_is_read_again(tmp_path):
    """``pt_get_texture_path`` returns the capacity it needs when the
    buffer is short; a map_Kd path of more than 4,096 bytes is read again
    at that size (the JAX binding's fixed buffer drops it)."""
    path = make_textured_quad_obj(tmp_path)
    mtl = Path(path).with_suffix(".mtl")
    long_name = "./" * 2100 + "check.png"
    mtl.write_text(mtl.read_text().replace("check.png", long_name))
    a = native.parse_scene_native(path)
    b = obj_loader.load_obj(path)
    assert len(a.textures) == 1 and list(a.tri_tex) == [0, 0]
    _equal(a, b)
    dropped = jnative.parse_scene_native(path)
    assert len(dropped.textures) == 0


def test_two_processes_build_once(tmp_path):
    """Two processes building into one empty directory at once: one
    compiles, the other waits on the lock and loads that library."""
    code = ("import sys; from pathlib import Path; "
            "from path_tracing_tpu_torch.runtime import native; "
            "so, built = native.build_library(Path(sys.argv[1])); "
            "print(int(built), so.name)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(REPO))
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = sorted(int(o.split()[0]) for o, _ in outs)
    names = {o.split()[1] for o, _ in outs}
    assert built == [0, 1] and len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [names.pop(), "pt_runtime.lock"])
