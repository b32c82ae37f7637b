"""Host layer of the PyTorch port against the JAX package: config, parser,
cluster builder, Scene tables, pack_scene, camera, and that the port never
imports jax."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu import config as jconfig
from path_tracing_tpu.ops import bvh as jbvh
from path_tracing_tpu.ops.pallas_intersect import pack_scene as jpack
from path_tracing_tpu.scene import camera as jcamera
from path_tracing_tpu.scene import parser as jparser
from path_tracing_tpu_torch import config
from path_tracing_tpu_torch.ops.bvh import build_clusters_py
from path_tracing_tpu_torch.ops.cuda_intersect import pack_scene
from path_tracing_tpu_torch.scene import camera, parser
from path_tracing_tpu_torch.scene.types import scene_from_jax_arrays

REPO = Path(__file__).resolve().parent.parent
CORNELL = REPO / "scenes" / "cornell.txt"

# tests/test_bdpt.py DIFFUSE_BOX, repeated here so this file stands alone
DIFFUSE_BOX = """
E 0 2 8
V 0 0 0  0 1 0
F 50
R 8 8
M 0.7 0.7 0.7 1.0 0.0 0.0
T -5 -3 -5  5 -3 -5  5 -3 5
T -5 -3 -5  5 -3 5  -5 -3 5
T -5 5 -5  5 5 5  5 5 -5
T -5 5 -5  -5 5 5  5 5 5
T -5 -3 -5  5 -3 -5  5 5 -5
T -5 -3 -5  5 5 -5  -5 5 -5
M 0.6 0.3 0.3 0.8 0.0 0.0
T -5 -3 -5  -5 5 -5  -5 5 5
T -5 -3 -5  -5 5 5  -5 -3 5
T 5 -3 -5  5 5 5  5 5 -5
T 5 -3 -5  5 -3 5  5 5 5
L -2 3 0  0.3 -1 0.2  9 7 5  80 0 0.4
L  2 3 1  -0.2 -1 0   4 6 8  80 0 0.3
"""

SCENES = {"cornell": CORNELL.read_text(), "diffuse_box": DIFFUSE_BOX}


def jax_arrays(scene, cam=None) -> dict:
    """A JAX Scene (and Camera) as the numpy dict scene_from_jax_arrays
    takes: Material sub-fields as 'sph_mtl.base_color', camera fields as
    'camera.eye'."""
    d = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                d[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            d[f.name] = np.asarray(v)
    if cam is not None:
        for f in dataclasses.fields(cam):
            d[f"camera.{f.name}"] = np.asarray(getattr(cam, f.name))
    return d


def jax_cornell(width, height):
    """The stand-in scene and camera from the JAX package, and the same
    tables carried over to the port on the CPU."""
    p = jparser.load_scene(str(CORNELL))
    js = p.to_device()
    jc = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, width,
                             height)
    ts, tc = scene_from_jax_arrays(jax_arrays(js, jc), "cpu")
    return js, jc, ts, tc


def test_render_config_matches():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(config.RenderConfig)}
    assert jf == tf
    a = jconfig.RenderConfig(eye_depth=3, delta_budget=5)
    b = config.RenderConfig(eye_depth=3, delta_budget=5)
    assert (a.max_eye_iters, a.max_light_iters) == (b.max_eye_iters,
                                                    b.max_light_iters)
    assert b.with_(spp=2).spp == 2


@pytest.mark.parametrize("name", sorted(SCENES))
def test_parsed_tables_match(name):
    a = jparser.parse_scene_text(SCENES[name])
    b = parser.parse_scene_text(SCENES[name])
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, (list, np.ndarray)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)
        else:
            assert x == y, f.name
    if name == "cornell":
        assert (len(b.tri_verts), len(b.sph_center), len(b.lights)) == \
            (36, 5, 4)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_and_packed_tables_match(name):
    # both packages build clusters with the native builder of
    # csrc/pt_runtime.cc by default (see test_cluster_builders_on_cornell)
    js = jparser.parse_scene_text(SCENES[name]).to_device()
    ts = parser.parse_scene_text(SCENES[name]).to_device("cpu")
    d = jax_arrays(js)
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if f.name in ("packed", "stream"):
            # the port's tables, held to the JAX package's below
            continue
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                np.testing.assert_array_equal(
                    d[f"{f.name}.{g.name}"], getattr(v, g.name).numpy(),
                    err_msg=f"{f.name}.{g.name}")
        else:
            np.testing.assert_array_equal(d[f.name], v.numpy(),
                                          err_msg=f.name)
    assert not ts.has_textures and not ts.has_legacy_ks
    # pack_scene: exactly the JAX package's tables, column for column
    j_sph, j_tri, j_cl, ns, nl, nt = jpack(js)
    pk = pack_scene(ts)
    assert (pk.ns, pk.nl, pk.nt) == (ns, nl, nt) and pk.nsc == 0
    for a, b in ((j_sph, pk.sph), (j_tri, pk.tri), (j_cl, pk.cl)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cluster_builders_on_cornell():
    """The numpy builder and the native one: on this scene (axis-aligned
    walls, many equal centroids at the median) they split ties
    differently, so the triangle order and the cluster AABBs differ while
    the cluster sizes agree.  What both must hold is pinned, and the two
    packages' default builders (native, the port's built from the same
    source) give the same layout."""
    from path_tracing_tpu.runtime.native import build_clusters_native

    from path_tracing_tpu_torch.ops.bvh import build_clusters
    from path_tracing_tpu_torch.runtime.native import native_available

    tris = np.asarray(parser.load_scene(str(CORNELL)).tri_verts,
                      np.float32).reshape(-1, 9)
    assert native_available()
    for a, b in zip(jbvh.build_clusters(tris, 8), build_clusters(tris, 8)):
        np.testing.assert_array_equal(a, b)
    ours = build_clusters_py(tris, 8)
    jours = jbvh.build_clusters_py(tris, 8)
    for a, b in zip(ours, jours):          # same numpy algorithm: identical
        np.testing.assert_array_equal(a, b)
    nat = build_clusters_native(tris, 8)
    layouts = [ours] if nat is None else [ours, nat]
    for order, aabbs, ranges in layouts:
        assert sorted(order.tolist()) == list(range(36))
        assert ranges[:, 1].sum() == 36 and (ranges[:, 1] <= 8).all()
        assert len(ranges) == 8
        v = tris[order].reshape(-1, 3, 3)
        for (s, c), box in zip(ranges, aabbs):
            t = v[s:s + c]
            assert (t.min(axis=(0, 1)) >= box[:3]).all()
            assert (t.max(axis=(0, 1)) <= box[3:]).all()
    if nat is not None:
        np.testing.assert_array_equal(ours[2], nat[2])
        assert not np.array_equal(ours[0], nat[0])   # ties split apart


def test_camera_matches():
    # float32 camera basis and ray directions: rtol 1e-5 / atol 1e-6 covers
    # the last-ulp differences of the two frameworks' float32 arithmetic
    p = parser.load_scene(str(CORNELL))
    a = jcamera.make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48)
    b = camera.make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48,
                           device="cpu")
    for f in ("eye", "ul", "dx", "dy"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                   getattr(b, f).numpy(), rtol=1e-5,
                                   atol=1e-6)
    rs = np.random.RandomState(0)
    px = rs.randint(0, 64, 500).astype(np.int32)
    py = rs.randint(0, 48, 500).astype(np.int32)
    jx, jy = rs.uniform(0, 1, (2, 500)).astype(np.float32)
    da = np.asarray(jcamera.primary_ray_dirs(a, jnp.asarray(px),
                                             jnp.asarray(py),
                                             jnp.asarray(jx),
                                             jnp.asarray(jy)))
    db = camera.primary_ray_dirs(b, torch.from_numpy(px),
                                 torch.from_numpy(py), torch.from_numpy(jx),
                                 torch.from_numpy(jy)).numpy()
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_scene_from_jax_arrays_carries_tables():
    js, jc, ts, tc = jax_cornell(32, 24)
    d = jax_arrays(js, jc)
    np.testing.assert_array_equal(d["tri_v0"], ts.tri_v0.numpy())
    np.testing.assert_array_equal(d["sph_mtl.eta"], ts.sph_mtl.eta.numpy())
    np.testing.assert_array_equal(d["camera.ul"], tc.ul.numpy())
    assert ts.tri_cluster_range.dtype == torch.int32
    assert ts.num_triangles == 36 and ts.num_lights == 4


FRONT_ENDS = tuple(f"path_tracing_tpu_torch.{m}" for m in (
    "cli", "compare", "profiling", "profile_cli", "runtime.live_http",
    "runtime.resilience"))


def test_port_never_imports_jax():
    """Importing the port and every submodule (the front-ends among them)
    leaves jax and the JAX package out of sys.modules (a fresh
    interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import path_tracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'path_tracing_tpu' or m.startswith('path_tracing_tpu.')]\n"
        "assert not bad, bad\n"
        f"missing = set({FRONT_ENDS!r}) - set(sys.modules)\n"
        "assert not missing, missing\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
