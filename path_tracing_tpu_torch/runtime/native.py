"""ctypes bindings to the native C++ host runtime (``csrc/pt_runtime.cc``):
the text-scene and OBJ/MTL parsers and the median-split cluster builder
(``path_tracing_tpu.runtime.native``, the same entry points and argument
lists).

The library is built from ``csrc/pt_runtime.cc`` at first use (the first
call, not the import) with ``g++ -O3 -fPIC -std=c++17 -shared`` into
``path_tracing_tpu_torch/build/libpt_runtime_<hash>.so``, the hash taken
over the source and the flags, under a file lock and with an atomic
rename, so that processes starting together build it once.  The
``csrc/libpt_runtime.so`` beside the source is never loaded or rebuilt.
When the library cannot be built or loaded, ``native_available()`` is
False and the callers (``scene/obj_loader.py::load_any_scene``,
``ops/bvh.py::build_clusters``) take the Python parsers and the numpy
builder, which implement the same formats and algorithm.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "csrc" / "pt_runtime.cc"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: ctypes.CDLL | None = None
_tried = False
# how the library of this process was had: its path, whether this process
# compiled it, the build's seconds, or why there is none
build_info: dict = {}


def build_library(build_dir: Path = BUILD_DIR) -> tuple:
    """Compile ``csrc/pt_runtime.cc`` into ``build_dir`` unless a build of
    this source and these flags is there.  Returns (the library's path,
    whether this call compiled it).  One process compiles under an
    exclusive ``flock`` on ``build_dir/pt_runtime.lock``; the others wait
    for it and reuse its library.  Raises ``RuntimeError`` without a C++
    compiler or with the compiler's output when the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = Path(build_dir) / f"libpt_runtime_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for csrc/pt_runtime.cc")
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "pt_runtime.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if so.exists():                    # built while this one waited
            return so, False
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ csrc/pt_runtime.cc failed "
                               f"({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
    return so, True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The JAX package's argument lists (``runtime/native.py:45-75``)."""
    lib.pt_parse_scene_file.restype = ctypes.c_void_p
    lib.pt_parse_scene_file.argtypes = [ctypes.c_char_p]
    lib.pt_parse_obj_file.restype = ctypes.c_void_p
    lib.pt_parse_obj_file.argtypes = [ctypes.c_char_p]
    lib.pt_scene_free.restype = None
    lib.pt_scene_free.argtypes = [ctypes.c_void_p]
    for f in ("pt_num_spheres", "pt_num_triangles", "pt_num_lights",
              "pt_num_textures"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for f in ("pt_get_spheres", "pt_get_triangles", "pt_get_lights",
              "pt_get_camera", "pt_get_tri_uv"):
        getattr(lib, f).restype = None
        getattr(lib, f).argtypes = [ctypes.c_void_p, fp]
    lib.pt_get_groups.restype = None
    lib.pt_get_groups.argtypes = [ctypes.c_void_p, ip, ip]
    lib.pt_get_legacy.restype = None
    lib.pt_get_legacy.argtypes = [ctypes.c_void_p, fp, fp]
    lib.pt_get_tri_tex.restype = None
    lib.pt_get_tri_tex.argtypes = [ctypes.c_void_p, ip]
    lib.pt_get_texture_path.restype = ctypes.c_int
    lib.pt_get_texture_path.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_int]
    lib.pt_build_clusters.restype = ctypes.c_int
    lib.pt_build_clusters.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                      ip, fp, ip, ctypes.c_int]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    t0 = time.perf_counter()
    try:
        so, built = build_library(BUILD_DIR)
        _lib = _bind(ctypes.CDLL(str(so)))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        build_info.update(error=str(e))
        return None
    build_info.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0)
    return _lib


def native_available() -> bool:
    """Whether the native library is built and loaded (building it now if
    this is the first use)."""
    return _load() is not None


def _texture_path(lib, h, i: int) -> str | None:
    """Path ``i`` of the scene's texture table.  ``pt_get_texture_path``
    returns the capacity it needs when the buffer is too small, so a long
    path is read again at that size (a fixed buffer would drop it)."""
    buf = ctypes.create_string_buffer(4096)
    rc = lib.pt_get_texture_path(h, i, buf, len(buf))
    if rc > 0:
        buf = ctypes.create_string_buffer(rc)
        rc = lib.pt_get_texture_path(h, i, buf, rc)
    return os.path.normpath(buf.value.decode()) if rc == 0 else None


def parse_scene_native(path: str):
    """Parse a text scene (or a ``.obj``) with the C++ runtime.  Returns a
    ``ParsedScene``, or None when the library is unavailable or the file
    does not parse."""
    lib = _load()
    if lib is None:
        return None
    is_obj = path.lower().endswith(".obj")
    fn = lib.pt_parse_obj_file if is_obj else lib.pt_parse_scene_file
    h = fn(path.encode())
    if not h:
        return None
    try:
        ns = lib.pt_num_spheres(h)
        nt = lib.pt_num_triangles(h)
        nl = lib.pt_num_lights(h)
        sph = np.zeros((max(ns, 1), 10), np.float32)
        tri = np.zeros((max(nt, 1), 15), np.float32)
        lig = np.zeros((max(nl, 1), 12), np.float32)
        cam = np.zeros(12, np.float32)
        sg = np.zeros(max(ns, 1), np.int32)
        tg = np.zeros(max(nt, 1), np.int32)
        if ns:
            lib.pt_get_spheres(h, sph.reshape(-1))
        if nt:
            lib.pt_get_triangles(h, tri.reshape(-1))
        if nl:
            lib.pt_get_lights(h, lig.reshape(-1))
        lib.pt_get_camera(h, cam)
        lib.pt_get_groups(h, sg, tg)
        sleg = np.zeros((max(ns, 1), 4), np.float32)
        tleg = np.zeros((max(nt, 1), 4), np.float32)
        lib.pt_get_legacy(h, sleg.reshape(-1), tleg.reshape(-1))
        uv = tex = tex_paths = None
        if is_obj and nt:
            uv = np.zeros((nt, 6), np.float32)
            tex = np.zeros(nt, np.int32)
            lib.pt_get_tri_uv(h, uv.reshape(-1))
            lib.pt_get_tri_tex(h, tex)
            tex_paths = [_texture_path(lib, h, i)
                         for i in range(lib.pt_num_textures(h))]
    finally:
        lib.pt_scene_free(h)

    from ..scene.parser import ParsedScene

    out = ParsedScene()
    out.eye, out.look_at, out.view_up = cam[0:3], cam[3:6], cam[6:9]
    out.fov = float(cam[9])
    out.width, out.height = int(cam[10]), int(cam[11])
    for i in range(ns):
        out.sph_center.append(sph[i, 0:3].tolist())
        out.sph_radius.append(float(sph[i, 3]))
        out.sph_mtl.append(sph[i, 4:10].tolist())
        out.sph_legacy.append(sleg[i].tolist())
        out.sph_group.append(int(sg[i]))
    # triangles as arrays: a row loop takes seconds on a 300k-triangle mesh
    out.tri_verts = tri[:nt, 0:9].reshape(nt, 3, 3)
    out.tri_mtl = tri[:nt, 9:15]
    out.tri_legacy = tleg[:nt]
    out.tri_group = tg[:nt]
    out.lights = [lig[i].tolist() for i in range(nl)]

    if uv is not None:
        # decode the images in first-use order, as obj_loader.load_obj does;
        # the C++ side keys a texture on the joined path as written, so
        # 'tex.png' and './tex.png' share one slot here by their normpath;
        # a failed decode becomes -1 and takes no slot
        from ..scene.obj_loader import _decode_texture

        id_map = np.full(len(tex_paths) + 1, -1, np.int32)
        slots: dict = {}
        for i, p in enumerate(tex_paths):
            if p is None:
                continue
            if p not in slots:
                img = _decode_texture(p)
                slots[p] = -1 if img is None else len(out.textures)
                if img is not None:
                    out.textures.append(img)
            id_map[i] = slots[p]
        out.tri_uv = uv
        out.tri_tex = id_map[tex]   # tex -1 reads the sentinel last entry
    return out


def build_clusters_native(tris9: np.ndarray, leaf_size: int = 16):
    """Median-split clusters with the C++ builder: (order (N,), aabbs
    (M, 6), ranges (M, 2)) as ``ops/bvh.py::build_clusters_py`` returns
    them, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    tris9 = np.ascontiguousarray(tris9, np.float32).reshape(-1, 9)
    n = tris9.shape[0]
    max_clusters = max(4, 2 * (n // max(leaf_size, 1) + 2))
    order = np.zeros(n, np.int32)
    aabbs = np.zeros((max_clusters, 6), np.float32)
    ranges = np.zeros((max_clusters, 2), np.int32)
    m = lib.pt_build_clusters(tris9.reshape(-1), n, leaf_size, order,
                              aabbs.reshape(-1), ranges.reshape(-1),
                              max_clusters)
    if m < 0:
        return None
    return order, aabbs[:m], ranges[:m]
