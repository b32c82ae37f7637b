"""The scene file of a configuration.

``configs/<name>.json`` names a plain reference scene (``scene``: a text
scene beside it under ``configs/``), a generated ``mesh`` (an icosphere
of at least ``icosphere_tris`` triangles with one material row,
optionally ``textured``), or both: an untextured ``mesh`` placed in the
``scene`` by ``radius`` and ``center``.  A mesh alone is written once as
OBJ + MTL (+ a checker PNG), which both loaders frame by their default
framing (the camera outside the mesh along -z and one overhead spot
light); a mesh in a scene is written once as a text scene: the scene's
text, the mesh's material and one triangle a line.  Either lies under
``cache/scenes/`` at a path fixed by the configuration's bytes (and the
scene's).  Both the program and the reference parse that file."""
from __future__ import annotations

import hashlib
import math
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from .cells import HERE

CACHE = HERE / "cache" / "scenes"


def icosphere(n_tris: int):
    """Subdivide an icosahedron until it has >= ``n_tris`` faces: (vertices
    (V, 3) float32 on the unit sphere, faces (F, 3) int32).  Frozen from the
    port's ``scene/synth.py``."""
    p = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                  [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                  [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 int)
    while len(f) < n_tris:
        cache: dict = {}
        verts = list(map(tuple, v))

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = np.asarray(verts[a]) + np.asarray(verts[b])
                m /= np.linalg.norm(m)
                cache[k] = len(verts)
                verts.append(tuple(m))
            return cache[k]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), np.asarray(nf)
    return v.astype(np.float32), f.astype(np.int32)


def checker_texture(n: int = 256, cell: int = 32):
    """(n, n, 3) float32 linear-RGB red/blue checkerboard.  Frozen from the
    port's ``scene/synth.py``."""
    cells = (np.indices((n, n)).sum(axis=0) // cell) % 2
    img = np.empty((n, n, 3), np.float32)
    img[cells == 0] = ((np.array([230, 60, 60]) / 255.0) ** 2.2)
    img[cells == 1] = ((np.array([60, 60, 230]) / 255.0) ** 2.2)
    return img


def write_png(path: Path, rgb_u8: np.ndarray) -> None:
    """An RGB8 PNG, every row unfiltered."""
    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(raw, 6))
                     + chunk(b"IEND", b""))


def write_mesh_obj(mesh: dict, out: Path) -> None:
    """``mesh``'s unit icosphere as ``out`` (OBJ), ``<stem>.mtl`` and, with
    ``textured``, ``<stem>_tex0.png``: spherical UVs (v pointing up) and
    the checker texture, as the port's ``synth.icosphere_scene`` and
    ``synth.write_obj`` make them.  Positions and UVs with 9 significant
    digits, which parse back to the same float32."""
    v, f = icosphere(int(mesh["icosphere_tris"]))
    r, g, b, rough, metal, eta = mesh["material"]
    stem = out.stem
    tv = v[f].reshape(-1, 3)
    pos, vi = np.unique(tv, axis=0, return_inverse=True)
    vi = vi.reshape(-1, 3) + 1
    mtl = (f"newmtl m0\nKd {r:.9g} {g:.9g} {b:.9g}\nPr {rough:.9g}\n"
           f"Pm {metal:.9g}\nillum 2\n")
    if eta > 0:
        mtl += f"Ni {eta:.9g}\nd 0.5\n"
    lines = [f"mtllib {stem}.mtl\n"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pos]
    if mesh.get("textured"):
        u = 0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * math.pi)
        w = 0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / math.pi
        uv = np.stack([u, 1.0 - w], axis=1).astype(np.float32)[f]
        tcs, ti = np.unique(uv.reshape(-1, 2), axis=0, return_inverse=True)
        ti = ti.reshape(-1, 3) + 1
        img = checker_texture()
        u8 = np.clip(np.round(img ** (1.0 / 2.2) * 255.0), 0, 255)
        write_png(out.with_name(f"{stem}_tex0.png"), u8.astype(np.uint8))
        mtl += f"map_Kd {stem}_tex0.png\n"
        lines += [f"vt {a:.9g} {c:.9g}\n" for a, c in tcs]
        lines.append("usemtl m0\n")
        lines += [f"f {a}/{ta} {b_}/{tb} {c}/{tc}\n"
                  for (a, b_, c), (ta, tb, tc) in zip(vi, ti)]
    else:
        lines.append("usemtl m0\n")
        lines += [f"f {a} {b_} {c}\n" for a, b_, c in vi]
    out.with_name(f"{stem}.mtl").write_text(mtl)
    out.write_text("".join(lines))


def write_placed_txt(scene: Path, mesh: dict, out: Path) -> None:
    """``scene``'s text byte for byte, then ``mesh``'s material as an ``M``
    record and one ``T`` record a triangle of its icosphere, each vertex
    scaled by ``radius`` and moved to ``center`` in float32.  Positions
    with 9 significant digits, which parse back to the same float32."""
    v, f = icosphere(int(mesh["icosphere_tris"]))
    tv = v[f] * np.float32(mesh["radius"]) + np.asarray(mesh["center"],
                                                        np.float32)
    with open(out, "wb") as fh:
        fh.write(scene.read_bytes())
        fh.write(("\nM " + " ".join(f"{x:.9g}" for x in mesh["material"])
                  + "\n").encode())
        np.savetxt(fh, tv.reshape(-1, 9), fmt="T" + " %.9g" * 9)


def scene_file(config_name: str, config: dict, root: Path | None = None
               ) -> Path:
    """The scene file the configuration renders, written first if it holds
    a generated mesh that is not in the cache yet.  Raises ValueError for a
    textured mesh in a scene: a text scene has no UVs."""
    root = HERE if root is None else root
    scene = config.get("scene")
    if "mesh" not in config:
        return root / "configs" / scene
    if scene is not None and config["mesh"].get("textured"):
        raise ValueError(f"{config_name}: a mesh in a scene is written as a "
                         "text scene, which has no UVs; it cannot be "
                         "textured")
    h = hashlib.sha256(
        (root / "configs" / f"{config_name}.json").read_bytes())
    if scene is not None:
        h.update((root / "configs" / scene).read_bytes())
    digest = h.hexdigest()[:12]
    # the scene file (and an OBJ's MTL and PNG) is written into a
    # directory of its own, which appears whole or not at all
    final = CACHE / f"{config_name}-{digest}"
    out = final / f"{config_name}{'.obj' if scene is None else '.txt'}"
    if not out.exists():
        tmp = CACHE / f".{config_name}-{digest}.{os.getpid()}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        if scene is None:
            write_mesh_obj(config["mesh"], tmp / out.name)
        else:
            write_placed_txt(root / "configs" / scene, config["mesh"],
                             tmp / out.name)
        try:
            os.replace(tmp, final)
        except OSError:           # another process wrote it first
            for f in tmp.iterdir():
                f.unlink()
            tmp.rmdir()
    return out
