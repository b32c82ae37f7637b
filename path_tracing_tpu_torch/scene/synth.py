"""Synthetic mesh scenes (``path_tracing_tpu.scene.synth``): subdivided
icospheres at a given triangle count, optionally with spherical UVs and a
procedural checker texture, and ``write_obj`` to store one as OBJ + MTL +
PNG so it can be rendered through the CLI's ``--input``."""
from __future__ import annotations

import math
import os

import numpy as np

from ..film import write_png
from .obj_loader import default_framing
from .parser import ParsedScene


def icosphere(n_tris: int):
    """Subdivide an icosahedron until it has >= ``n_tris`` faces; returns
    (vertices (V, 3) float32 on the unit sphere, faces (F, 3) int32)."""
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
    """(n, n, 3) float32 linear-RGB red/blue checkerboard."""
    cells = (np.indices((n, n)).sum(axis=0) // cell) % 2
    img = np.empty((n, n, 3), np.float32)
    img[cells == 0] = ((np.array([230, 60, 60]) / 255.0) ** 2.2)
    img[cells == 1] = ((np.array([60, 60, 230]) / 255.0) ** 2.2)
    return img


def icosphere_scene(n_tris: int, textured: bool = False,
                    mtl=None) -> ParsedScene:
    """A ParsedScene holding a >= ``n_tris`` icosphere with the framing and
    light of an OBJ without a companion scene (``default_framing``);
    ``textured`` adds spherical UVs (v pointing up) and the checker
    texture.  ``mtl`` is a [r, g, b, rough, metal, eta] row (default:
    white diffuse)."""
    v, f = icosphere(n_tris)
    mtl = list(mtl) if mtl is not None else [0.75, 0.75, 0.75, 1.0, 0.0, 0.0]
    out = ParsedScene()
    out.tri_verts = [[v[a].tolist(), v[b].tolist(), v[c].tolist()]
                     for a, b, c in f]
    out.tri_mtl = [mtl] * len(f)
    out.tri_group = [0] * len(f)
    if textured:
        u = 0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * math.pi)
        w = 0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / math.pi
        uv = np.stack([u, 1.0 - w], axis=1).astype(np.float32)
        out.tri_uv = [[*uv[a], *uv[b], *uv[c]] for a, b, c in f]
        out.tri_tex = [0] * len(f)
        out.textures = [checker_texture()]
    default_framing(out)
    return out


def write_obj(scene: ParsedScene, path: str) -> str:
    """Write the triangles of ``scene`` as ``path`` (OBJ), ``<name>.mtl``
    and one ``<name>_tex<i>.png`` per texture, so that
    ``obj_loader.load_obj`` reads back the same triangles, UVs, texture ids
    and materials (texels to within the PNG's 8 bits; texture ids in order
    of first use).  Materials are written as PBR ``Pr``/``Pm`` rows;
    positions and UVs with 9 significant digits, which round-trip float32.
    Returns ``path``."""
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    tv = np.asarray(scene.tri_verts, np.float32).reshape(-1, 3)
    nt = tv.shape[0] // 3
    uv = (np.asarray(scene.tri_uv, np.float32).reshape(-1, 2)
          if len(scene.tri_uv) else np.zeros((3 * nt, 2), np.float32))
    tex = (np.asarray(scene.tri_tex, np.int64) if len(scene.tri_tex)
           else np.full(nt, -1))
    pos, vi = np.unique(tv, axis=0, return_inverse=True)
    tcs, ti = np.unique(uv, axis=0, return_inverse=True)
    vi, ti = vi.reshape(-1, 3) + 1, ti.reshape(-1, 3) + 1

    for i, img in enumerate(scene.textures):
        u8 = np.clip(np.round(np.asarray(img) ** (1.0 / 2.2) * 255.0), 0, 255)
        write_png(f"{base}_tex{i}.png", u8.astype(np.uint8))
    rows = np.asarray(scene.tri_mtl, np.float32).reshape(-1, 6)
    keys = np.concatenate([rows, tex[:, None].astype(np.float32)], 1)
    mats, mi = np.unique(keys, axis=0, return_inverse=True)
    mi = mi.reshape(-1)
    with open(f"{base}.mtl", "w") as f:
        for k, (r, g, b, rough, metal, eta, t) in enumerate(mats):
            f.write(f"newmtl m{k}\nKd {r:.9g} {g:.9g} {b:.9g}\n"
                    f"Pr {rough:.9g}\nPm {metal:.9g}\nillum 2\n")
            if eta > 0:
                f.write(f"Ni {eta:.9g}\nd 0.5\n")
            if t >= 0:
                f.write(f"map_Kd {name}_tex{int(t)}.png\n")
    lines = [f"mtllib {name}.mtl\n"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in pos]
    lines += [f"vt {a:.9g} {b:.9g}\n" for a, b in tcs]
    cur = None
    for k in range(nt):
        if mi[k] != cur:
            cur = mi[k]
            lines.append(f"usemtl m{cur}\n")
        (a, b, c), (ta, tb, tc) = vi[k], ti[k]
        lines.append(f"f {a}/{ta} {b}/{tb} {c}/{tc}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path
