"""Synthetic scenes (``path_tracing_tpu.scene.synth``): subdivided
icospheres at a given triangle count, optionally with spherical UVs and a
procedural checker texture, and ``write_obj`` to store one as OBJ + MTL +
PNG so it can be rendered through the CLI's ``--input``; SPD's
sphereflake (``sphereflake_scene``), and ``scene_text`` to store a scene
as a text scene (``sphereflake_text``: the sphereflake's)."""
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


# Eric Haines' Standard Procedural Databases (SPD), balls.c: the
# sphereflake at the size factor ``levels`` (4 by default, 7,381 spheres).
# SPD's source is not in this repository; what follows is written from
# its description and printed output (benchmark/configs/sphereflake.json
# lists each constant so written under "assumed").
FLAKE_UP_ELEVATION = math.asin(2.0 / math.sqrt(6.0))  # the upper trio
FLAKE_GROUND_HALF = 12.0
FLAKE_VIEW = dict(eye=(2.1, 1.3, 1.7), look_at=(0.0, 0.0, 0.0),
                  view_up=(0.0, 0.0, 1.0), fov=45.0)
FLAKE_LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
FLAKE_LIGHT_FLUX = 300.0
FLAKE_LIGHT_BALL = 0.05
FLAKE_SPHERE_MTL = (1.0, 0.9, 0.7, 0.1, 1.0, 0.0)
FLAKE_GROUND_MTL = (1.0, 0.75, 0.33, 1.0, 0.0, 0.0)


def _flake_dirs() -> np.ndarray:
    """The nine child directions in the parent's frame (its axis +z):
    six 60 degrees apart about the equator, then three above at
    ``FLAKE_UP_ELEVATION``, 120 degrees apart and turned 30 degrees from
    the six (float64, unit)."""
    out = [(math.cos(a), math.sin(a), 0.0)
           for a in (math.radians(60.0 * k) for k in range(6))]
    ce, se = math.cos(FLAKE_UP_ELEVATION), math.sin(FLAKE_UP_ELEVATION)
    out += [(ce * math.cos(a), ce * math.sin(a), se)
            for a in (math.radians(30.0 + 120.0 * k) for k in range(3))]
    return np.asarray(out, np.float64)


def _turn_z_to(d: np.ndarray) -> np.ndarray:
    """The rotation (3, 3) that takes +z to the unit ``d`` about the axis
    z x d (the identity for d = +z)."""
    k = np.cross((0.0, 0.0, 1.0), d)
    s, c = np.linalg.norm(k), d[2]
    if s < 1e-12:
        return np.eye(3)
    k = k / s
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + s * kx + (1.0 - c) * (kx @ kx)


def sphereflake_spheres(levels: int = 4):
    """Centres (N, 3) and radii (N,) in float64 of the sphereflake with
    ``levels`` levels of children below the root (1 + 9 + ... + 9^levels
    spheres), parents before their children, level by level.  The root
    sits at the origin with radius 0.5 and axis +z; each sphere's nine
    children have a third of its radius and touch it (centre distance
    r + r/3) in the directions of ``_flake_dirs`` turned into its frame,
    whose axis points from its parent to it."""
    dirs = _flake_dirs()
    centers = [np.zeros(3)]
    radii = [0.5]
    frames = [np.eye(3)]
    level = [0]
    for _ in range(levels):
        nxt = []
        for i in level:
            c, r, f = centers[i], radii[i], frames[i]
            for d in dirs:
                w = f @ d
                centers.append(c + w * (r + r / 3.0))
                radii.append(r / 3.0)
                frames.append(f @ _turn_z_to(d))
                nxt.append(len(centers) - 1)
        level = nxt
    return np.asarray(centers), np.asarray(radii)


def sphereflake_scene(levels: int = 4) -> ParsedScene:
    """SPD's sphereflake as a ParsedScene: ``sphereflake_spheres(levels)``
    in ``FLAKE_SPHERE_MTL`` (a low-roughness metal), the ground square of
    half-side ``FLAKE_GROUND_HALF`` at z = -0.5 as two triangles in
    ``FLAKE_GROUND_MTL``, the view of ``FLAKE_VIEW`` at 1920x1080 and three
    point lights (spot lights with a 180 degree cutoff) of flux
    ``FLAKE_LIGHT_FLUX`` each, aimed at the origin."""
    c, r = sphereflake_spheres(levels)
    out = ParsedScene()
    out.eye = np.asarray(FLAKE_VIEW["eye"], np.float32)
    out.look_at = np.asarray(FLAKE_VIEW["look_at"], np.float32)
    out.view_up = np.asarray(FLAKE_VIEW["view_up"], np.float32)
    out.fov = FLAKE_VIEW["fov"]
    out.width, out.height = 1920, 1080
    out.sph_center = np.float32(c).tolist()
    out.sph_radius = np.float32(r).tolist()
    out.sph_mtl = [list(FLAKE_SPHERE_MTL)] * len(r)
    out.sph_legacy = [[0.0] * 4] * len(r)
    out.sph_group = [0] * len(r)
    g, z = FLAKE_GROUND_HALF, -0.5
    quad = [(-g, -g, z), (g, -g, z), (g, g, z), (-g, g, z)]
    out.tri_verts = [[list(quad[0]), list(quad[1]), list(quad[2])],
                     [list(quad[0]), list(quad[2]), list(quad[3])]]
    out.tri_mtl = [list(FLAKE_GROUND_MTL)] * 2
    out.tri_legacy = [[0.0] * 4] * 2
    out.tri_group = [0] * 2
    for p in FLAKE_LIGHTS:
        d = -np.asarray(p) / np.linalg.norm(p)
        out.lights.append([*p, *d, *([FLAKE_LIGHT_FLUX] * 3), math.pi, 0.0,
                           FLAKE_LIGHT_BALL])
    return out


def scene_text(scene: ParsedScene, title: str = "") -> str:
    """``scene`` (untextured, no legacy Ks) as a text scene in the
    ``E/V/F/R/M/S/T/L`` grammar that ``parser.parse_scene_text`` reads back
    to the same float32 values: an ``M`` record where the material
    changes, spheres, then triangles, then the lights (cutoff in degrees).
    Each number is the shortest decimal that parses back to its float32;
    ``title`` opens it as comment lines."""
    def num(x) -> str:
        return str(np.float32(x))

    def nums(xs) -> str:
        return " ".join(num(x) for x in xs)

    lines = [f"// {t}" for t in title.splitlines()]
    lines += [f"E {nums(scene.eye)}",
              f"V {nums(scene.look_at)}  {nums(scene.view_up)}",
              f"F {num(scene.fov)}", f"R {scene.width} {scene.height}"]
    cur = None

    def mtl(row):
        nonlocal cur
        if cur is None or list(row) != cur:
            cur = list(row)
            lines.append(f"M {nums(row)}")

    for c, r, m in zip(scene.sph_center, scene.sph_radius, scene.sph_mtl):
        mtl(m)
        lines.append(f"S {nums(c)}  {num(r)}")
    for tv, m in zip(scene.tri_verts, scene.tri_mtl):
        mtl(m)
        lines.append("T " + "  ".join(nums(v) for v in tv))
    for li in scene.lights:
        lines.append(f"L {nums(li[0:3])}  {nums(li[3:6])}  {nums(li[6:9])}  "
                     f"{num(math.degrees(li[9]))} {int(li[10])} {num(li[11])}")
    return "\n".join(lines) + "\n"


def sphereflake_text(levels: int = 4) -> str:
    """``sphereflake_scene(levels)`` as a text scene, titled."""
    n = len(sphereflake_spheres(levels)[1])
    return scene_text(sphereflake_scene(levels), (
        "SPD sphereflake (Eric Haines, Standard Procedural Databases, "
        f"balls.c), size factor {levels}:\n{n} spheres, the ground square "
        "as 2 triangles, 3 point lights.\nWritten by "
        f"path_tracing_tpu_torch.scene.synth.sphereflake_text({levels})."))
