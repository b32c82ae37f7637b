"""Batched ray-scene intersection and shadow transmittance
(``path_tracing_tpu.ops.intersect``).

The plain versions test every ray against every primitive as one ``(B, N)``
computation and take the nearest hit as an argmin.  The reference scans
spheres, then light balls, then triangles, keeping strictly-closer hits;
concatenating the per-category ``t`` in that order and taking the first
minimum reproduces that tie-break.

``packed_hit`` takes the nearest hit on packed tables through the plain
nearest hit of ``ops/cuda_intersect.py``.  On a textured scene the hit is
the ``with_uv`` one with the bilinear texel multiplied into a textured
triangle's base color (``texel_fields``), as the JAX function does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.types import Material
from .math3 import EPSILON, length
from .texture import sample_bilinear

INF = 1e20      # miss sentinel
SHADOW_EPS = 1e-3  # endpoint clearance on both ends of a shadow ray


@dataclass
class Hit:
    hit: torch.Tensor       # (B,) bool
    t: torch.Tensor         # (B,)
    pos: torch.Tensor       # (B, 3)
    normal: torch.Tensor    # (B, 3) flipped to face the ray
    mtl: Material           # (B, ...) light hits carry the light-ball material
    is_light: torch.Tensor  # (B,) bool


def sphere_ts(ro, rd, centers, radii, max_dist) -> torch.Tensor:
    """Per-(ray, sphere) hit distance (B, N) or INF: the near root, else
    the far root, each inside (EPSILON, max_dist); zero-radius rows never
    hit.  ``max_dist``: float or (B, 1)."""
    ocx = ro[:, 0:1] - centers[None, :, 0]
    ocy = ro[:, 1:2] - centers[None, :, 1]
    ocz = ro[:, 2:3] - centers[None, :, 2]
    rdx, rdy, rdz = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
    r = radii[None, :]
    b = ocx * rdx + ocy * rdy + ocz * rdz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    h = b * b - c
    sh = torch.sqrt(torch.clamp(h, min=0.0))
    t1 = -b - sh
    t2 = -b + sh
    ok = (h >= 0.0) & (r > 0.0)
    v1 = ok & (t1 > EPSILON) & (t1 < max_dist)
    v2 = ok & (t2 > EPSILON) & (t2 < max_dist)
    inf = torch.full_like(t1, INF)
    return torch.where(v1, t1, torch.where(v2, t2, inf))


def mt_core(ro, rd, v0, v1, v2):
    """Moller-Trumbore with the reference's 1e-6 determinant window and
    t > EPSILON, in the kernels' order of operations.  Every argument is
    an (x, y, z) tuple of broadcastable tensors: (B,) rays against (B,)
    vertices per lane, or ``triangle_ts``'s (B, 1) x (1, N) views.
    Returns (ok, u, v, t)."""
    e1 = tuple(v1[k] - v0[k] for k in range(3))
    e2 = tuple(v2[k] - v0[k] for k in range(3))
    return mt_from_edges(ro, rd, v0, e1, e2, EPSILON)


def mt_from_edges(ro, rd, v0, e1, e2, t_lo: float):
    """The body of :func:`mt_core` from the edges on, with t > ``t_lo``:
    edges precomputed by the same float32 subtraction give the same u, v,
    t bit for bit (the streamed tables store them)."""
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    rdx, rdy, rdz = rd
    hx = rdy * e2z - rdz * e2y
    hy = rdz * e2x - rdx * e2z
    hz = rdx * e2y - rdy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = (a > -1e-6) & (a < 1e-6)
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    sx, sy, sz = ro[0] - v0x, ro[1] - v0y, ro[2] - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (rdx * qx + rdy * qy + rdz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_lo))
    return ok, u, v, t


def triangle_ts(ro, rd, v0, v1, v2, max_dist) -> torch.Tensor:
    """Per-(ray, triangle) Moller-Trumbore hit distance (B, N) or INF, with
    the reference's 1e-6 determinant window and (EPSILON, max_dist)."""
    def cols(x):
        return tuple(x[None, :, k] for k in range(3))

    ok, _, _, t = mt_core(tuple(ro[:, k:k + 1] for k in range(3)),
                          tuple(rd[:, k:k + 1] for k in range(3)),
                          cols(v0), cols(v1), cols(v2))
    return torch.where(ok & (t < max_dist), t, torch.full_like(t, INF))


def hit_from_fields(h: dict, ro, rd) -> Hit:
    """Assemble a Hit from the nearest-hit field dict (t, nx.., flag)."""
    flag = h["flag"]
    return Hit(
        hit=flag > 0, t=h["t"],
        pos=ro + rd * h["t"][:, None],
        normal=torch.stack([h["nx"], h["ny"], h["nz"]], dim=-1),
        mtl=Material(base_color=torch.stack([h["bcr"], h["bcg"], h["bcb"]],
                                            dim=-1),
                     roughness=h["rough"], metallic=h["metal"], eta=h["eta"]),
        is_light=flag == 2)


def texel_fields(packed, h: dict) -> dict:
    """A ``with_uv`` hit record with the bilinear texel multiplied into the
    base color of textured triangles (``tex >= 0``)."""
    tex_id = h["tex"].to(torch.int32)
    texel = sample_bilinear(packed.atlas, packed.tex_size, tex_id,
                            torch.stack([h["iu"], h["iv"]], dim=-1))
    on = tex_id >= 0
    h = dict(h)
    for i, k in enumerate(("bcr", "bcg", "bcb")):
        h[k] = torch.where(on, h[k] * texel[:, i], h[k])
    return h


def packed_hit(packed, ro: torch.Tensor, rd: torch.Tensor, live=None,
               nearest=None) -> Hit:
    """The nearest hit on packed tables through ``nearest`` (the plain
    nearest hit by default, or the same with a ``counts``): on a textured
    scene the ``with_uv`` hit with its texel (``texel_fields``).  ``live``
    (B,) bool: the lanes whose result is read (the others miss)."""
    if nearest is None:
        from .cuda_intersect import nearest_hit_plain as nearest
    if packed.textured:
        h = texel_fields(packed, nearest(packed, ro, rd, with_uv=True,
                                         live=live))
    else:
        h = nearest(packed, ro, rd, live=live)
    return hit_from_fields(h, ro, rd)


def shadow_ray(p1: torch.Tensor, p2: torch.Tensor):
    """Endpoint pair -> (direction (B, 3), distance (B,), max_d (B,))."""
    diff = p2 - p1
    dist = length(diff)
    rd = diff * (1.0 / torch.clamp(dist, min=1e-20))[:, None]
    return rd, dist, dist - SHADOW_EPS


