"""Batched ray-scene intersection and shadow transmittance
(``path_tracing_tpu.ops.intersect``).

The plain versions test every ray against every primitive as one ``(B, N)``
computation and take the nearest hit as an argmin.  The reference scans
spheres, then light balls, then triangles, keeping strictly-closer hits;
concatenating the per-category ``t`` in that order and taking the first
minimum reproduces that tie-break.

``find_closest_hit`` (``packed_hit`` on packed tables), ``transmittance``
and ``transmittance_rgb`` go through the nearest-hit, any-blocker and RGB
transmittance wrappers of ``ops/cuda_intersect.py``: CUDA tensors launch
the hand-written kernels, CPU tensors take the plain versions.  On a
textured scene the hit is the ``with_uv`` one with the bilinear texel
multiplied into a textured triangle's base color (``texel_fields``), as
the JAX function does.  The PT ``stream`` tier sorts
its rays with ``sorted_call`` for the streamed wrappers of
``ops/cuda_stream.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.types import Material, Scene
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
    return sphere_t_pairs(ro[:, None], rd[:, None], centers[None],
                          radii[None], max_dist)


def sphere_t_pairs(ro, rd, centers, radii, max_dist) -> torch.Tensor:
    """``sphere_ts``'s distance of rays against spheres paired by
    broadcasting: ``ro``, ``rd``, ``centers`` (..., 3), ``radii`` (...)."""
    ocx = ro[..., 0] - centers[..., 0]
    ocy = ro[..., 1] - centers[..., 1]
    ocz = ro[..., 2] - centers[..., 2]
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    r = radii
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


def _spread6(x: torch.Tensor) -> torch.Tensor:
    """6 bits -> every third bit."""
    x = (x | (x << 8)) & 0x0300F
    x = (x | (x << 4)) & 0x030C3
    return (x | (x << 2)) & 0x09249


def coherence_key(scene_min, scene_max, ro, rd) -> torch.Tensor:
    """Ray sort key (``_coherence_key``): the direction octant above an
    18-bit Morton code of the origin quantized to 64 cells a side of the
    scene AABB.  int32 (B,)."""
    ext = torch.clamp(scene_max - scene_min, min=1e-6)
    x = (ro - scene_min) / ext * 64.0
    # XLA converts float to int saturating, NaN to 0
    x = torch.nan_to_num(x, nan=0.0).clamp(-1.0, 64.0)
    q = torch.clamp(x.to(torch.int32), 0, 63)
    morton = (_spread6(q[:, 0]) | (_spread6(q[:, 1]) << 1)
              | (_spread6(q[:, 2]) << 2))
    octant = ((rd[:, 0] >= 0).to(torch.int32)
              | ((rd[:, 1] >= 0).to(torch.int32) << 1)
              | ((rd[:, 2] >= 0).to(torch.int32) << 2))
    return (octant << 18) | morton


def sorted_call(bounds, ro, rd, fn, *extras, live=None):
    """``fn(ro, rd, *extras, n_live=...)`` on coherence-sorted rays, its
    results (a tensor or a tuple of (B,)-leading tensors) put back in lane
    order (``_sorted_call``).  ``bounds`` is (scene_min, scene_max).
    ``live`` (B,) bool: dead lanes sort behind every live key (bit 30) and
    ``n_live``, a (1,) int32 tensor on the rays' device, tells ``fn`` where
    they start; without it ``n_live`` is None."""
    key = coherence_key(*bounds, ro, rd)
    n_live = None
    if live is not None:
        key = torch.where(live, key, key | (1 << 30))
        n_live = live.sum(dtype=torch.int32).reshape(1)
    order = torch.argsort(key, stable=True)
    out = fn(ro[order], rd[order], *(e[order] for e in extras),
             n_live=n_live)

    def unsort(x):
        y = torch.empty_like(x)
        y[order] = x
        return y

    return (tuple(unsort(x) for x in out) if isinstance(out, tuple)
            else unsort(out))


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
    """The nearest hit on packed tables through ``nearest`` (the
    ``nearest_hit`` wrapper by default, or a plain version): on a textured
    scene the ``with_uv`` hit with its texel (``texel_fields``).  ``live``
    (B,) bool: the lanes whose result is read (the others miss)."""
    if nearest is None:
        from .cuda_intersect import nearest_hit as nearest
    if packed.textured:
        h = texel_fields(packed, nearest(packed, ro, rd, with_uv=True,
                                         live=live))
    else:
        h = nearest(packed, ro, rd, live=live)
    return hit_from_fields(h, ro, rd)


def find_closest_hit(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                     live=None) -> Hit:
    """Nearest hit over spheres, light balls and triangles, textured on a
    textured scene.  ``live`` (B,) bool: the lanes whose result is read;
    the others get the miss record."""
    return packed_hit(scene.packed.take(), ro, rd, live)


def shadow_ray(p1: torch.Tensor, p2: torch.Tensor):
    """Endpoint pair -> (direction (B, 3), distance (B,), max_d (B,))."""
    diff = p2 - p1
    dist = length(diff)
    rd = diff * (1.0 / torch.clamp(dist, min=1e-20))[:, None]
    return rd, dist, dist - SHADOW_EPS


def transmittance(scene: Scene, p1: torch.Tensor, p2: torch.Tensor,
                  dielectrics_block: bool, live=None) -> torch.Tensor:
    """Binary shadow-ray transmittance (B,) between two points.

    ``dielectrics_block=True`` is the GPU rule (every occluder blocks);
    False is the CPU oracle's (only eta <= 0 materials block).  Light balls
    never occlude.  ``live`` (B,) bool: the lanes whose result is read (the
    others are unblocked)."""
    from .cuda_intersect import any_blocker

    rd, _, max_d = shadow_ray(p1, p2)
    blocked = any_blocker(scene.packed.take(), p1, rd, max_d,
                          dielectrics_block, live)
    return torch.where(blocked, torch.zeros_like(max_d),
                       torch.ones_like(max_d))


def transmittance_rgb(scene: Scene, p1: torch.Tensor, p2: torch.Tensor,
                      live=None) -> torch.Tensor:
    """RGB shadow transmittance (B, 3) between two points: every occluder
    in the segment's (1e-3, dist - 1e-3) window multiplies its legacy
    ``Ks`` in if its ``refract`` is > 0 and blocks fully otherwise; light
    balls never occlude.  ``live`` (B,) bool: the other lanes get 1."""
    from .cuda_intersect import transmittance_rgb as rgb

    rd, _, max_d = shadow_ray(p1, p2)
    return rgb(scene.packed.take(), p1, rd, max_d, live)


def shadow_factor(scene: Scene, p1, p2, dielectrics_block: bool,
                  live=None) -> torch.Tensor:
    """Shadow transmittance as (B, 3): RGB (``transmittance_rgb``) when the
    scene carries legacy Ks/refract rows under the GPU rule, else the
    binary transmittance broadcast (the oracle's rule stays binary, as the
    reference's CPU visibility test is)."""
    if dielectrics_block and scene.has_legacy_ks:
        return transmittance_rgb(scene, p1, p2, live)
    return transmittance(scene, p1, p2, dielectrics_block, live)[
        :, None].expand(p1.shape[0], 3)
