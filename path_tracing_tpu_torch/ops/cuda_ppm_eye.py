"""The PPM eye pass in one launch.  It replaces no TPU kernel: the JAX
package runs the pass as an XLA loop around ``nearest_hit_pallas``
(``path_tracing_tpu.integrators.ppm.ppm_eye_trace``).

``ppm_eye`` follows each pixel's delta chain (perfect mirrors and glass)
from a jittered camera ray, stores a hitpoint at the first rough surface
and assigns (does not add) the radiance of a light ball the chain
reaches: (direct (B, 3), ``HitPoints``).  The jitter draws rows 0-1 of
``fold_in(key, 0x9E1)`` and iteration ``it`` rows 0-2 of
``iter_key(fold_in(key, 0x9E2), it)``, at the pixel's lane of a
``total``-lane pass; a chain is at most ``cfg.max_eye_iters`` hits long.

CUDA tensors launch ``ppm_eye`` of ``csrc/ppm_kernels.cu`` (on a textured
scene its textured instance, ``ppm_eye_tex``, which multiplies the texel
into a textured triangle's base color) or raise.  CPU tensors, and
``plain=True`` (PPM's ``plain`` tier), take ``ppm_eye_plain``: the same
loop in PyTorch over the nearest-hit and Threefry wrappers, or over their
plain versions given ``plain=True``; given a ``counts`` dict
(``new_counts``) it walks on the plain nearest hit and counts the kernel's
work (``COUNT_NAMES``).  Each call counts ``ppm.eye_kernel`` or
``ppm.eye_plain`` (``profiling.count``); ``occupancy`` reports both
instances' resident blocks, registers and spills.  ``eye_pass_bits`` lays
an eye pass's outputs out as 32-bit words, one row a pixel, for the
bit-for-bit comparisons.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..profiling import count, span
from ..scene.camera import primary_ray_dirs
from ..scene.types import Material
from . import _kernels, rng
from .bsdf import bsdf_sample
from .cuda_intersect import (PackedScene, atlas_args, camera_table,
                             check_tables, check_tensor, nearest_hit,
                             nearest_hit_plain, table_args)
from .intersect import packed_hit
from .math3 import EPSILON, clamp_radiance, dot, is_valid_color

JITTER_STREAM, ITER_STREAM = 0x9E1, 0x9E2
# The plain loop's counts of the kernel's work: the walk's sphere, box and
# triangle tests (in the kernel's cluster order), the pixels, the chain
# links (each a walk), the BSDF samples (one a delta link: a rough surface
# ends the chain unsampled), the draws (two jitter draws a pixel, three a
# sample), the hitpoints deposited, and ``iteration_keys``, the iterations
# any pixel sampled in (the distinct fold_in keys, which a bound charges
# once each, as the kernel's per-lane fold_in is not the algorithm's).
COUNT_NAMES = ("hit_spheres", "hit_boxes", "hit_tris", "pixels", "links",
               "bsdf_samples", "draws", "deposits", "iteration_keys")


@dataclass
class HitPoints:
    """The eye pass's hitpoints (B, ...): where the delta chain of each
    pixel first met a rough surface, with the direction back along the
    chain, the surface's material and the chain's throughput."""

    pos: torch.Tensor
    normal: torch.Tensor
    wo: torch.Tensor
    mtl: Material
    throughput: torch.Tensor
    valid: torch.Tensor


def eye_pass_bits(res) -> torch.Tensor:
    """An eye pass's direct term and hitpoint record, one row of 32-bit
    words a pixel."""
    direct, hp = res
    return torch.cat([direct, hp.pos, hp.normal, hp.wo, hp.mtl.base_color,
                      hp.mtl.roughness[:, None], hp.mtl.metallic[:, None],
                      hp.mtl.eta[:, None], hp.throughput,
                      hp.valid.float()[:, None]], dim=1).view(torch.int32)


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES}


def ppm_eye_plain(packed: PackedScene, cam, cfg, px, py, key, start: int = 0,
                  total: int | None = None, plain: bool = False,
                  counts: dict | None = None):
    """Plain PyTorch version of the ``ppm_eye`` kernel: the delta chase as
    a loop over every lane, one host read an iteration.  ``plain`` runs
    the plain nearest hit and Threefry; ``counts`` (``new_counts``), if
    given, gains the kernel's work, its walks counted by the plain nearest
    hit."""
    _kernels.plain_calls["ppm_eye"] += 1
    nearest = nearest_hit_plain if plain else nearest_hit
    if counts is not None:
        nearest = functools.partial(nearest_hit_plain, counts=counts)
        counts["pixels"] += px.shape[0]
        counts["draws"] += 2 * px.shape[0]
    draw = rng.uniform_rows_plain if plain else rng.uniform_rows
    dev = px.device
    B = px.shape[0]
    f32 = dict(device=dev, dtype=torch.float32)
    j = draw(rng.fold_in(key, JITTER_STREAM), B, 2, start, total, device=dev)
    rd = primary_ray_dirs(cam, px, py, j[0], j[1])
    ro = cam.eye[None].expand(B, 3).contiguous()
    tp = torch.ones((B, 3), **f32)
    eta = torch.ones(B, **f32)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    direct = torch.zeros((B, 3), **f32)
    z3, z1 = torch.zeros((B, 3), **f32), torch.zeros(B, **f32)
    hp = HitPoints(pos=z3, normal=z3, wo=z3,
                   mtl=Material(base_color=z3, roughness=z1, metallic=z1,
                                eta=z1),
                   throughput=z3,
                   valid=torch.zeros(B, dtype=torch.bool, device=dev))
    k_it = rng.fold_in(key, ITER_STREAM)
    for it in range(cfg.max_eye_iters):
        with span("sync.ppm_eye_loop"):
            more = bool(alive.any())
        if not more:   # a dead chain stays dead
            break
        u = draw(rng.iter_key(k_it, it), B, 3, start, total, device=dev)
        # textured: the hitpoint keeps the texel in its base color
        hit = packed_hit(packed, ro, rd, alive, nearest)
        act = alive & hit.hit
        wo = -rd
        m, n = hit.mtl, hit.normal

        # a light ball at the end of a delta chain: assigned, not added
        light_hit = act & hit.is_light
        contrib = tp * m.base_color
        contrib = torch.where(is_valid_color(contrib)[:, None],
                              clamp_radiance(contrib, cfg.clamp),
                              torch.zeros_like(contrib))
        direct = torch.where(light_hit[:, None], contrib, direct)

        s = bsdf_sample(m, wo, n, u[0], u[1], u[2], eta)
        surf = act & ~hit.is_light
        delta = surf & s.is_delta & (s.pdf > 0.0)
        deposit = surf & ~s.is_delta
        if counts is not None:
            n_sampled = int((surf & s.is_delta).sum())
            counts["links"] += int(alive.sum())
            counts["bsdf_samples"] += n_sampled
            counts["draws"] += 3 * n_sampled
            counts["deposits"] += int(deposit.sum())
            counts["iteration_keys"] += int(n_sampled > 0)
        d3 = deposit[:, None]
        hp = HitPoints(
            pos=torch.where(d3, hit.pos, hp.pos),
            normal=torch.where(d3, n, hp.normal),
            wo=torch.where(d3, wo, hp.wo),
            mtl=Material(
                base_color=torch.where(d3, m.base_color, hp.mtl.base_color),
                roughness=torch.where(deposit, m.roughness, hp.mtl.roughness),
                metallic=torch.where(deposit, m.metallic, hp.mtl.metallic),
                eta=torch.where(deposit, m.eta, hp.mtl.eta)),
            throughput=torch.where(d3, tp, hp.throughput),
            valid=hp.valid | deposit)

        new_tp = tp * s.value
        off = torch.where((dot(s.wi, n) < 0.0)[:, None], -n, n) * EPSILON
        up = delta[:, None]
        ro = torch.where(up, hit.pos + off, ro)
        rd = torch.where(up, s.wi, rd)
        tp = torch.where(up, new_tp, tp)
        eta = torch.where(delta, s.new_eta, eta)
        alive = delta & is_valid_color(new_tp)
    return direct, hp


def ppm_eye(packed: PackedScene, cam, cfg, px, py, key, start: int = 0,
            total: int | None = None, plain: bool = False):
    """The eye pass of pixels ``px``, ``py`` (B,) from the pass's eye key
    ``key`` (a host tensor: its fold_ins run on the host, with no device
    round trip): (direct (B, 3), HitPoints).  ``start``/``total``: the
    lanes are columns [start, start + B) of a ``total``-lane pass."""
    if plain or px.device.type == "cpu":
        count("ppm.eye_plain")
        return ppm_eye_plain(packed, cam, cfg, px, py, key, start, total,
                             plain)
    out = _launch(packed, cam, cfg, px, py, key, start, total)
    count("ppm.eye_kernel")
    return out


def _launch(packed, cam, cfg, px, py, key, start, total):
    B = px.shape[0]
    total = B if total is None else total
    if 3 * total >= 2 ** 32 or start < 0 or start + B > total:
        raise ValueError(f"ppm_eye: lanes [{start}, {start + B}) of a "
                         f"{total}-lane pass do not fit the 32-bit Threefry "
                         "counters")
    for arg, x in (("px", px), ("py", py)):
        check_tensor(arg, x, (B,), torch.int32)
    check_tables(packed, px.device)
    cam_tab = camera_table(cam, px.device)
    dev = px.device
    direct, pos, normal, wo, bc, tp = (torch.empty((B, 3), device=dev)
                                       for _ in range(6))
    rough, metal, eta = (torch.empty(B, device=dev) for _ in range(3))
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        j0, j1 = (int(w) for w in rng.fold_in(key, JITTER_STREAM).tolist())
        i0, i1 = (int(w) for w in rng.fold_in(key, ITER_STREAM).tolist())
        name = "ppm_eye_tex" if packed.textured else "ppm_eye"
        _kernels.launch(
            name, *table_args(packed),
            *(atlas_args(packed) if packed.textured else ()),
            *(ctypes.c_void_p(x.data_ptr()) for x in (cam_tab, px, py)),
            B, j0, j1, i0, i1, start, total, int(cfg.max_eye_iters),
            float(cfg.clamp),
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                direct, pos, normal, wo, bc, rough, metal, eta, tp, valid)))
    return direct, HitPoints(
        pos=pos, normal=normal, wo=wo,
        mtl=Material(base_color=bc, roughness=rough, metallic=metal, eta=eta),
        throughput=tp, valid=valid)


OCCUPANCY_KERNELS = ("ppm_eye", "ppm_eye_tex")


def occupancy() -> dict:
    """Per instance of ``ppm_eye`` (the flat walk's): resident blocks and
    warps per SM, threads per block, registers and local (spill) bytes per
    thread, shared bytes."""
    out = (ctypes.c_int * (5 * len(OCCUPANCY_KERNELS)))()
    fn = _kernels.library().libs["ppm_kernels"].pt_ppm_eye_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_ppm_eye_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(OCCUPANCY_KERNELS, out)
