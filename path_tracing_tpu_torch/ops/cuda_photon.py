"""The PPM photon-trace kernel (counterpart of
``path_tracing_tpu.ops.pallas_photon.photon_trace_pallas``).

``photon_trace`` bounces ``P`` photons from their sampled emission and
returns their deposit events, depth-slotted: row ``dep * P + lane`` of an
``(slots * P, 12)`` float32 table ``[pos3, normal3, wi3, flux3]`` with
``slots = min(light_depth, iters)``, and a ``(slots * P,)`` bool valid
flag.  A deposit is a non-delta bounce, which raises the photon's depth,
so a photon deposits at most once per depth and no row has two writers.
Rows whose flag is False carry no event.

Bounce ``it`` draws rows 0-2 of ``iter_key(fold_in(key, 0x408), it)`` at
the photon's lane, as the JAX package's XLA scan draws them
(``PT_TPU_NO_PHOTON_MEGA=1``), so the events are the scan's (which writes
them per iteration instead of per depth).  The TPU kernel drew from its
on-core PRNG instead and agreed with the scan only in distribution.

On a textured scene the hit is the ``with_uv`` one with the bilinear
texel multiplied into a textured triangle's base color before the
deposit and the BSDF sample, as the XLA scan textures it (through
``find_closest_hit``); the TPU kernel did not (it has no texture code).

CUDA tensors launch ``photon_trace`` of ``csrc/ppm_kernels.cu`` (on a
textured scene its textured instance, ``photon_trace_tex``) or raise:
persistent threads, each tracing one photon at a time and taking the next
index from a global counter (the wrapper zeroes it); a photon keeps its
own index, so its draws and event rows do not depend on the thread.  CPU
tensors take ``photon_trace_plain``, the same loop in PyTorch; given a
``counts`` dict (``new_counts``) it counts the kernel's work
(``PLAIN_COUNTS``: the walk's tests in the kernel's cluster order).
``photon_trace_counts`` launches the kernel's counting build, which
returns the same events and the work it did (``COUNT_NAMES``);
``occupancy`` reports both builds' resident blocks, registers and spills.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels, rng
from .bsdf import bsdf_sample
from .cuda_connect import COUNT_NAMES as _WALK_NAMES
from .cuda_intersect import (PackedScene, atlas_args, check_tables,
                             check_tensor, nearest_hit_plain, table_args)
from .intersect import packed_hit
from .math3 import EPSILON, dot, is_valid_color

EV_COLS = 12      # pos3 normal3 wi3 flux3
PHOTON_STREAM = 0x408
# The counting build's counters: those of the BDPT kernels
# (``cuda_connect.COUNT_NAMES``, of which #10 fills the walk's sphere, box
# and triangle tests), then the photons started, the bounces (each a
# nearest-hit walk), the BSDF samples, the draws (3 a sample), the
# deposits, the lanes and slots of the bounce step (its SIMT efficiency)
# and 32 times each warp's most bounces in one lane (bounces over it: the
# share a warp's lanes are busy).  The plain version counts
# ``PLAIN_COUNTS`` and ``PLAIN_ONLY``: ``photon_warp_slots``, the last for
# one thread per photon in warps of 32 consecutive photons (the design
# before work stealing), and ``iteration_keys``, the iterations any photon
# sampled in (the distinct fold_in keys, which the bound charges once
# each).
COUNT_NAMES = _WALK_NAMES + (
    "photons", "bounces", "bsdf_samples", "draws", "deposits",
    "bounce_lanes", "bounce_slots", "warp_bounce_slots")
PLAIN_COUNTS = ("hit_spheres", "hit_boxes", "hit_tris", "photons",
                "bounces", "bsdf_samples", "draws", "deposits")
PLAIN_ONLY = ("photon_warp_slots", "iteration_keys")


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES + PLAIN_ONLY}


def event_slots(light_depth: int, iters: int) -> int:
    """Deposit slots per photon: a photon deposits at most once per depth
    below ``light_depth``, and at most once per bounce."""
    return max(1, min(int(light_depth), int(iters)))


def photon_trace_plain(packed: PackedScene, ro, rd, flux, real, key,
                       light_depth: int, iters: int, start: int = 0,
                       total: int | None = None,
                       counts: dict | None = None):
    """Plain PyTorch version of the ``photon_trace`` kernel: the XLA scan's
    bounce loop on the plain nearest hit and Threefry, writing each deposit
    at its depth slot.  Returns (events (slots * P, 12), valid).
    ``counts`` (from ``new_counts``), if given, gains the kernel's work
    (``PLAIN_COUNTS`` and ``PLAIN_ONLY``)."""
    _kernels.plain_calls["photon_trace"] += 1
    P = ro.shape[0]
    dev = ro.device
    slots = event_slots(light_depth, iters)
    ev = torch.zeros((slots * P, EV_COLS), device=dev)
    valid = torch.zeros(slots * P, dtype=torch.bool, device=dev)
    lanes = torch.arange(P, device=dev)
    eta = torch.ones(P, device=dev)
    dep = torch.zeros(P, dtype=torch.int64, device=dev)
    alive = real.clone()
    if counts is not None:
        counts["photons"] += int(real.sum())
        bounces = torch.zeros(P, dtype=torch.int64, device=dev)  # a photon's
    k_it = rng.fold_in(key, PHOTON_STREAM)
    for it in range(iters):
        if not bool(alive.any()):   # a dead photon stays dead
            break
        u = rng.uniform_rows_plain(rng.iter_key(k_it, it), P, 3, start, total,
                                   device=dev)
        hit = packed_hit(packed, ro, rd, alive, functools.partial(
            nearest_hit_plain, counts=counts))
        m, n = hit.mtl, hit.normal
        act = alive & hit.hit & ~hit.is_light & (dep < light_depth)
        wi_light = -rd
        deposit = act & (m.eta <= 0.0) & ((m.metallic < 0.99)
                                          | (m.roughness > 0.01))
        if counts is not None:
            bounces += alive
            n_act = int(act.sum())
            counts["bounces"] += int(alive.sum())
            counts["bsdf_samples"] += n_act
            counts["draws"] += 3 * n_act
            counts["deposits"] += int(deposit.sum())
            counts["iteration_keys"] += int(n_act > 0)
        lane = lanes[deposit]
        row = dep[lane] * P + lane
        ev[row] = torch.cat([hit.pos, n, wi_light, flux], dim=1)[lane]
        valid[row] = True

        s = bsdf_sample(m, wi_light, n, u[0], u[1], u[2], eta)
        ok = act & (s.pdf > 0.0)   # the photon pass kills pdf <= 0 deltas
        w = torch.where(s.is_delta, torch.ones_like(s.pdf),
                        torch.abs(dot(n, s.wi))
                        / torch.clamp(s.pdf, min=1e-20))
        new_flux = flux * s.value * w[:, None]
        off = torch.where((dot(s.wi, n) < 0.0)[:, None], -n, n) * EPSILON
        up = ok[:, None]
        ro = torch.where(up, hit.pos + off, ro)
        rd = torch.where(up, s.wi, rd)
        flux = torch.where(up, new_flux, flux)
        eta = torch.where(ok, s.new_eta, eta)
        dep = dep + (~s.is_delta).long()
        alive = ok & is_valid_color(new_flux)
    if counts is not None:
        warps = torch.nn.functional.pad(bounces, (0, (-P) % 32))
        counts["photon_warp_slots"] += 32 * int(warps.view(-1, 32).amax(1)
                                                .sum())
    return ev, valid


def photon_trace(packed: PackedScene, ro, rd, flux, real, key,
                 light_depth: int, iters: int, start: int = 0,
                 total: int | None = None):
    """Deposit events of photons ``ro``, ``rd``, ``flux`` (P, 3) float32
    with ``real`` (P,) bool (lanes that exist), bounced at most ``iters``
    times from ``key`` (the pass's photon key, a host tensor: its fold_in
    runs on the host, with no device round trip).  ``start``/``total``:
    the photons are columns [start, start + P) of a ``total``-photon pass.
    Returns (events (slots * P, 12) float32, valid (slots * P,) bool)."""
    if ro.device.type == "cpu":
        return photon_trace_plain(packed, ro, rd, flux, real, key,
                                  light_depth, iters, start, total)
    return _launch("photon_trace_tex" if packed.textured else "photon_trace",
                   packed, ro, rd, flux, real, key, light_depth, iters,
                   start, total)[:2]


def photon_trace_counts(packed: PackedScene, ro, rd, flux, real, key,
                        light_depth: int, iters: int, start: int = 0,
                        total: int | None = None) -> tuple:
    """``photon_trace`` through the kernel's counting build: (the same
    events, valid, the counters as a dict keyed by ``COUNT_NAMES``).  CUDA
    tensors only; untextured scenes only (the textured instance has no
    counting build)."""
    if packed.textured:
        raise ValueError("photon_trace_counts: no counting build of the "
                         "textured instance")
    return _launch("photon_trace_counts", packed, ro, rd, flux, real, key,
                   light_depth, iters, start, total)


def _launch(name, packed, ro, rd, flux, real, key, light_depth, iters,
            start, total):
    P = ro.shape[0]
    total = P if total is None else total
    if 3 * total >= 2 ** 32 or start < 0 or start + P > total:
        raise ValueError(f"photon_trace: photons [{start}, {start + P}) of a "
                         f"{total}-photon pass do not fit the 32-bit "
                         "Threefry counters")
    for arg, x in (("ro", ro), ("rd", rd), ("flux", flux)):
        check_tensor(arg, x, (P, 3))
    check_tensor("real", real, (P,), torch.bool)
    check_tables(packed, ro.device)
    slots = event_slots(light_depth, iters)
    ev = torch.empty((slots * P, EV_COLS), device=ro.device)
    valid = torch.zeros(slots * P, dtype=torch.bool, device=ro.device)
    work = torch.zeros(1, dtype=torch.int32, device=ro.device)
    counted = name.endswith("_counts")
    buf = (torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=ro.device)
           if counted else None)
    if P:
        k0, k1 = (int(w) for w in rng.fold_in(key, PHOTON_STREAM).tolist())
        _kernels.launch(
            name, *table_args(packed),
            *(atlas_args(packed) if name == "photon_trace_tex" else ()),
            *(ctypes.c_void_p(x.data_ptr()) for x in (ro, rd, flux, real)),
            P, k0, k1, start, total, int(light_depth), int(iters),
            *(ctypes.c_void_p(x.data_ptr()) for x in (work, ev, valid)),
            *([ctypes.c_void_p(buf.data_ptr())] if counted else []))
    counts = (dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))
              if counted else None)
    return ev, valid, counts


OCCUPANCY_KERNELS = ("photon_trace", "photon_trace_counts")


def occupancy() -> dict:
    """Per build of #10: resident blocks and warps per SM, threads per
    block, registers and local (spill) bytes per thread, shared bytes."""
    out = (ctypes.c_int * (5 * len(OCCUPANCY_KERNELS)))()
    fn = _kernels.library().libs["ppm_kernels"].pt_photon_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_photon_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(OCCUPANCY_KERNELS, out)
