"""The PPM photon-trace kernel (counterpart of
``path_tracing_tpu.ops.pallas_photon.photon_trace_pallas``).

``photon_trace`` (#10) bounces ``P`` photons from their sampled emission and
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
deposit and the BSDF sample, as the XLA scan textures it.
``photon_trace_plain`` is the kernel's plain version, the same loop in
PyTorch.
"""
from __future__ import annotations

import torch

from . import rng
from .bsdf import bsdf_sample
from .cuda_intersect import PackedScene
from .intersect import packed_hit
from .math3 import EPSILON, dot, is_valid_color

EV_COLS = 12      # pos3 normal3 wi3 flux3
PHOTON_STREAM = 0x408


def event_slots(light_depth: int, iters: int) -> int:
    """Deposit slots per photon: a photon deposits at most once per depth
    below ``light_depth``, and at most once per bounce."""
    return max(1, min(int(light_depth), int(iters)))


def photon_trace_plain(packed: PackedScene, ro, rd, flux, real, key,
                       light_depth: int, iters: int, start: int = 0,
                       total: int | None = None):
    """Plain PyTorch version of the ``photon_trace`` kernel: the XLA scan's
    bounce loop on the plain nearest hit and Threefry, writing each deposit
    at its depth slot.  Returns (events (slots * P, 12), valid)."""
    P = ro.shape[0]
    dev = ro.device
    slots = event_slots(light_depth, iters)
    ev = torch.zeros((slots * P, EV_COLS), device=dev)
    valid = torch.zeros(slots * P, dtype=torch.bool, device=dev)
    lanes = torch.arange(P, device=dev)
    eta = torch.ones(P, device=dev)
    dep = torch.zeros(P, dtype=torch.int64, device=dev)
    alive = real.clone()
    k_it = rng.fold_in(key, PHOTON_STREAM)
    for it in range(iters):
        if not bool(alive.any()):   # a dead photon stays dead
            break
        u = rng.uniform_rows_plain(rng.iter_key(k_it, it), P, 3, start, total,
                                   device=dev)
        hit = packed_hit(packed, ro, rd, alive)
        m, n = hit.mtl, hit.normal
        act = alive & hit.hit & ~hit.is_light & (dep < light_depth)
        wi_light = -rd
        deposit = act & (m.eta <= 0.0) & ((m.metallic < 0.99)
                                          | (m.roughness > 0.01))
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
    return ev, valid


