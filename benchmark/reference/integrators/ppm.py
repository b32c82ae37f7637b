"""Progressive photon mapping with the exact cell-sorted gather
(``path_tracing_tpu.integrators.ppm``).

One pass:

1. the eye pass (``ppm_eye_trace``) follows each pixel's delta chain
   (perfect mirrors and glass) from a jittered camera ray, stores a
   hitpoint at the first rough surface and assigns (does not add) the
   radiance of a light ball the chain reaches;
2. the photon pass (``ppm_photon_trace``) emits ``Nl * spl`` photons, photon
   ``i`` from light ``i % Nl`` with flux ``illum * Nl / spl`` (the
   reference's Nl-times flux, kept as the JAX package keeps it), and
   records their deposits on depositable surfaces (eta <= 0 and not a
   smooth conductor) at most ``light_depth`` non-delta bounces deep;
3. the gather (``ops/cuda_ppm_gather.py``) sums, per hitpoint, every event
   within the radius whose normal agrees, weighted by the hitpoint's BRDF;
4. the image is the direct term plus ``flux / (pi r^2 r2_scale)`` on valid
   hitpoints, clamped at ``cfg.clamp``.

The radius may shrink from pass to pass (``ppm_radius_scale``); progressive
accumulation is the caller's average over passes.

This copy keeps the plain versions of the main path: the eye pass on the
plain nearest hit and Threefry (the program runs it around #1), the
photon bounces of ``photon_trace`` (#10) and the exact join of
``gather_flux`` (#11).  The random numbers are the JAX package's Threefry streams: the eye pass
draws its jitter from ``fold_in(key, 0x9E1)`` and bounce ``it`` from
``iter_key(fold_in(key, 0x9E2), it)``; emission from ``fold_in(key,
0x407)``; photon bounces as ``ops/cuda_photon.py`` says.  A pass renders
from ``fold_in(frame_key, 1)`` (eye) and ``fold_in(frame_key, 2)``
(photons), as the JAX package's does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import bsdf_sample
from ..ops.cuda_intersect import nearest_hit_plain, pack_scene
from ..ops.cuda_photon import photon_trace_plain
from ..ops.intersect import packed_hit
from ..ops.math3 import EPSILON, PI, clamp_radiance, dot, is_valid_color
from ..ops.sampling import sample_light_emission
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Material, Scene

# hitpoints a step of the hash gather takes at once: bounds its (n, 27, 12)
# candidate block (at 512^2 all of them at once would be 340 MB a step)
HASH_CHUNK = 1 << 16


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


@dataclass
class PhotonEvents:
    """Photon deposits: rows ``[pos3, normal3, wi3, flux3]`` (E, 12) with
    ``wi`` toward the light, and their valid flags (E,)."""

    table: torch.Tensor
    valid: torch.Tensor

    @property
    def pos(self):
        return self.table[:, 0:3]


def ppm_eye_trace(scene: Scene, cam: Camera, cfg: RenderConfig, px, py, key,
                  start: int = 0, total: int | None = None):
    """Delta-chase eye pass -> (direct image (B, 3), HitPoints).
    ``start``/``total``: these lanes are columns [start, start + B) of a
    ``total``-lane pass."""
    nearest = nearest_hit_plain
    draw = rng.uniform_rows_plain
    packed = pack_scene(scene)
    dev = px.device
    B = px.shape[0]
    f32 = dict(device=dev, dtype=torch.float32)
    j = draw(rng.fold_in(key, 0x9E1), B, 2, start, total, device=dev)
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
    k_it = rng.fold_in(key, 0x9E2)
    for it in range(cfg.max_eye_iters):
        if not bool(alive.any()):   # a dead chain stays dead
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


def photon_emission(scene: Scene, num_photons: int, spl: int, key,
                    start: int = 0, total: int | None = None):
    """The photons of a pass: (origins, directions, flux (P, 3), real (P,)).
    Photon ``i`` is global photon ``start + i`` of a ``total``-photon pass
    and comes from light ``(start + i) % Nl``; photons past ``total`` are
    not real."""
    draw = rng.uniform_rows_plain
    dev = scene.device
    P = num_photons
    nl = scene.num_lights
    gi = start + torch.arange(P, device=dev)
    li = gi % nl
    real = (torch.ones(P, dtype=torch.bool, device=dev) if total is None
            else gi < total)
    u = draw(rng.fold_in(key, 0x407), P, 2, start, total, device=dev)
    emit = sample_light_emission(
        scene.light_pos[li], scene.light_dir[li], scene.light_cutoff[li],
        scene.light_is_parallel[li], scene.light_ball_r[li], scene.scene_min,
        scene.scene_max, u[0], u[1])
    flux0 = scene.light_illum[li] * (float(nl) / max(float(spl), 1.0))
    return (emit.origin.contiguous(), emit.direction.contiguous(),
            flux0.contiguous(), real)


def ppm_photon_trace(scene: Scene, cfg: RenderConfig, num_photons: int,
                     spl: int, key, start: int = 0, total: int | None = None
                     ) -> PhotonEvents:
    """The photon pass: emission, then the bounces of ``photon_trace``'s
    plain version, recording depth-slotted deposit events."""
    ro, rd, flux0, real = photon_emission(scene, num_photons, spl, key,
                                          start, total)
    ev, valid = photon_trace_plain(pack_scene(scene), ro, rd, flux0, real,
                                   key, cfg.light_depth, cfg.max_light_iters,
                                   start, total)
    return PhotonEvents(ev, valid)


def ppm_radius_scale(pass_index: int, alpha: float) -> float:
    """Progressive radius: r_i^2 = r_0^2 prod_{k=1..i} (k + alpha) / (k + 1);
    alpha <= 0 or pass 0 keeps the fixed radius (1.0)."""
    if alpha <= 0.0 or pass_index <= 0:
        return 1.0
    scale = 1.0
    for k in range(1, pass_index + 1):
        scale *= (k + alpha) / (k + 1.0)
    return scale


_OFFS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
              for dz in (-1, 0, 1))


def resolve_image(cfg: RenderConfig, direct, hp: HitPoints, flux,
                  r2_scale=1.0) -> torch.Tensor:
    """direct + flux / (pi r^2 r2_scale) on valid hitpoints, clamped."""
    area = (torch.tensor(PI * cfg.ppm_radius * cfg.ppm_radius)
            * torch.tensor(float(r2_scale)))
    radiance = flux / torch.clamp(area, min=1e-6).to(flux.device)
    radiance = torch.where((hp.valid & is_valid_color(radiance))[:, None],
                           clamp_radiance(radiance, cfg.clamp),
                           torch.zeros_like(radiance))
    return direct + radiance


