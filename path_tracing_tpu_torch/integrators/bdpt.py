"""Bidirectional path tracing with balance-heuristic MIS
(``path_tracing_tpu.integrators.bdpt``).

Semantics kept from the reference, as the JAX package keeps them:

- light subpaths: vertex 0 is the emitter sample; a bounce stores a vertex
  only for a non-delta scatter; a hit on a light ball stores a terminal
  light vertex; delta bounces spend no slot and no depth
  (``cfg.delta_budget`` bounds them); vertices with |throughput| < 1e-6
  never connect;
- MIS is O(1) per connection: the light-side ratio walk is the per-vertex
  factor ``mis_a`` precomputed after tracing, the eye side a scalar ``G``
  carried along the eye path, with the reference's 1e8 eye-side prefactor
  (the current eye vertex's forward pdf is still its 0 placeholder,
  clamped to 1e-8);
- every eye vertex connects to every valid light vertex (the exact
  all-pairs sweep), or to K of them drawn by resampled importance sampling
  (``cfg.bdpt_resample_vertices``), whose weights keep the estimate
  unbiased;
- GPU-parity flux scaling (``render_bdpt``) and the CPU oracle's flags
  (``render_oracle``).

Tiers (``resolve_tier``), as the JAX package picks its paths:

- ``mega``: one ``bdpt_eye`` kernel launch per frame runs every sample of
  a pixel in one thread (``ops/cuda_bdpt_eye.py``), against the compacted
  table or, with K > 0, against tile-local RIS tables (one per 16,384
  consecutive pixels);
- ``fused``: a Python loop over samples and bounces that launches the
  nearest-hit kernel, the ``connect`` kernel and the Threefry table kernel
  per bounce, with the bounce in PyTorch; K > 0 redraws one global RIS
  table per sample;
- ``plain``: the same loop on the plain versions.

Textured and legacy-Ks scenes and sampled connections
(``cfg.bdpt_connection_samples`` = M > 0) take the fused tier, as the
JAX package keeps them off its megakernel: the light trace and the eye
pass take the textured hit (``ops/intersect.py::packed_hit``), so light
vertices and eye vertices carry the texel in their base color; a
legacy-Ks scene's connections launch #8's RGB instance (``connect_rgb``,
the RGB shadow of ``shadow_factor``; the oracle's rule stays binary), and
M > 0 its sampled instance (``connect_sampled``: each eye vertex against
M stratified rows, scaled by ``n_valid / M``).

Meshes of any size take these routes: from 64 clusters on, #9, #8's
shadow rays and #1 walk the super-cluster table (above the TPU's
``MAX_RESIDENT_TRIS`` the JAX package streams the mesh through #6/#7
instead, with the same hits).

``mega`` draws in the kernel the very numbers the per-bounce loop draws
from the global Threefry counters, so with a shared table its image is the
fused tier's.  On CPU tensors every kernel runs its plain version.  The
light subpaths are traced in PyTorch around the nearest-hit and Threefry
kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import bsdf_pdf, bsdf_sample
from ..ops.cuda_bdpt_eye import TILE_LANES, bdpt_eye, eye_tiling
from ..ops.cuda_connect import (connect, connect_plain, pack_light_vertices,
                                sample_rows)
from ..ops.cuda_intersect import (PackedScene, nearest_hit,
                                  nearest_hit_plain, pack_scene)
from ..ops.intersect import packed_hit
from ..ops.math3 import EPSILON, PI, dot, is_valid_color, length, normalize
from ..ops.sampling import sample_light_emission
from ..profiling import span
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Material, Scene

PDF_FWD_FLOOR = 1e-8   # the fmaxf clamp of both MIS walks
RIS_DEFENSIVE = 0.5    # uniform share of the RIS proposal mixture
LUMA = (0.2126, 0.7152, 0.0722)
TIERS = ("auto", "mega", "fused", "plain")


@dataclass
class LightVertices:
    """Light-subpath vertices, ``(P, L, ...)`` (or flat ``(V, ...)``):
    position, normal, throughput, material, stored pdfs, the emitter
    flags, the owning light's direction (for the cone gate), ``wo`` (the
    emission direction at vertex 0, else the unit direction to the
    previous stored vertex), the light-side MIS factor and validity."""

    pos: torch.Tensor
    normal: torch.Tensor
    throughput: torch.Tensor
    mtl: Material
    pdf_fwd: torch.Tensor
    pdf_rev: torch.Tensor
    is_light_source: torch.Tensor
    source_cutoff: torch.Tensor
    is_parallel: torch.Tensor
    emit_dir: torch.Tensor
    wo: torch.Tensor
    mis_a: torch.Tensor
    valid: torch.Tensor

    def map(self, fn) -> "LightVertices":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = (Material(**{g.name: fn(getattr(v, g.name))
                                      for g in dataclasses.fields(v)})
                          if isinstance(v, Material) else fn(v))
        return LightVertices(**kw)

    def flat(self) -> "LightVertices":
        return self.map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])))

    def take(self, idx: torch.Tensor) -> "LightVertices":
        return self.map(lambda x: x[idx])


def resolve_tier(scene: Scene, tier: str, cfg: RenderConfig) -> str:
    """The BDPT tier that renders ``scene`` when ``tier`` is asked for:
    "auto" is "mega", at any triangle count (#9 on the resident super
    walk; "fused" runs #1 and #8 on it), or "fused" for a textured or
    legacy-Ks scene or sampled connections (``bdpt_connection_samples`` >
    0), which the JAX package keeps off its megakernel too.  Raises
    ValueError for a tier BDPT does not have and for "mega" on those."""
    if tier not in TIERS:
        raise ValueError(f"BDPT has no tier {tier!r}; expected one of "
                         f"{TIERS}")
    if (scene.has_textures or scene.has_legacy_ks
            or cfg.bdpt_connection_samples > 0):
        if tier == "mega":
            raise ValueError(
                "tier 'mega' does not render textured or legacy-Ks scenes "
                "or sampled connections (the eye megakernel is gated off "
                "them, as on the TPU); use 'auto' or 'fused'")
        return "fused" if tier == "auto" else tier
    return "mega" if tier == "auto" else tier


def trace_light_paths(scene: Scene, cfg: RenderConfig, num_paths: int,
                      spl: int, key, start: int = 0,
                      total: int | None = None,
                      plain: bool = False) -> LightVertices:
    """Trace ``num_paths`` light subpaths (global path ``i`` uses light
    ``i % Nl``) into a (P, L) vertex tensor, ``L = cfg.light_depth``.
    ``start``/``total``: these paths are rows [start, start + P) of a
    ``total``-path trace and draw its Threefry counters.  ``plain`` runs
    the plain nearest-hit and Threefry versions (the plain tier)."""
    nearest = nearest_hit_plain if plain else nearest_hit
    draw = rng.uniform_rows_plain if plain else rng.uniform_rows
    P, L = num_paths, cfg.light_depth
    dev = scene.device
    f32 = dict(device=dev, dtype=torch.float32)
    packed = pack_scene(scene)
    gi = start + torch.arange(P, device=dev)
    li = gi % scene.num_lights
    real = (torch.ones(P, dtype=torch.bool, device=dev) if total is None
            else gi < total)

    u = draw(rng.fold_in(key, 0xE817), P, 2, start, total, device=dev)
    emit = sample_light_emission(
        scene.light_pos[li], scene.light_dir[li], scene.light_cutoff[li],
        scene.light_is_parallel[li], scene.light_ball_r[li], scene.scene_min,
        scene.scene_max, u[0], u[1])
    tp0 = scene.light_illum[li] / max(float(spl), 1.0)

    lv = LightVertices(
        pos=torch.zeros(P, L, 3, **f32), normal=torch.zeros(P, L, 3, **f32),
        throughput=torch.zeros(P, L, 3, **f32),
        mtl=Material(base_color=torch.zeros(P, L, 3, **f32),
                     roughness=torch.zeros(P, L, **f32),
                     metallic=torch.zeros(P, L, **f32),
                     eta=torch.zeros(P, L, **f32)),
        pdf_fwd=torch.zeros(P, L, **f32), pdf_rev=torch.zeros(P, L, **f32),
        is_light_source=torch.zeros(P, L, dtype=torch.bool, device=dev),
        source_cutoff=torch.zeros(P, L, **f32),
        is_parallel=torch.zeros(P, L, dtype=torch.bool, device=dev),
        emit_dir=torch.zeros(P, L, 3, **f32), wo=torch.zeros(P, L, 3, **f32),
        mis_a=torch.zeros(P, L, **f32),
        valid=torch.zeros(P, L, dtype=torch.bool, device=dev))
    # vertex 0: the emitter; its normal is the emission direction
    lv.pos[:, 0] = emit.origin
    lv.normal[:, 0] = emit.direction
    lv.throughput[:, 0] = tp0
    lv.is_light_source[:, 0] = True
    lv.source_cutoff[:, 0] = scene.light_cutoff[li]
    lv.is_parallel[:, 0] = scene.light_is_parallel[li] != 0
    lv.emit_dir[:, 0] = normalize(scene.light_dir[li])
    lv.valid[:, 0] = real

    ro, rd, tp = emit.origin, emit.direction, tp0
    eta = torch.ones(P, **f32)
    slot = torch.ones(P, dtype=torch.int64, device=dev)
    alive = real & (L > 1)
    last_n, last_p = emit.direction, emit.origin
    last_pdf = torch.full((P,), 1.0 / PI, **f32)
    k_it = rng.fold_in(key, 0x11F7)
    for it in range(cfg.max_light_iters):
        with span("sync.bdpt_light_loop"):
            more = bool(alive.any())
        if not more:   # later iterations change nothing
            break
        u = draw(rng.iter_key(k_it, it), P, 3, start, total, device=dev)
        # textured: the light vertex keeps the texel in its base color
        hit = packed_hit(packed, ro, rd, alive, nearest)
        act = alive & hit.hit

        # a light-ball hit stores a terminal light vertex; the throughput
        # and distance guards come after that test, as in the reference
        store_light = act & hit.is_light
        d_vec = hit.pos - last_p
        dist2 = dot(d_vec, d_vec)
        ok = act & ~hit.is_light & (length(tp) >= 1e-4) & (dist2 >= 1e-6)
        cos_at_hit = torch.abs(dot(hit.normal, -rd))
        cos_at_prev = torch.abs(dot(last_n, rd))
        pdf_fwd = last_pdf * cos_at_hit / torch.clamp(dist2, min=1e-20)

        wo = -rd
        s = bsdf_sample(hit.mtl, wo, hit.normal, u[0], u[1], u[2], eta)
        sample_ok = (s.pdf > 0.0) | s.is_delta
        store_surf = ok & sample_ok & ~s.is_delta
        delta = ok & sample_ok & s.is_delta
        pdf_rev = (bsdf_pdf(hit.mtl, s.wi, wo, hit.normal) * cos_at_prev
                   / torch.clamp(dist2, min=1e-20))

        # write the stored vertices at (lane, slot); only stored lanes are
        # written, and their slot is below L (alive needs it)
        with span("sync.bdpt_light_store"):
            lane = torch.nonzero(store_light | store_surf)[:, 0]
        at = (lane, slot[lane])
        surf = store_surf[lane]
        zero = torch.zeros_like(pdf_fwd[lane])
        lv.pos[at] = hit.pos[lane]
        lv.normal[at] = hit.normal[lane]
        lv.throughput[at] = tp[lane]
        lv.mtl.base_color[at] = hit.mtl.base_color[lane]
        lv.mtl.roughness[at] = hit.mtl.roughness[lane]
        lv.mtl.metallic[at] = hit.mtl.metallic[lane]
        lv.mtl.eta[at] = hit.mtl.eta[lane]
        lv.pdf_fwd[at] = torch.where(surf, pdf_fwd[lane], zero)
        lv.pdf_rev[at] = torch.where(surf, pdf_rev[lane], zero)
        lv.is_light_source[at] = store_light[lane]
        lv.source_cutoff[at] = zero
        with span("sync.bdpt_light_parallel"):
            lv.is_parallel[at] = False
        lv.wo[at] = wo[lane]
        with span("sync.bdpt_light_valid"):
            lv.valid[at] = True

        # advance
        w = torch.where(s.is_delta, torch.ones_like(s.pdf),
                        torch.abs(dot(hit.normal, s.wi))
                        / torch.clamp(s.pdf, min=1e-20))
        new_tp = tp * s.value * w[:, None]
        off = torch.where((dot(s.wi, hit.normal) < 0.0)[:, None],
                          -hit.normal, hit.normal) * EPSILON
        new_ro = torch.where(delta[:, None], hit.pos + off,
                             hit.pos + hit.normal * EPSILON)
        slot = slot + store_surf.long()
        upd = (delta | store_surf)[:, None]
        alive = torch.where(act, delta | (store_surf & is_valid_color(new_tp)
                                          & (slot < L)),
                            alive & hit.hit)
        ro = torch.where(upd, new_ro, ro)
        rd = torch.where(upd, s.wi, rd)
        tp = torch.where(upd, new_tp, tp)
        eta = torch.where(upd[:, 0], s.new_eta, eta)
        # a delta bounce leaves the previous vertex where it was
        sf = store_surf[:, None]
        last_n = torch.where(sf, hit.normal, last_n)
        last_p = torch.where(sf, hit.pos, last_p)
        last_pdf = torch.where(store_surf, s.pdf, last_pdf)

    lv.valid &= length(lv.throughput) >= 1e-6
    # wo: the emission direction at vertex 0, else toward the previous
    # stored vertex (not the incoming ray, which delta bounces bend)
    to_prev = torch.cat([lv.pos[:, :1], lv.pos[:, :-1]], dim=1) - lv.pos
    to_prev = to_prev / torch.clamp(length(to_prev), min=1e-20)[..., None]
    lv.wo = torch.cat([lv.normal[:, :1], to_prev[:, 1:]], dim=1)
    # light-side MIS factor A: A[0] = 0; emitters 1/pdf_fwd; dielectrics 0
    a = [torch.zeros(P, **f32)]
    for t in range(1, L):
        inv_fwd = 1.0 / torch.clamp(lv.pdf_fwd[:, t], min=PDF_FWD_FLOOR)
        a.append(torch.where(
            lv.is_light_source[:, t], inv_fwd,
            torch.where(lv.mtl.eta[:, t] > 0.0, torch.zeros_like(inv_fwd),
                        inv_fwd * (1.0 + lv.pdf_rev[:, t] * a[t - 1]))))
    lv.mis_a = torch.stack(a, dim=1)
    return lv


def compact_flat(lv_flat: LightVertices):
    """Valid vertices first, in order (a stable sort of ~valid); returns
    (the sorted flat LightVertices, n_valid as an int)."""
    order = torch.argsort((~lv_flat.valid).to(torch.uint8), stable=True)
    with span("sync.bdpt_n_valid"):
        n_valid = int(lv_flat.valid.sum())
    return lv_flat.take(order), n_valid


def _ris_support(lv_flat: LightVertices, n_valid: int):
    """(in_prefix, luminance, contributing rows, the uniform part of the
    proposal) shared by both resamplers: the uniform half of the mixture
    runs over the rows that can contribute (lum > 0), or over the valid
    prefix when none does."""
    V = lv_flat.pos.shape[0]
    dev = lv_flat.pos.device
    in_prefix = torch.arange(V, device=dev) < n_valid
    tp = lv_flat.throughput
    lum = tp[:, 0] * LUMA[0] + tp[:, 1] * LUMA[1] + tp[:, 2] * LUMA[2]
    contrib = in_prefix & lv_flat.valid & (lum > 0.0) & torch.isfinite(lum)
    nc = contrib.sum().to(torch.float32)
    with span("sync.bdpt_ris_nv"):
        nv = torch.tensor(float(max(n_valid, 1)), device=dev)
    zero = torch.zeros_like(lum)
    base = torch.where(contrib, RIS_DEFENSIVE / torch.clamp(nc, min=1.0),
                       zero)
    with span("sync.bdpt_ris_support"):
        any_contrib = bool(nc > 0)
    if not any_contrib:
        base = torch.where(in_prefix, 1.0 / nv, zero)
    return lum, contrib, base


def resample_light_vertices(lv_flat: LightVertices, n_valid: int, K: int,
                            key):
    """Draw ``K`` rows (stratified) with probability ``p_i`` = the
    defensive uniform part plus ``0.5 lum_i / sum lum``, and bake the RIS
    weight ``1 / (K p_i)`` into the throughput, so every connection sum
    over the K rows is an unbiased estimate of the exact sweep.  Returns
    (the resampled flat LightVertices, K)."""
    V = lv_flat.pos.shape[0]
    dev = lv_flat.pos.device
    lum, contrib, base = _ris_support(lv_flat, n_valid)
    w = torch.where(contrib, lum, torch.zeros_like(lum))
    wsum = w.sum()
    p = base + torch.where(wsum > 0.0, (1.0 - RIS_DEFENSIVE) * w
                           / torch.clamp(wsum, min=1e-30),
                           torch.zeros_like(w))
    cdf = torch.cumsum(p, dim=0)
    u = (torch.arange(K, device=dev, dtype=torch.float32)
         + rng.uniform(key, (K,), device=dev)) / K
    idx = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True),
                      0, V - 1)
    out = lv_flat.take(idx)
    scale = 1.0 / (K * torch.clamp(p[idx], min=1e-30))
    out.throughput = out.throughput * scale[:, None]
    return out, K


def tile_representatives(scene: Scene, cam: Camera, px, py,
                         lanes_per_tile: int, n_tiles: int) -> torch.Tensor:
    """(T, 3): where the primary ray through each tile's center pixel
    leaves the scene box, pulled back to 95% of the way (an importance
    heuristic only; unbiasedness never depends on it)."""
    B = px.shape[0]
    mid = torch.clamp(torch.arange(n_tiles, device=px.device)
                      * lanes_per_tile + lanes_per_tile // 2, 0, B - 1)
    h = torch.full((n_tiles,), 0.5, device=px.device)
    rd = primary_ray_dirs(cam, px[mid], py[mid], h, h)
    eye = cam.eye[None].expand_as(rd)
    safe = torch.where(torch.abs(rd) < 1e-12,
                       torch.where(rd >= 0.0, 1e-12, -1e-12), rd)
    t0 = (scene.scene_min[None] - eye) / safe
    t1 = (scene.scene_max[None] - eye) / safe
    t_exit = torch.clamp(torch.amin(torch.maximum(t0, t1), dim=-1), min=1e-3)
    return eye + rd * (0.95 * t_exit)[:, None]


def resample_light_vertices_tiled(lv_flat: LightVertices, n_valid: int,
                                  K: int, key, reps: torch.Tensor):
    """Per-tile RIS: for tile ``t`` the weights are ``lum_i * max(cos_i,
    0.05) / max(dist2_i, 1e-4)`` toward ``reps[t]``, mixed 50/50 with the
    uniform part; K stratified draws per tile with the RIS weight baked
    into the throughput; rows padded per tile to ``Kp``, a multiple of 8,
    with invalid rows.  Returns (flat LightVertices of T * Kp rows, Kp)."""
    T = reps.shape[0]
    V = lv_flat.pos.shape[0]
    dev = lv_flat.pos.device
    lum, contrib, base = _ris_support(lv_flat, n_valid)
    d = reps[:, None, :] - lv_flat.pos[None]                      # (T, V, 3)
    dist2 = dot(d, d)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_l = dot(lv_flat.normal[None], d) / dist
    geom = (torch.clamp(cos_l, min=0.05)
            / torch.clamp(dist2, min=1e-4))
    w = torch.where(contrib[None], lum[None] * geom, torch.zeros_like(geom))
    wsum = w.sum(dim=1, keepdim=True)
    p = base[None] + torch.where(wsum > 0.0, (1.0 - RIS_DEFENSIVE) * w
                                 / torch.clamp(wsum, min=1e-30),
                                 torch.zeros_like(w))
    cdf = torch.cumsum(p, dim=1)
    u = (torch.arange(K, device=dev, dtype=torch.float32)[None]
         + rng.uniform(key, (T, K), device=dev)) / K
    idx = torch.clamp(torch.searchsorted(cdf, u * cdf[:, -1:], right=True),
                      0, V - 1)                                    # (T, K)
    scale = 1.0 / (K * torch.clamp(torch.gather(p, 1, idx), min=1e-30))
    Kp = -(-K // 8) * 8
    if Kp > K:
        idx = torch.cat([idx, torch.zeros((T, Kp - K), dtype=idx.dtype,
                                          device=dev)], dim=1)
        scale = torch.cat([scale, torch.zeros((T, Kp - K), device=dev)],
                          dim=1)
    out = lv_flat.take(idx.reshape(-1))
    sc = scale.reshape(-1)
    out.valid = out.valid & (sc > 0.0)
    out.throughput = out.throughput * sc[:, None]
    return out, Kp


def eye_sample(packed: PackedScene, cam: Camera, cfg: RenderConfig,
               lv_tab: torch.Tensor, n_valid: int, px, py, key,
               light_hit_scale: float, start: int = 0,
               total: int | None = None, *, nearest=nearest_hit,
               connect_fn=connect, draw=rng.uniform_rows) -> torch.Tensor:
    """One eye path per lane from sample key ``key``, connecting at every
    vertex against ``lv_tab``; returns the path's valid radiance (B, 3).
    The bounce loop of the JAX package's ``eye_trace_and_connect``, with
    the nearest-hit, connection and Threefry functions given.  With
    ``cfg.bdpt_connection_samples`` = M > 0 each vertex connects to M
    stratified rows of the table (``sample_rows`` from ``fold_in(k,
    0x5E1)``, ``k`` the bounce's key), as its ``_connect_sampled``."""
    dev = px.device
    B = px.shape[0]
    f32 = dict(device=dev, dtype=torch.float32)
    blocks = cfg.shadow_dielectrics_block
    j = draw(rng.fold_in(key, 0xA11CE), B, 2, start, total, device=dev)
    rd = primary_ray_dirs(cam, px, py, j[0], j[1])
    eye = cam.eye[None].expand(B, 3)
    ro, last_p, prev_v = eye.contiguous(), eye, eye
    last_n = rd
    tp = torch.ones((B, 3), **f32)
    radiance = torch.zeros((B, 3), **f32)
    eta = torch.ones(B, **f32)
    depth = torch.zeros(B, dtype=torch.int32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    last_pdf = torch.ones(B, **f32)
    g_mis = torch.zeros(B, **f32)
    k_it = rng.fold_in(key, 0xE7E)
    for it in range(cfg.max_eye_iters):
        with span("sync.bdpt_eye_loop"):
            more = bool(alive.any())
        if not more:   # a dead path stays dead
            break
        k = rng.iter_key(k_it, it)
        u = draw(k, B, 3, start, total, device=dev)
        hit = packed_hit(packed, ro, rd, alive, nearest)
        act = alive & hit.hit
        m, n, pos = hit.mtl, hit.normal, hit.pos

        # a depth-0 hit on a light ball sees the light and ends the path
        light0 = act & hit.is_light & (depth == 0)
        radiance = radiance + torch.where(
            light0[:, None], m.base_color * light_hit_scale,
            torch.zeros_like(radiance))
        act = act & ~light0

        # connect the vertex to the light vertices
        wo_e = -rd
        wo_s = torch.where((depth == 0)[:, None], normalize(eye - pos),
                           normalize(prev_v - pos))
        eye_f = torch.where((depth == 0) | (m.eta > 0.0),
                            torch.zeros_like(g_mis),
                            (1.0 / PDF_FWD_FLOOR) * (1.0 + g_mis))
        kw = {}
        if cfg.bdpt_connection_samples > 0:
            kw["vidx"] = sample_rows(draw, rng.fold_in(k, 0x5E1), B,
                                     cfg.bdpt_connection_samples, n_valid,
                                     start, total, device=dev)
        total_c = connect_fn(packed, lv_tab, n_valid, pos, n, tp, m, wo_e,
                             wo_s, eye_f, act, clamp_val=cfg.clamp,
                             dielectrics_block=blocks, **kw)
        radiance = radiance + torch.where(act[:, None], total_c,
                                          torch.zeros_like(total_c))

        # bounce
        d_vec = pos - last_p
        dist2 = dot(d_vec, d_vec)
        ok = act & (dist2 >= 1e-6)
        cos_at_hit = torch.abs(dot(n, -rd))
        cos_at_prev = torch.abs(dot(last_n, rd))
        pdf_fwd = last_pdf * cos_at_hit / torch.clamp(dist2, min=1e-20)
        s = bsdf_sample(m, wo_e, n, u[0], u[1], u[2], eta)
        sample_ok = (s.pdf > 0.0) | s.is_delta
        delta = ok & sample_ok & s.is_delta
        rough = ok & sample_ok & ~s.is_delta
        pdf_rev = (bsdf_pdf(m, s.wi, wo_e, n) * cos_at_prev
                   / torch.clamp(dist2, min=1e-20))
        # fold the finished vertex into the eye-side MIS recurrence
        g_new = torch.where((depth == 0) | (m.eta > 0.0),
                            torch.zeros_like(g_mis),
                            (1.0 + pdf_rev * g_mis)
                            / torch.clamp(pdf_fwd, min=PDF_FWD_FLOOR))
        w = torch.where(s.is_delta, torch.ones_like(s.pdf),
                        torch.abs(dot(n, s.wi))
                        / torch.clamp(s.pdf, min=1e-20))
        new_tp = tp * s.value * w[:, None]
        tp_valid = is_valid_color(new_tp)
        off = torch.where((dot(s.wi, n) < 0.0)[:, None], -n, n) * EPSILON
        new_ro = torch.where(delta[:, None], pos + off, pos + n * EPSILON)
        depth = depth + rough.to(torch.int32)
        upd = delta | rough
        alive = upd & torch.where(delta, tp_valid,
                                  tp_valid & (depth < cfg.eye_depth))
        u3 = upd[:, None]
        ro = torch.where(u3, new_ro, ro)
        rd = torch.where(u3, s.wi, rd)
        tp = torch.where(u3, new_tp, tp)
        eta = torch.where(upd, s.new_eta, eta)
        last_n = torch.where(u3, n, last_n)
        last_p = torch.where(u3, pos, last_p)
        last_pdf = torch.where(delta, torch.ones_like(last_pdf),
                               torch.where(rough, s.pdf, last_pdf))
        g_mis = torch.where(rough, g_new, g_mis)
        prev_v = torch.where(rough[:, None], pos, prev_v)
    return torch.where(is_valid_color(radiance)[:, None], radiance,
                       torch.zeros_like(radiance))


def _sample_key(key, s: int):
    return rng.fold_in(rng.fold_in(key, 0x0202), s)


def eye_trace_and_connect(packed: PackedScene, cam: Camera, cfg: RenderConfig,
                          lv_flat: LightVertices, lv_tab: torch.Tensor | None,
                          n_valid: int, px, py, key, light_hit_scale: float,
                          start: int = 0, total: int | None = None,
                          tier: str = "fused") -> torch.Tensor:
    """One sample of the per-bounce tiers (``fused`` or ``plain``) against
    the compacted light vertices ``lv_flat`` and their packed table
    ``lv_tab`` or, when ``cfg.bdpt_resample_vertices`` > 0, against a
    global RIS table drawn for the sample (``lv_tab`` is then unused)."""
    if cfg.bdpt_resample_vertices > 0:
        lv_flat, n_valid = resample_light_vertices(
            lv_flat, n_valid, cfg.bdpt_resample_vertices,
            rng.fold_in(key, 0x5E5A))
        lv_tab = pack_light_vertices(lv_flat)
    fns = ({} if tier == "fused" else
           dict(nearest=nearest_hit_plain, connect_fn=connect_plain,
                draw=rng.uniform_rows_plain))
    return eye_sample(packed, cam, cfg, lv_tab, n_valid, px, py, key,
                      light_hit_scale, start, total, **fns)


def bdpt_eye_plain_loop(packed: PackedScene, lv_tab: torch.Tensor,
                        n_valid: int, cam: Camera, px, py, spp: int,
                        cfg: RenderConfig, key, light_hit_scale: float,
                        start: int = 0, total: int | None = None,
                        counts: dict | None = None) -> torch.Tensor:
    """The per-pixel radiance SUM over ``spp`` samples against a (V, 40)
    or tile-local (T, Kp, 40) table, sample after sample on the plain
    versions: what the ``bdpt_eye`` kernel computes.  ``counts`` (from
    ``cuda_connect.new_counts``), if given, gains the samples, the
    nearest-hit casts' tests and the connection sweep's work."""
    def tiled_connect(*args, **kw):
        return connect_plain(*args, **kw, tile_lanes=TILE_LANES,
                             counts=counts)

    def nearest(*args, **kw):
        return nearest_hit_plain(*args, **kw, counts=counts)

    acc = torch.zeros((px.shape[0], 3), device=px.device)
    for s in range(spp):
        if counts is not None:
            counts["samples"] += px.shape[0]
        acc = acc + eye_sample(packed, cam, cfg, lv_tab, n_valid, px, py,
                               _sample_key(key, s), light_hit_scale, start,
                               total, nearest=nearest,
                               connect_fn=tiled_connect,
                               draw=rng.uniform_rows_plain)
    return acc


def light_side(scene: Scene, cfg: RenderConfig, spl: int, key,
               light_sample: int = 0, oracle: bool = False,
               plain: bool = False):
    """The light half of a BDPT frame from the frame key ``key``: the scene
    the eye pass sees, the traced light paths and the scale of a depth-0
    light hit.  GPU parity (``oracle=False``): ``light_sample`` defaults to
    ``spl``; light flux is divided by ``light_sample`` and each path's
    throughput by ``spl``; ``Nl * light_sample * spl`` paths; a depth-0 eye
    hit on a light adds its flux times ``light_sample``.  The oracle: raw
    flux, ``Nl * spl`` paths, the light hit adds its flux."""
    if oracle:
        scene_used, num_paths, light_hit_scale = (
            scene, scene.num_lights * spl, 1.0)
    else:
        ls = light_sample or spl
        scene_used = scene.with_illum_scaled(1.0 / ls)
        num_paths = scene.num_lights * ls * spl
        light_hit_scale = float(ls)
    with span("bdpt.light_trace"):
        lv = trace_light_paths(scene_used, cfg, num_paths, spl,
                               rng.fold_in(key, 0x0101), plain=plain)
    return scene_used, lv, light_hit_scale


def light_table(scene_used: Scene, lv: LightVertices, cam: Camera,
                cfg: RenderConfig, px, py, key, start: int = 0,
                total: int | None = None):
    """The table the mega tier's ``bdpt_eye`` reads for a frame, and its
    row count: the compacted (V, 40) table, or with
    ``cfg.bdpt_resample_vertices`` = K > 0 the (T, Kp, 40) tile-local RIS
    tables of the lanes ``px``, ``py``, drawn with ``fold_in(key,
    0x5E5A)`` (further folded with ``start`` for a slice of a
    ``total``-lane render)."""
    lv_flat, n_valid = compact_flat(lv.flat())
    K = cfg.bdpt_resample_vertices
    if K == 0:
        return pack_light_vertices(lv_flat), n_valid
    kris = rng.fold_in(key, 0x5E5A)
    if total is not None:
        kris = rng.fold_in(kris, start)
    T, lanes = eye_tiling(px.shape[0])
    reps = tile_representatives(scene_used, cam, px, py, lanes, T)
    lv_flat, kp = resample_light_vertices_tiled(lv_flat, n_valid, K, kris,
                                                reps)
    return pack_light_vertices(lv_flat).reshape(T, kp, -1), kp


def eye_pass(scene_used: Scene, lv: LightVertices, cam: Camera,
             cfg: RenderConfig, px, py, spp: int, key,
             light_hit_scale: float, start: int = 0,
             total: int | None = None, tier: str = "mega") -> torch.Tensor:
    """Mean over ``spp`` of the eye pass against the light vertices ``lv``
    in a resolved tier.  ``start``/``total``: these lanes are rows
    [start, start + B) of a ``total``-lane render."""
    with span("bdpt.pack"):
        packed = pack_scene(scene_used)
    if tier == "mega":
        with span("bdpt.light_table"):
            lv_tab, n_valid = light_table(scene_used, lv, cam, cfg, px, py,
                                          key, start, total)
        with span("bdpt.eye"):
            return bdpt_eye(packed, lv_tab, n_valid, cam, px, py, spp, cfg,
                            key, light_hit_scale, start, total) / spp
    with span("bdpt.light_table"):
        lv_flat, n_valid = compact_flat(lv.flat())
        shared = (pack_light_vertices(lv_flat)
                  if cfg.bdpt_resample_vertices == 0 else None)
    with span("bdpt.eye"):
        acc = torch.zeros((px.shape[0], 3), device=px.device)
        for s in range(spp):
            acc = acc + eye_trace_and_connect(
                packed, cam, cfg, lv_flat, shared, n_valid, px, py,
                _sample_key(key, s), light_hit_scale, start, total, tier)
        return acc / spp


def render_bdpt(scene: Scene, cam: Camera, width: int, height: int, spp: int,
                spl: int, cfg: RenderConfig, key, light_sample: int = 0,
                oracle: bool = False, tier: str = "auto") -> torch.Tensor:
    """One BDPT frame, (H*W, 3) mean radiance over ``spp``, on the scene's
    device, with ``light_side``'s GPU-parity scaling or, with ``oracle``,
    the oracle's: raw flux, dielectrics do not block shadow rays, and
    "auto" is the fused tier, as the JAX package keeps its oracle off its
    megakernel."""
    if oracle and tier == "auto":
        tier = "fused"
    tier = resolve_tier(scene, tier, cfg)
    if oracle:
        cfg = cfg.with_(shadow_dielectrics_block=False)
    with span("bdpt.frame"):
        scene_used, lv, light_hit_scale = light_side(
            scene, cfg, spl, key, light_sample, oracle,
            plain=tier == "plain")
        idx = torch.arange(width * height, dtype=torch.int32,
                           device=scene.device)
        return eye_pass(scene_used, lv, cam, cfg, idx % width, idx // width,
                        spp, key, light_hit_scale, tier=tier)


def render_oracle(scene: Scene, cam: Camera, width: int, height: int,
                  spp: int, spl: int, cfg: RenderConfig, seed: int = 1337,
                  tier: str = "auto") -> torch.Tensor:
    """Deterministic BDPT ground truth: ``render_bdpt`` with the oracle's
    flags and the key ``PRNGKey(seed)``; bit-reproducible per seed."""
    return render_bdpt(scene, cam, width, height, spp, spl, cfg,
                       rng.prng_key(seed), oracle=True, tier=tier)
