"""Unidirectional path tracing with NEE + power-heuristic MIS
(``path_tracing_tpu.integrators.pt``), as a regenerating wavefront.

Semantics kept from the reference, as the JAX package keeps them:

- a light-ball hit converts flux to radiance as illum / (area * cone
  ratio), with the full cone at depth 0 and zero behind the cone;
- the MIS "strategy A" term is a stub (``cfg.pt_stub_mis_strategy_a``);
  False turns on the fixed estimator;
- NEE runs on surfaces with eta <= 0 and (metallic < 0.99 or roughness >
  0.01), picks a light uniformly, samples sphere lights on their surface
  with the power heuristic, and parallel lights without pdf or MIS;
- delta bounces do not consume depth; ``cfg.delta_budget`` extra loop
  iterations bound a path instead;
- every contribution is validity-checked and clamped at ``cfg.clamp``.

``wavefront_pt`` picks a tier (``resolve_tier``): scenes without textures
or legacy Ks render in the megakernel (``ops/cuda_wavefront.py``, one
launch for the whole spp loop), textured scenes in the per-bounce tier
with the textured bounce, legacy-Ks scenes in the split tier (the
nearest-hit kernel and the RGB shadow's ``transmittance_rgb`` around a
PyTorch bounce), whatever their size: above ``MAX_RESIDENT_TRIS``
triangles (the TPU's VMEM ceiling, where the JAX package streams the mesh)
the resident kernels walk the super-cluster table, and on the card they
were faster than the streamed kernels #6/#7 on sorted rays
(``ops/cuda_stream.py``, ``--tier stream``, the JAX package's route
there) in every turn on a convex and an enclosed 327,680-triangle mesh,
or level with them (``chip_smoke.py`` phase 11, ``PERF.md``).
The per-bounce tiers (``wavefront_loop``) are a Python loop that launches
one bounce step per iteration and draws the uniforms from the global
Threefry counters, exactly as the JAX package's ``PT_TPU_NO_MEGAKERNEL``
path does, so the two render the same image from the same key; the
megakernel draws the very same numbers in the kernel, so its image equals
the fused tier's pixel for pixel.
"""
from __future__ import annotations

import functools

import torch

from ..config import RenderConfig
from ..ops import rng
from ..ops.cuda_intersect import PackedScene, pack_scene
from ..ops.intersect import Hit, shadow_ray
from ..ops.math3 import (EPSILON, PI, dot, is_valid_color, length,
                         normalize)
from ..ops.sampling import uniform_sphere_dir
from ..ops.bsdf import bsdf_eval_pdf
from ..profiling import count, span
from ..scene.camera import primary_ray_dirs
from ..scene.types import Camera, Scene

# "mega": one render_wavefront kernel for the whole render; "fused": one
# shade_step (textured: shade_step_tex) kernel per bounce; "split": the
# nearest-hit and any-blocker (legacy Ks: transmittance_rgb) kernels
# around a PyTorch bounce; "stream": the streamed nearest-hit and
# any-blocker kernels on coherence-sorted rays around a PyTorch bounce;
# "plain": PyTorch only; "auto": mega, or fused for textured scenes, or
# split for legacy-Ks ones, at any size.  On CPU tensors every tier runs
# plain code (stream its own plain versions).
TIERS = ("auto", "mega", "fused", "split", "stream", "plain")


def _light_table(scene: Scene) -> torch.Tensor:
    """All per-light fields as one (Nl, 12) table: pos3, dir3 (raw),
    illum3, cutoff, is_parallel, ball_r."""
    return torch.cat([
        scene.light_pos, scene.light_dir, scene.light_illum,
        scene.light_cutoff[:, None],
        scene.light_is_parallel.to(torch.float32)[:, None],
        scene.light_ball_r[:, None]], dim=1).contiguous()


def _take_light(table: torch.Tensor, li: torch.Tensor) -> dict:
    row = table[li]
    return dict(pos=row[:, 0:3], dir=row[:, 3:6], illum=row[:, 6:9],
                cutoff=row[:, 9], is_par=row[:, 10] != 0.0, r=row[:, 11])


def _light_emission_radiance(table: torch.Tensor, hit_pos, depth):
    """Flux -> radiance for a light-ball hit: the first light whose ball
    surface lies within 1e-2 of the hit, area 4 pi r^2 and the spot-cone
    ratio.  Returns (emission (B, 3), light index (B,), valid (B,))."""
    c2h = hit_pos[:, None, :] - table[None, :, 0:3]
    c2h_len = length(c2h)
    match = torch.abs(c2h_len - table[None, :, 11]) < 1e-2
    valid = torch.any(match, dim=1)
    li = torch.argmax(match.to(torch.int8), dim=1)   # first match

    lt = _take_light(table, li)
    r = lt["r"]
    area = 4.0 * PI * r * r
    cutoff = lt["cutoff"]
    spot = (cutoff > 0.0) & ~lt["is_par"]

    main_dir = normalize(lt["dir"])
    c2h_dir = normalize(hit_pos - lt["pos"])
    behind = dot(main_dir, c2h_dir) < torch.cos(cutoff)

    one = torch.ones_like(cutoff)
    cone = torch.where(spot, (1.0 - torch.cos(cutoff)) / 2.0, one)
    cone = torch.where(spot & (depth == 0), one, cone)
    cone = torch.where(spot & (depth != 0) & behind,
                       torch.zeros_like(cone), cone)

    ok = valid & (cone > 0.0)
    emission = torch.where(
        ok[:, None],
        lt["illum"] * (1.0 / torch.clamp(area * cone, min=1e-20))[:, None],
        torch.zeros_like(lt["illum"]))
    return emission, li, ok


def _nee(table, hit: Hit, wo, throughput, u_pick, u1, u2, shadow):
    """Next-event estimation at every lane (callers gate by eligibility).
    Returns the contribution including the path throughput, which callers
    validity-check and clamp as the reference does.  ``shadow(p1, rd,
    max_d)`` is the shadow sweep's transmittance, (B, 3): the binary
    verdict broadcast, or the RGB factor of a legacy-Ks scene; a light
    counts where any component is > 0."""
    nl = table.shape[0]
    li = torch.clamp((u_pick * nl).to(torch.int32), max=nl - 1).long()
    lt = _take_light(table, li)
    l_pos, l_dir, l_illum = lt["pos"], lt["dir"], lt["illum"]
    l_cutoff, l_par, l_r = lt["cutoff"], lt["is_par"], lt["r"]

    # both light kinds share one BSDF eval and one shadow sweep
    pdir = normalize(-l_dir)
    d_local = uniform_sphere_dir(u1, u2)
    lp = l_pos + d_local * l_r[:, None]
    wi_vec = lp - hit.pos
    dist2 = dot(wi_vec, wi_vec)
    dist = torch.sqrt(dist2)
    wi_sph = wi_vec * (1.0 / torch.clamp(dist, min=1e-20))[:, None]

    wi = torch.where(l_par[:, None], pdir, wi_sph)
    cos_surf = torch.clamp(dot(hit.normal, wi), min=0.0)
    cos_light = torch.clamp(dot(d_local, -wi_sph), min=0.0)
    inside_cone = l_par | torch.where(
        l_cutoff > 0.0,
        dot(normalize(l_dir), -wi_sph) >= torch.cos(l_cutoff),
        torch.ones_like(l_par))

    # parallel lights target a far point along wi
    p1 = hit.pos + hit.normal * EPSILON
    p2 = torch.where(l_par[:, None], hit.pos + pdir * 1e4,
                     lp + d_local * EPSILON)
    srd, _, max_d = shadow_ray(p1, p2)
    tr = shadow(p1, srd, max_d)
    tr_pos = torch.any(tr > 0.0, dim=-1)

    brdf, pdf_b = bsdf_eval_pdf(hit.mtl, wo, wi, hit.normal)

    # the JAX package's order: tp brdf Le tr, then the scalar factor (with
    # a binary tr the products equal the unshadowed ones bit for bit)
    base = throughput * brdf * l_illum * tr
    contrib_par = base * (cos_surf * float(nl))[:, None]
    area = 4.0 * PI * l_r * l_r
    pdf_area = 1.0 / (nl * area)
    pdf_light_dir = pdf_area * dist2 / torch.clamp(cos_light, min=1e-6)
    p_l = pdf_light_dir * pdf_light_dir
    p_b = pdf_b * pdf_b
    mis_w = p_l / torch.clamp(p_l + p_b, min=1e-8)
    contrib_sph = base * (cos_surf / pdf_light_dir * mis_w)[:, None]

    gate_par = (cos_surf > 0.0) & tr_pos
    gate_sph = (cos_surf > 0.0) & (cos_light > 0.0) & inside_cone & tr_pos
    zero = torch.zeros_like(contrib_par)
    return torch.where(l_par[:, None],
                       torch.where(gate_par[:, None], contrib_par, zero),
                       torch.where(gate_sph[:, None], contrib_sph, zero))


def resolve_tier(scene: Scene, tier: str) -> str:
    """The tier that renders ``scene`` when ``tier`` is asked for: "auto"
    is "mega" for scenes without textures or legacy Ks, "fused" for
    textured ones and "split" for legacy-Ks ones (textured or not), as the
    JAX package gates its megakernel and fused kernels (a legacy-Ks scene
    takes its XLA route, whose shadow is the RGB ``shadow_factor``), at
    any triangle count.  Above ``MAX_RESIDENT_TRIS`` the JAX package
    streams the mesh (#6/#7); on the card the resident super walk of
    "mega" and "fused" was never slower than "stream" in every turn on the
    big meshes ``chip_smoke.py`` times, so auto keeps them there.
    "stream" stays allowed on any scene without legacy Ks.  Raises
    ValueError for an unknown tier, "mega" on a textured scene and
    "mega", "fused" or "stream" on a legacy-Ks scene (their shadow walks
    are binary)."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if scene.has_legacy_ks:
        if tier in ("mega", "fused", "stream"):
            raise ValueError(
                f"tier {tier!r} does not render legacy-Ks scenes (its "
                "shadow walk is binary; the RGB shadow runs in the split "
                "tier, as the JAX package's XLA route); use 'auto' or "
                "'split'")
        return "split" if tier == "auto" else tier
    if tier == "auto":
        return "fused" if scene.has_textures else "mega"
    if tier == "mega" and scene.has_textures:
        raise ValueError("tier 'mega' does not render textured scenes (the "
                         "megakernel is gated off them, as on the TPU); use "
                         "'auto' or 'fused'")
    return tier


def _step_fn(tier: str, textured: bool):
    """The bounce step of a per-bounce tier."""
    from ..ops import cuda_shade as cs

    if tier == "stream":
        return functools.partial(cs.shade_step_stream, tex=textured)
    if textured:
        return {"fused": cs.shade_step_tex,
                "split": functools.partial(cs.shade_step_split, tex=True),
                "plain": cs.shade_step_tex_plain}[tier]
    return {"fused": cs.shade_step, "split": cs.shade_step_split,
            "plain": cs.shade_step_plain}[tier]


def wavefront_pt(scene: Scene, cam: Camera, cfg: RenderConfig,
                 px: torch.Tensor, py: torch.Tensor, spp: int, key,
                 start: int = 0, total: int | None = None,
                 tier: str = "auto") -> torch.Tensor:
    """Wavefront PT with path regeneration: one persistent lane per pixel;
    a lane whose path ends starts the pixel's next sample.  Returns the
    per-pixel radiance SUM over ``spp`` samples.

    ``start``/``total``: the lanes are rows [start, start+B) of a global
    ``total``-lane render and draw the matching Threefry counters.
    ``tier`` picks the path (see ``TIERS`` and ``resolve_tier``)."""
    from ..ops.cuda_stream import pack_scene_stream
    from ..ops.cuda_wavefront import render_wavefront

    with span("pt.setup"):
        tier = resolve_tier(scene, tier)
        packed = (pack_scene_stream(scene) if tier == "stream"
                  else pack_scene(scene))
        light_tab = _light_table(scene)
    if tier == "mega":
        with span("pt.megakernel"):
            return render_wavefront(packed, light_tab, cam, px, py, spp, cfg,
                                    key, start, total)
    draw = rng.uniform_rows_plain if tier == "plain" else rng.uniform_rows
    return wavefront_loop(packed, light_tab, cam, cfg, px, py, spp, key,
                          start, total, _step_fn(tier, scene.has_textures),
                          draw)


def wavefront_loop(packed: PackedScene, light_tab: torch.Tensor,
                   cam: Camera, cfg: RenderConfig, px: torch.Tensor,
                   py: torch.Tensor, spp: int, key, start: int,
                   total: int | None, step, draw=rng.uniform_rows,
                   counts: dict | None = None) -> torch.Tensor:
    """The per-bounce wavefront: one ``step`` (a bounce function of
    ``ops/cuda_shade.py``) per iteration over every lane, with the
    iteration's uniforms from ``draw`` (``rng.uniform_rows`` or its plain
    version), regeneration, the iteration budget and per-pixel sums.
    ``counts`` (``cuda_wavefront.new_counts``), if given, gains the
    megakernel's paths, their draws, ``pixel_warp_slots`` and
    ``iteration_keys``; the step counts the rest (its active lanes as
    ``iterations``).  Under a profiler each iteration is a ``pt.bounce``
    span and ``counters`` gains its live lanes (``pt.live_lanes``) and its
    lanes (``pt.lane_slots``)."""
    dev = px.device
    B = px.shape[0]
    f32 = dict(device=dev, dtype=torch.float32)
    i32 = dict(device=dev, dtype=torch.int32)
    image = torch.zeros((B, 3), **f32)
    sample = torch.zeros(B, **i32)        # samples started so far
    path_it = torch.zeros(B, **i32)       # iterations used by this path
    ro = cam.eye[None, :].expand(B, 3).contiguous()
    rd = torch.zeros((B, 3), **f32)
    tp = torch.ones((B, 3), **f32)
    radiance = torch.zeros((B, 3), **f32)
    eta = torch.ones(B, **f32)
    depth = torch.zeros(B, **i32)
    alive = torch.zeros(B, dtype=torch.bool, device=dev)
    last_delta = torch.ones(B, dtype=torch.bool, device=dev)
    last_pdf = torch.ones(B, **f32)
    eye = cam.eye[None, :]

    max_total = spp * cfg.max_eye_iters + cfg.max_eye_iters
    lane_iters = torch.zeros(B, dtype=torch.int64, device=dev)
    it = 0
    while it < max_total:
        # the one host read an iteration: the lanes this step works on
        # (those alive or owing samples, alive once regenerated); none left
        # ends the render
        with span("sync.pt_loop"):
            n = int((alive | (sample < spp)).sum())
        if n == 0:
            break
        count("pt.live_lanes", n)
        count("pt.lane_slots", B)
        with span("pt.bounce"):
            u = draw(rng.iter_key(key, it), B, 8, start, total, device=dev)

            # ---- regenerate dead lanes that still owe samples ----
            regen = ~alive & (sample < spp)
            r3 = regen[:, None]
            rd_new = primary_ray_dirs(cam, px, py, u[6], u[7])
            ro = torch.where(r3, eye, ro)
            rd = torch.where(r3, rd_new, rd)
            tp = torch.where(r3, torch.ones_like(tp), tp)
            radiance = torch.where(r3, torch.zeros_like(radiance), radiance)
            eta = torch.where(regen, torch.ones_like(eta), eta)
            depth = torch.where(regen, torch.zeros_like(depth), depth)
            path_it = torch.where(regen, torch.zeros_like(path_it), path_it)
            last_delta = last_delta | regen
            last_pdf = torch.where(regen, torch.ones_like(last_pdf), last_pdf)
            sample = sample + regen.to(torch.int32)
            alive = alive | regen
            if counts is not None:
                # a fold_in an iteration and two jitter draws a path
                lane_iters += alive
                counts["samples"] += int(regen.sum())
                counts["draws"] += int(alive.sum()) + 2 * int(regen.sum())
                counts["iteration_keys"] += 1

            out = step(packed, light_tab, ro, rd, tp, eta, depth, alive,
                       last_delta, last_pdf, u, clamp_val=cfg.clamp,
                       stub_mis=cfg.pt_stub_mis_strategy_a,
                       dielectrics_block=cfg.shadow_dielectrics_block)
            radiance = radiance + out["radiance"]
            alive_out = out["alive"] & (out["last_is_delta"]
                                        | (out["depth"] < cfg.eye_depth))
            path_it = torch.where(alive, path_it + 1, path_it)
            alive_out = alive_out & (path_it < cfg.max_eye_iters)

            # ---- flush the paths that ended this iteration ----
            died = (alive & ~alive_out)[:, None]
            final = torch.where(is_valid_color(radiance)[:, None], radiance,
                                torch.zeros_like(radiance))
            image = image + torch.where(died, final, torch.zeros_like(final))
            radiance = torch.where(died, torch.zeros_like(radiance), radiance)

            ro, rd, tp = out["ro"], out["rd"], out["tp"]
            eta, depth = out["eta"], out["depth"]
            alive, last_delta = alive_out, out["last_is_delta"]
            last_pdf = out["last_pdf"]
            it += 1

    if counts is not None and B:
        warps = torch.nn.functional.pad(lane_iters, (0, -B % 32))
        counts["pixel_warp_slots"] += 32 * int(warps.view(-1, 32).amax(1)
                                               .sum())
    # paths cut by the global cap still contribute what they gathered
    leftover = torch.where((alive & is_valid_color(radiance))[:, None],
                           radiance, torch.zeros_like(radiance))
    return image + leftover


def render_pt(scene: Scene, cam: Camera, width: int, height: int, spp: int,
              cfg: RenderConfig, key, tier: str = "auto") -> torch.Tensor:
    """One PT frame: mean radiance over ``spp`` paths per pixel, (H*W, 3),
    on the scene's device."""
    with span("pt.frame"):
        with span("pt.setup"):
            idx = torch.arange(width * height, dtype=torch.int32,
                               device=scene.device)
            px, py = idx % width, idx // width
        return wavefront_pt(scene, cam, cfg, px, py, spp, key,
                            tier=tier) / spp
