"""The plain PT bounce (counterpart of ``path_tracing_tpu.ops.pallas_shade``).

``shade_step_plain`` runs one bounce of every lane of the wavefront on the
plain nearest-hit and any-blocker sweeps: nearest hit, light-ball
emission, next-event estimation with its shadow ray, the BSDF sample and
the path-state update, the uniforms per lane in the rows of ``u``.
``shade_step_tex_plain`` is the textured bounce (``shade_step_tex``'s
plain version): the ``with_uv`` hit, the bilinear texel multiplied into a
textured triangle's base color, then the bounce.
"""
from __future__ import annotations

import functools

import torch

from .bsdf import bsdf_sample
from .cuda_intersect import PackedScene, any_blocker_plain, nearest_hit_plain
from .intersect import hit_from_fields, texel_fields
from .math3 import EPSILON, PI, clamp_radiance, dot, is_valid_color

LIGHT_COLS = 12
# The counters of the per-bounce kernels' counting builds (#3's and #4's)
# that their plain versions count: the megakernel's
# (``cuda_wavefront.COUNT_NAMES``) that one bounce fills, the active lanes
# as ``iterations``.  The kernels draw nothing (the uniforms come in
# ``u``), so the plain ``draws`` are not compared.
STEP_COUNTS = ("iterations", "shadow_rays", "evals", "pdfs", "bsdf_samples",
               "hit_spheres", "hit_boxes", "hit_tris", "shadow_spheres",
               "shadow_boxes", "shadow_tris")


def _bounce(packed: PackedScene, light_tab, ro, rd, tp, eta, depth, act,
            last_delta, last_pdf, u, *, clamp_val, stub_mis,
            dielectrics_block, tex=False, counts=None) -> dict:
    """One PT bounce in PyTorch on the plain sweeps; ``tex`` textures the
    hit.  The nearest hit gets the active lanes and the any-blocker the
    NEE-eligible ones as ``live=`` (the lanes whose result is read: the
    kernels walk only those).  ``counts``, if given, gains the megakernel's work of the bounce (its active lanes as
    ``iterations``, NEE rays with their evaluation, pdf and draws, BSDF
    samples with theirs) and is handed to the intersection functions,
    which count their walks' tests."""
    from ..integrators.pt import _light_emission_radiance, _nee

    nl = light_tab.shape[0]
    nearest = functools.partial(nearest_hit_plain, counts=counts)
    blocker = functools.partial(any_blocker_plain, counts=counts)
    if counts is not None:
        counts["iterations"] += int(act.sum())
    if tex:
        h = texel_fields(packed, nearest(packed, ro, rd, with_uv=True,
                                         live=act))
    else:
        h = nearest(packed, ro, rd, live=act)
    hit = hit_from_fields(h, ro, rd)
    act = act & hit.hit
    wo = -rd

    # ---- 1. a BSDF ray that hit a light ball ----
    emission, li, okl = _light_emission_radiance(light_tab, hit.pos, depth)
    has_e = torch.any(emission > 0.0, dim=-1)
    c_delta = tp * emission
    c_delta = torch.where(is_valid_color(c_delta)[:, None],
                          clamp_radiance(c_delta, clamp_val),
                          torch.zeros_like(c_delta))
    if stub_mis:
        c_mis = torch.zeros_like(c_delta)   # the stubbed strategy A
    else:
        r = light_tab[li, 11]
        area = 4.0 * PI * r * r
        cos_l = torch.clamp(dot(hit.normal, wo), min=1e-6)
        pdf_l = (1.0 / (nl * area)) * hit.t * hit.t / cos_l
        p_b = last_pdf * last_pdf
        p_l = pdf_l * pdf_l
        mis_w = p_b / torch.clamp(p_b + p_l, min=1e-8)
        c_mis = tp * emission * mis_w[:, None]
        c_mis = torch.where((okl & is_valid_color(c_mis))[:, None],
                            clamp_radiance(c_mis, clamp_val),
                            torch.zeros_like(c_mis))
    light_contrib = torch.where(last_delta[:, None], c_delta, c_mis)
    add_light = act & hit.is_light & has_e
    radiance = torch.where(add_light[:, None], light_contrib,
                           torch.zeros_like(light_contrib))

    # lanes that hit a light terminate
    upd = act & ~hit.is_light

    # ---- 2. NEE ----
    m = hit.mtl
    elig = upd & (m.eta <= 0.0) & ((m.metallic < 0.99) | (m.roughness > 0.01))
    if counts is not None:
        n_nee, n_bsdf = int(elig.sum()) if nl > 0 else 0, int(upd.sum())
        for k in ("shadow_rays", "evals", "pdfs"):
            counts[k] += n_nee
        counts["bsdf_samples"] += n_bsdf
        counts["draws"] += 3 * (n_nee + n_bsdf)
    if nl > 0:
        def shadow(p1, srd, max_d):
            blocked = blocker(packed, p1, srd, max_d, dielectrics_block,
                              live=elig)
            tr = torch.where(blocked, torch.zeros_like(max_d),
                             torch.ones_like(max_d))
            return tr[:, None].expand(-1, 3)
        nee = _nee(light_tab, hit, wo, tp, u[0], u[1], u[2], shadow)
        nee = torch.where(is_valid_color(nee)[:, None],
                          clamp_radiance(nee, clamp_val),
                          torch.zeros_like(nee))
        radiance = radiance + torch.where(elig[:, None], nee,
                                          torch.zeros_like(nee))

    # ---- 3. BSDF sample and state update ----
    s = bsdf_sample(m, wo, hit.normal, u[3], u[4], u[5], eta)
    dead = (s.pdf <= 0.0) & ~s.is_delta
    alive = upd & ~dead
    cos_wi = torch.abs(dot(hit.normal, s.wi))
    tp_delta = tp * s.value
    tp_rough = tp * s.value * (cos_wi / torch.clamp(s.pdf, min=1e-20))[:, None]
    new_tp = torch.where(s.is_delta[:, None], tp_delta, tp_rough)
    alive = alive & is_valid_color(new_tp)
    off = torch.where((dot(s.wi, hit.normal) < 0.0)[:, None], -hit.normal,
                      hit.normal) * EPSILON
    new_ro = torch.where(s.is_delta[:, None], hit.pos + off,
                         hit.pos + hit.normal * EPSILON)
    new_depth = depth + torch.where(s.is_delta, 0, 1).to(depth.dtype)

    u3 = upd[:, None]
    return dict(
        radiance=radiance,
        ro=torch.where(u3, new_ro, ro),
        rd=torch.where(u3, s.wi, rd),
        tp=torch.where(u3, new_tp, tp),
        eta=torch.where(upd, s.new_eta, eta),
        depth=torch.where(upd, new_depth, depth),
        alive=upd & alive,
        last_is_delta=torch.where(upd, s.is_delta, last_delta),
        last_pdf=torch.where(upd & ~s.is_delta, s.pdf, last_pdf),
    )


def shade_step_plain(packed, light_tab, ro, rd, tp, eta, depth, act,
                     last_delta, last_pdf, u, *, clamp_val, stub_mis,
                     dielectrics_block, counts=None) -> dict:
    """Plain PyTorch version of the ``shade_step`` kernel.  ``counts``
    (``cuda_wavefront.new_counts()``), if given, gains the work its
    counting build counts (``STEP_COUNTS``: see ``_bounce``)."""
    return _bounce(packed, light_tab, ro, rd, tp, eta, depth, act,
                   last_delta, last_pdf, u, clamp_val=clamp_val,
                   stub_mis=stub_mis, dielectrics_block=dielectrics_block,
                   counts=counts)


def shade_step_tex_plain(packed, light_tab, ro, rd, tp, eta, depth, act,
                         last_delta, last_pdf, u, *, clamp_val, stub_mis,
                         dielectrics_block, counts=None) -> dict:
    """Plain PyTorch version of the ``shade_step_tex`` kernel.
    ``counts`` (``cuda_wavefront.new_counts()``), if given, gains the work
    its counting build counts (``STEP_COUNTS``: see ``_bounce``)."""
    return _bounce(packed, light_tab, ro, rd, tp, eta, depth, act,
                   last_delta, last_pdf, u, clamp_val=clamp_val,
                   stub_mis=stub_mis, dielectrics_block=dielectrics_block,
                   tex=True, counts=counts)


