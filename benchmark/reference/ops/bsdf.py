"""pbrt-v4-style BSDF: evaluate, pdf and sample (``path_tracing_tpu.ops.bsdf``).

Every lane computes all three sampling branches (smooth dielectric, smooth
conductor, rough mix) and selects by material masks:

- smooth dielectrics (eta > 0, roughness < 0.001) have zero eval and pdf,
- the rough lobe mixes cosine-diffuse and GGX-VNDF 50/50 (all specular if
  metallic > 0), with the pdf mixed the same way,
- the conductor delta needs metallic > 0.99 and roughness < 0.001,
- the dielectric delta also needs metallic < 0.01,
- refraction tracks the current medium eta and exits into air.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.types import Material
from .frame import (abs_cos_theta, build_local_frame, cos2_theta, cos_theta,
                    local_to_world, world_to_local)
from .fresnel import fr_dielectric, fr_schlick
from .math3 import PI, dot
from .microfacet import (roughness_to_alpha, sample_tr_visible_normal, tr_d,
                         tr_g, tr_g1)


class BsdfSample(NamedTuple):
    wi: torch.Tensor        # (..., 3) sampled world-space direction
    value: torch.Tensor     # (..., 3) BSDF value (delta lobes: weight/|cos|)
    pdf: torch.Tensor       # (...,) solid-angle pdf (delta lobes: lobe prob)
    is_delta: torch.Tensor  # (...,) bool
    new_eta: torch.Tensor   # (...,) medium IOR after the event


def _where(m, a, b):
    return torch.where(m, a, b)


def _half_vector(wo, wi):
    wh_vec = wo + wi
    wh_len = torch.sqrt(dot(wh_vec, wh_vec))
    wh = wh_vec * (1.0 / torch.clamp(wh_len, min=1e-20))[..., None]
    wh = _where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    return wh, wh_len >= 1e-6


def _eval_local(mtl: Material, wo, wi, alpha, wh, wh_valid):
    zero_cos = (cos_theta(wo) == 0.0) | (cos_theta(wi) == 0.0)
    smooth_dielectric = (mtl.eta > 0.0) & (mtl.roughness < 0.001)

    same_side = wo[..., 2] * wi[..., 2] > 0.0
    diffuse = mtl.base_color * ((1.0 - mtl.metallic) / PI)[..., None]
    diffuse = _where((wo[..., 2] * wi[..., 2] < 0.0)[..., None],
                     torch.zeros_like(diffuse), diffuse)

    d = tr_d(wh, alpha)
    g = tr_g(wo, wi, alpha)
    f_schlick = fr_schlick(abs_cos_theta(wo), mtl.base_color)
    fr = fr_dielectric(dot(wo, wh), 1.0, mtl.eta)
    f = _where((mtl.metallic > 0.0)[..., None], f_schlick, fr[..., None])

    denom = torch.clamp(4.0 * abs_cos_theta(wo) * abs_cos_theta(wi),
                        min=1e-4)
    specular = f * (d * g / denom)[..., None]

    out = _where(same_side[..., None], diffuse + specular, diffuse)
    kill = zero_cos | smooth_dielectric | ~wh_valid
    return _where(kill[..., None], torch.zeros_like(out), out)


def _pdf_local(mtl: Material, wo, wi, alpha, wh, wh_valid):
    opposite = cos_theta(wo) * cos_theta(wi) <= 0.0
    smooth_dielectric = (mtl.eta > 0.0) & (mtl.roughness < 0.001)

    pdf_diffuse = abs_cos_theta(wi) / PI
    g1 = tr_g1(wo, alpha)
    pdf_wh = (tr_d(wh, alpha) * g1 * torch.clamp(dot(wo, wh), min=0.0)
              / torch.clamp(abs_cos_theta(wo), min=1e-20))
    pdf_specular = pdf_wh / (4.0 * dot(wo, wh) + 1e-7)

    one = torch.ones_like(pdf_diffuse)
    spec_weight = _where(mtl.metallic > 0.0, one, 0.5 * one)
    pdf = (1.0 - spec_weight) * pdf_diffuse + spec_weight * pdf_specular
    kill = opposite | smooth_dielectric | ~wh_valid
    return _where(kill, torch.zeros_like(pdf), pdf)


def _to_local(mtl: Material, wo_w, wi_w, n):
    t, b = build_local_frame(n)
    wo = world_to_local(wo_w, t, b, n)
    wi = world_to_local(wi_w, t, b, n)
    alpha = roughness_to_alpha(mtl.roughness)
    wh, wh_valid = _half_vector(wo, wi)
    return wo, wi, alpha, wh, wh_valid


def bsdf_pdf(mtl: Material, wo_w, wi_w, n) -> torch.Tensor:
    """Solid-angle pdf of ``bsdf_sample``'s rough branch."""
    return _pdf_local(mtl, *_to_local(mtl, wo_w, wi_w, n))


def bsdf_eval_pdf(mtl: Material, wo_w, wi_w, n):
    """Evaluate f(wo, wi) and the rough-lobe pdf in one local frame."""
    args = _to_local(mtl, wo_w, wi_w, n)
    return _eval_local(mtl, *args), _pdf_local(mtl, *args)


def bsdf_sample(mtl: Material, wo_w, n, u_rr, u1, u2,
                current_eta) -> BsdfSample:
    """Sample an outgoing direction: all three branches, mask-selected."""
    t, b = build_local_frame(n)
    wo = world_to_local(wo_w, t, b, n)

    m_dielectric = ((mtl.eta > 0.0) & (mtl.roughness < 0.001)
                    & (mtl.metallic < 0.01))
    m_conductor = (~m_dielectric & (mtl.metallic > 0.99)
                   & (mtl.roughness < 0.001))
    is_delta = m_dielectric | m_conductor

    # ---- smooth dielectric ----
    f = fr_dielectric(cos_theta(wo), current_eta, mtl.eta)
    reflect_l = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    entering = cos_theta(wo) > 0.0
    eta_ratio = _where(entering, current_eta / mtl.eta,
                       mtl.eta / current_eta)
    sin2_i = torch.clamp(1.0 - cos2_theta(wo), min=0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    tir = sin2_t >= 1.0
    cos_t_refr = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    cos_t_refr = _where(entering, -cos_t_refr, cos_t_refr)
    refract_l = torch.stack([-eta_ratio * wo[..., 0],
                             -eta_ratio * wo[..., 1], cos_t_refr], dim=-1)

    take_reflect = u_rr < f
    diel_wi = _where(take_reflect[..., None], reflect_l, refract_l)
    diel_abs_cos = torch.clamp(torch.abs(diel_wi[..., 2]), min=1e-20)
    diel_pdf = _where(take_reflect, f, 1.0 - f)
    refr_val = mtl.base_color * ((1.0 - f) / diel_abs_cos)[..., None]
    refl_val = (f / diel_abs_cos)[..., None] * torch.ones_like(
        mtl.base_color)
    diel_val = _where(take_reflect[..., None], refl_val, refr_val)
    # TIR reaching the refract branch kills the lane cleanly
    refr_dead = ~take_reflect & tir
    diel_pdf = _where(refr_dead, torch.zeros_like(diel_pdf), diel_pdf)
    diel_val = _where(refr_dead[..., None], torch.zeros_like(diel_val),
                      diel_val)
    diel_new_eta = _where(take_reflect, current_eta,
                          _where(entering, mtl.eta, torch.ones_like(mtl.eta)))

    # ---- smooth conductor ----
    cond_wi = reflect_l
    cond_val = fr_schlick(abs_cos_theta(wo), mtl.base_color) * (
        1.0 / torch.clamp(torch.abs(cond_wi[..., 2]), min=1e-20))[..., None]
    cond_pdf = torch.ones_like(f)

    # ---- rough: VNDF specular or cosine diffuse ----
    alpha = roughness_to_alpha(mtl.roughness)
    one = torch.ones_like(alpha)
    spec_weight = _where(mtl.metallic > 0.0, one, 0.5 * one)
    wo_up = _where((wo[..., 2] > 0.0)[..., None], wo, -wo)
    wh = sample_tr_visible_normal(wo_up, alpha, u1, u2)
    wh = _where((wo[..., 2] < 0.0)[..., None], -wh, wh)
    spec_wi = -wo - wh * (2.0 * dot(wh, -wo))[..., None]
    spec_bad = wo[..., 2] * spec_wi[..., 2] <= 0.0

    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    diff_wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                           torch.sqrt(torch.clamp(1.0 - u1, min=0.0))],
                          dim=-1)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=diff_wi.dtype,
                        device=diff_wi.device)
    diff_wi = _where((wo[..., 2] < 0.0)[..., None], diff_wi * flip, diff_wi)

    take_spec = u_rr < spec_weight
    rough_wi_l = _where(take_spec[..., None], spec_wi, diff_wi)
    rough_dead = take_spec & spec_bad
    wh_r, wh_r_valid = _half_vector(wo, rough_wi_l)
    rough_pdf = _pdf_local(mtl, wo, rough_wi_l, alpha, wh_r, wh_r_valid)
    rough_pdf = _where(rough_dead, torch.zeros_like(rough_pdf), rough_pdf)
    rough_val = _eval_local(mtl, wo, rough_wi_l, alpha, wh_r, wh_r_valid)
    rough_val = _where(rough_dead[..., None], torch.zeros_like(rough_val),
                       rough_val)

    # ---- select ----
    wi_l = _where(m_dielectric[..., None], diel_wi,
                  _where(m_conductor[..., None], cond_wi, rough_wi_l))
    wi_w = local_to_world(wi_l, t, b, n)
    value = _where(m_dielectric[..., None], diel_val,
                   _where(m_conductor[..., None], cond_val, rough_val))
    pdf = _where(m_dielectric, diel_pdf,
                 _where(m_conductor, cond_pdf, rough_pdf))
    new_eta = _where(m_dielectric, diel_new_eta, current_eta)
    return BsdfSample(wi=wi_w, value=value, pdf=pdf, is_delta=is_delta,
                      new_eta=new_eta)
