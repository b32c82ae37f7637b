"""BDPT eye-light connections (counterpart of
``path_tracing_tpu.ops.pallas_connect``).

``pack_light_vertices`` lays the light-vertex set out as the ``(V, 40)``
float32 table the kernels read, column for column the JAX package's table:

    [pos3, normal3, tp3, bc3, rough, metal, eta, is_src, cutoff, is_par,
     emit_dir3, wo3, mis_a, valid, tangent3, bitangent3, wo_local3, alpha,
     cos_cutoff, 0, 0, 0]

with rows padded to a multiple of 8.  The light side's shading frame, its
local outgoing direction, GGX alpha and cone cosine are computed once here.

``connect_plain`` (the ``connect`` kernel's plain version) sums, per eye
vertex, the contributions of rows ``[0, n_valid)`` of the table: geometry
term, both BSDF evaluations, the shadow ray and the O(1)
balance-heuristic MIS weight, each contribution validity-checked and
clamped, added row after row; lanes that are not active get 0.  Given a
``counts`` dict it counts the kernel's work (``COUNT_NAMES``), the shadow
walks' tests as the kernels walk them.  The reference's quirks are kept as
``connect_core`` keeps them:
the evaluations take the unit direction and both MIS pdfs the direction
scaled by the distance; pdfs are floored at 1e-6; the spot-cone gate;
``G = cos_e cos_l / max(d^2, 1e-4)``; the distance-scaled area
conversions; ``1 / (1 + pdf_t_to_s eye_f + pdf_s_to_t mis_a)``.
"""
from __future__ import annotations


import torch

from ..scene.types import Material
from .bsdf import _eval_local, _half_vector, _pdf_local
from .cuda_intersect import PackedScene, any_blocker_plain
from .frame import build_local_frame, world_to_local
from .intersect import shadow_ray
from .math3 import EPSILON, clamp_radiance, dot, is_valid_color
from .microfacet import roughness_to_alpha

LV_COLS = 40
PDF_OMEGA_FLOOR = 1e-6
# The counting builds' counters, in csrc/pt_device.cuh's CountIdx order:
# eye samples; connectable eye vertices (calls of the sweep); rows visited
# (vertices x n_valid); rows past the geometry and cone gates; BSDF
# evaluations and pdfs done (an evaluation on each gated row and, where the
# eye side's is not zero, the eye pdf, the light side's evaluation unless
# the row is an emitter, and where that is not zero the light pdf); rows
# past the zero-eval gates (= shadow rays); contributions added; sphere,
# box and triangle tests of the nearest-hit casts and of the shadow walks;
# and at the row step (past the gates), the shadow step and a shadow walk's
# triangle test, the lanes of each warp step and 32 slots a step (their
# ratio is the SIMT efficiency); and the lanes that sweep a vertex in each
# warp sweep with 32 slots a sweep (their ratio: the share of a sweep's
# lanes that are busy).  The plain versions count the first 14, the
# primitive tests by walking the clusters in the kernels' order.
COUNT_NAMES = ("samples", "vertices", "rows", "rows_gated", "evals", "pdfs",
               "shadow_rays", "contributions", "hit_spheres", "hit_boxes",
               "hit_tris", "shadow_spheres", "shadow_boxes", "shadow_tris",
               "row_lanes", "row_slots", "shadow_lanes", "shadow_slots",
               "tri_lanes", "tri_slots", "sweep_lanes", "sweep_slots")
PLAIN_COUNTS = COUNT_NAMES[:14]
# elements of one (lanes, rows, 3) intermediate of the plain sweep
_PLAIN_CHUNK = 1 << 25
_ROW_CHUNK = 128


def pack_light_vertices(lv_flat) -> torch.Tensor:
    """Flat LightVertices -> the (V, 40) table (rows padded to 8)."""
    V = lv_flat.pos.shape[0]
    lt, lb = build_local_frame(lv_flat.normal)
    wo_t_l = world_to_local(lv_flat.wo, lt, lb, lv_flat.normal)
    m = lv_flat.mtl
    cols = [
        lv_flat.pos, lv_flat.normal, lv_flat.throughput, m.base_color,
        m.roughness[:, None], m.metallic[:, None], m.eta[:, None],
        lv_flat.is_light_source.float()[:, None],
        lv_flat.source_cutoff[:, None],
        lv_flat.is_parallel.float()[:, None],
        lv_flat.emit_dir, lv_flat.wo, lv_flat.mis_a[:, None],
        lv_flat.valid.float()[:, None], lt, lb, wo_t_l,
        roughness_to_alpha(m.roughness)[:, None],
        torch.cos(lv_flat.source_cutoff)[:, None],
    ]
    tab = torch.cat(cols, dim=1)
    rows = -(-V // 8) * 8
    out = torch.zeros((rows, LV_COLS), device=tab.device)
    out[:V, :tab.shape[1]] = tab
    return out


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES}


def _connect_rows(packed: PackedScene, R: torch.Tensor, ev_pos, ev_n, ev_tp,
                  ev_mtl: Material, wo_e, wo_s, eye_f, clamp_val: float,
                  dielectrics_block: bool, counts=None) -> torch.Tensor:
    """The connection sum of every given lane (all active), in PyTorch:
    against the shared rows ``R`` (C, 40) in slabs of ``_ROW_CHUNK`` rows,
    the contributions added row after row as the kernel adds them.  Shadow
    rays only for the pairs that pass every other gate."""
    Bc = ev_pos.shape[0]
    if counts is not None:
        counts["rows"] += Bc * R.shape[-2]
    acc = torch.zeros((Bc, 3), device=ev_pos.device)
    if Bc == 0:
        return acc
    et, eb = build_local_frame(ev_n)
    eye = dict(
        pos=ev_pos, n=ev_n, tp=ev_tp, eye_f=eye_f, et=et, eb=eb,
        wo_e_l=world_to_local(wo_e, et, eb, ev_n)[:, None],
        wo_s_l=world_to_local(wo_s, et, eb, ev_n)[:, None],
        alpha=roughness_to_alpha(ev_mtl.roughness)[:, None],
        m=Material(base_color=ev_mtl.base_color[:, None],
                   roughness=ev_mtl.roughness[:, None],
                   metallic=ev_mtl.metallic[:, None],
                   eta=ev_mtl.eta[:, None]),
        p1=ev_pos + ev_n * EPSILON)
    for r0 in range(0, R.shape[0], _ROW_CHUNK):
        contrib = _pair_contribs(packed, R[None, r0:r0 + _ROW_CHUNK], eye,
                                 clamp_val, dielectrics_block, counts)
        for c in range(contrib.shape[1]):
            acc = acc + contrib[:, c]
    return acc


def _pair_contribs(packed: PackedScene, C: torch.Tensor, eye: dict,
                   clamp_val: float, dielectrics_block: bool,
                   counts) -> torch.Tensor:
    """Each (lane, row) pair's contribution, (lanes, rows, 3): ``C`` is
    (1, rows, 40), rows every lane shares; the binary shadow ray."""
    ev_pos, ev_n = eye["pos"], eye["n"]
    et, eb, m_e, alpha_e = eye["et"], eye["eb"], eye["m"], eye["alpha"]
    wo_e_l, wo_s_l = eye["wo_e_l"], eye["wo_s_l"]
    lp, ln, ltp = C[..., 0:3], C[..., 3:6], C[..., 6:9]
    m_l = Material(base_color=C[..., 9:12], roughness=C[..., 12],
                   metallic=C[..., 13], eta=C[..., 14])
    is_src = C[..., 15] > 0.0
    cutoff, is_par = C[..., 16], C[..., 17] > 0.0
    emit, mis_a = C[..., 18:21], C[..., 24]
    v_ok = C[..., 25] > 0.0
    lt, lb = C[..., 26:29], C[..., 29:32]
    wo_t_l = C[..., 32:35]
    alpha_l, cos_cut = C[..., 35], C[..., 36]

    d_vec = lp - ev_pos[:, None]
    dist2 = dot(d_vec, d_vec)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    wi = d_vec * (1.0 / dist)[..., None]
    cos_e = torch.clamp(dot(ev_n[:, None], wi), min=0.0)
    cos_l = torch.clamp(dot(-ln, wi), min=0.0)
    gate = v_ok & (dist2 >= 1e-6) & (cos_e > 0.0) & (cos_l > 0.0)
    cone_bad = (is_src & (cutoff > 0.0) & ~is_par
                & (dot(emit, -wi) < cos_cut))
    gate = gate & ~cone_bad
    _tally(counts, "rows_gated", gate)

    # eye side: eval with the unit wi, MIS pdf with wi * dist
    wi_e_l = world_to_local(wi, et[:, None], eb[:, None], ev_n[:, None])
    wh_e, ok_e = _half_vector(wo_e_l, wi_e_l)
    f_e = _eval_local(m_e, wo_e_l, wi_e_l, alpha_e, wh_e, ok_e)
    wi_s_l = wi_e_l * dist[..., None]
    wh_s, ok_s = _half_vector(wo_s_l, wi_s_l)
    pdf_s = torch.clamp(_pdf_local(m_e, wo_s_l, wi_s_l, alpha_e, wh_s,
                                   ok_s), min=PDF_OMEGA_FLOOR)
    # light side, in the frame packed with the table
    wi_l_l = world_to_local(-wi, lt, lb, ln)
    wh_l, ok_l = _half_vector(wo_t_l, wi_l_l)
    f_l = torch.where(is_src[..., None], torch.ones_like(wi_l_l),
                      _eval_local(m_l, wo_t_l, wi_l_l, alpha_l, wh_l, ok_l))
    wi_t_l = wi_l_l * dist[..., None]
    wh_t, ok_t = _half_vector(wo_t_l, wi_t_l)
    pdf_t = torch.clamp(_pdf_local(m_l, wo_t_l, wi_t_l, alpha_l, wh_t,
                                   ok_t), min=PDF_OMEGA_FLOOR)
    fe_ok = gate & torch.any(f_e > 0.0, dim=-1)
    _tally(counts, "evals", gate)
    _tally(counts, "evals", fe_ok & ~is_src)
    _tally(counts, "pdfs", fe_ok)
    gate = fe_ok & torch.any(f_l > 0.0, dim=-1)
    _tally(counts, "pdfs", gate)
    _tally(counts, "shadow_rays", gate)

    # shadow rays of the pairs still gated in
    lane, row = torch.nonzero(gate, as_tuple=True)
    q1 = eye["p1"][lane]
    p2 = (lp + ln * EPSILON).expand(gate.shape + (3,))[lane, row]
    srd, _, md = shadow_ray(q1, p2)
    g_term = cos_e * cos_l / torch.clamp(dist2, min=1e-4)
    pdf_s_to_t = pdf_s * cos_l * dist / torch.clamp(dist2, min=1e-20)
    pdf_t_to_s = pdf_t * cos_e * dist / torch.clamp(dist2, min=1e-20)
    sum_ratios = (1.0 + pdf_t_to_s * eye["eye_f"][:, None]) + pdf_s_to_t * mis_a
    mis_ok = torch.isfinite(sum_ratios) & (sum_ratios > 0.0)
    mis_w = torch.where(mis_ok, 1.0 / torch.clamp(sum_ratios, min=1e-30),
                        torch.zeros_like(sum_ratios))
    tr = torch.zeros_like(dist2)
    tr[lane, row] = torch.where(
        any_blocker_plain(packed, q1, srd, md, dielectrics_block,
                          counts=counts), 0.0, 1.0)
    gate = gate & (tr > 0.0)
    contrib = (eye["tp"][:, None] * f_e * f_l * ltp
               * (g_term * tr * mis_w)[..., None])
    ok = gate & is_valid_color(contrib)
    _tally(counts, "contributions", ok)
    return torch.where(ok[..., None], clamp_radiance(contrib, clamp_val),
                       torch.zeros_like(contrib))


def _tally(counts, name: str, mask: torch.Tensor) -> None:
    if counts is not None:
        counts[name] += int(mask.sum())


def connect_plain(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int,
                  ev_pos, ev_normal, ev_tp, ev_mtl: Material, wo_e, wo_s,
                  eye_f, act, *, clamp_val: float, dielectrics_block: bool,
                  tile_lanes: int = 0, counts: dict | None = None
                  ) -> torch.Tensor:
    """Plain PyTorch version of the ``connect`` kernel.  ``lv_tab`` is a
    (V, 40) table shared by every lane, or (T, Kp, 40) with lane ``i``
    reading tile ``i // tile_lanes``.  Lanes that are not ``act`` get 0.  ``counts``
    (from ``new_counts``), if given, gains this sweep's work
    (``PLAIN_COUNTS``)."""
    _tally(counts, "vertices", act)
    B = ev_pos.shape[0]
    out = torch.zeros((B, 3), device=ev_pos.device)
    tiles = lv_tab[None] if lv_tab.dim() == 2 else lv_tab
    span = max(B, 1) if lv_tab.dim() == 2 else tile_lanes
    if span <= 0:
        raise ValueError("connect_plain: a tiled table needs tile_lanes > 0")
    step = max(1, _PLAIN_CHUNK // (3 * _ROW_CHUNK))
    for t in range(tiles.shape[0]):
        R = tiles[t, :n_valid]
        lanes = torch.nonzero(act[t * span:(t + 1) * span])[:, 0] + t * span
        for a in range(0, lanes.shape[0], step):
            ln = lanes[a:a + step]
            m = Material(base_color=ev_mtl.base_color[ln],
                         roughness=ev_mtl.roughness[ln],
                         metallic=ev_mtl.metallic[ln], eta=ev_mtl.eta[ln])
            args = (ev_pos[ln], ev_normal[ln], ev_tp[ln], m, wo_e[ln],
                    wo_s[ln], eye_f[ln], clamp_val, dielectrics_block,
                    counts)
            out[ln] = _connect_rows(packed, R, *args)
    return out


