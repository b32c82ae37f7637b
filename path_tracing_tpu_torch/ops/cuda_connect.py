"""BDPT eye-light connections (counterpart of
``path_tracing_tpu.ops.pallas_connect``).

``pack_light_vertices`` lays the light-vertex set out as the ``(V, 40)``
float32 table the kernels read, column for column the JAX package's table:

    [pos3, normal3, tp3, bc3, rough, metal, eta, is_src, cutoff, is_par,
     emit_dir3, wo3, mis_a, valid, tangent3, bitangent3, wo_local3, alpha,
     cos_cutoff, 0, 0, 0]

with rows padded to a multiple of 8.  The light side's shading frame, its
local outgoing direction, GGX alpha and cone cosine are computed once here.

``connect`` sums, per eye vertex, the contributions of rows
``[0, n_valid)`` of the table: geometry term, both BSDF evaluations, the
shadow ray and the O(1) balance-heuristic MIS weight, each contribution
validity-checked and clamped, added row after row; lanes that are not
active get 0.  On CUDA tensors it launches the ``connect`` kernel
(``csrc/bdpt_kernels.cu``: persistent warps sweep the active lanes only,
taking spans of lanes from a counter the wrapper zeroes); on CPU tensors
it runs ``connect_plain``, the same sum in PyTorch; any other device
raises.  On a legacy-Ks scene under the GPU rule the shadow factor is RGB
(``cuda_intersect.transmittance_rgb_plain``; the kernel's RGB instance
``connect_rgb``): each pair's ``tp fE fL Le`` times the factor times G MIS,
gated by any(factor > 0), as the JAX package's ``_connect`` applies
``shadow_factor``.  Given ``vidx`` (B, M) each lane sums its own M rows
of the table instead (``sample_rows`` draws them as the JAX package's
``_connect_sampled`` does), in chunks of ``sample_chunk(M)`` samples, then
times ``sampled_scale``: the kernel's sampled instance
``connect_sampled``.  ``connect_counts`` launches the kernel's counting
build, which also returns the work it did (``COUNT_NAMES``); given a
``counts`` dict,
the plain version counts the same work (``PLAIN_COUNTS``), the shadow
walks' tests as the kernels walk them.  The reference's quirks are kept as
``connect_core`` keeps them:
the evaluations take the unit direction and both MIS pdfs the direction
scaled by the distance; pdfs are floored at 1e-6; the spot-cone gate;
``G = cos_e cos_l / max(d^2, 1e-4)``; the distance-scaled area
conversions; ``1 / (1 + pdf_t_to_s eye_f + pdf_s_to_t mis_a)``.
"""
from __future__ import annotations

import ctypes

import torch

from ..profiling import span
from ..scene.types import Material
from . import _kernels
from .bsdf import _eval_local, _half_vector, _pdf_local
from .cuda_intersect import (PackedScene, any_blocker_plain, check_legacy,
                             check_tables, check_tensor, table_args,
                             transmittance_rgb_plain)
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
                  dielectrics_block: bool, counts=None, mc: int = 0
                  ) -> torch.Tensor:
    """The connection sum of every given lane (all active), in PyTorch:
    against the shared rows ``R`` (C, 40) in slabs of ``_ROW_CHUNK`` rows,
    the contributions added row after row as the kernel adds them; or,
    with ``mc`` > 0, against each lane's own rows ``R`` (lanes, M, 40),
    added within each chunk of ``mc`` samples and then chunk after chunk,
    as the JAX package's ``_connect_sampled`` sums them.  Shadow rays only
    for the pairs that pass every other gate."""
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
    rgb = dielectrics_block and packed.has_legacy
    if mc:
        for r0 in range(0, R.shape[1], mc):
            contrib = _pair_contribs(packed, R[:, r0:r0 + mc], eye, clamp_val,
                                     dielectrics_block, rgb, counts)
            part = torch.zeros_like(acc)
            for c in range(contrib.shape[1]):
                part = part + contrib[:, c]
            acc = acc + part
        return acc
    for r0 in range(0, R.shape[0], _ROW_CHUNK):
        contrib = _pair_contribs(packed, R[None, r0:r0 + _ROW_CHUNK], eye,
                                 clamp_val, dielectrics_block, rgb, counts)
        for c in range(contrib.shape[1]):
            acc = acc + contrib[:, c]
    return acc


def _pair_contribs(packed: PackedScene, C: torch.Tensor, eye: dict,
                   clamp_val: float, dielectrics_block: bool, rgb: bool,
                   counts) -> torch.Tensor:
    """Each (lane, row) pair's contribution, (lanes, rows, 3): ``C`` is
    (1, rows, 40), rows every lane shares, or (lanes, rows, 40).  ``rgb``:
    the RGB shadow of a legacy-Ks scene (``transmittance_rgb_plain``),
    multiplied in before G MIS and gated by any(factor > 0), as the JAX
    package's ``_connect`` applies ``shadow_factor``; else the binary
    shadow ray."""
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
    if rgb:
        tr = torch.ones(gate.shape + (3,), device=ev_pos.device)
        tr[lane, row] = transmittance_rgb_plain(packed, q1, srd, md,
                                                counts=counts)
        gate = gate & torch.any(tr > 0.0, dim=-1)
        contrib = (eye["tp"][:, None] * f_e * f_l * ltp * tr
                   * (g_term * mis_w)[..., None])
    else:
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
                  tile_lanes: int = 0, counts: dict | None = None,
                  vidx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ``connect`` kernel (and of its RGB and
    sampled instances).  ``lv_tab`` is a (V, 40) table shared by every
    lane, or (T, Kp, 40) with lane ``i`` reading tile ``i // tile_lanes``.
    ``vidx`` (B, M) int32: each lane sums its own rows ``vidx[i]`` of the
    shared table instead, in chunks of ``sample_chunk(M)``, times
    ``sampled_scale``.  Lanes that are not ``act`` get 0.  ``counts``
    (from ``new_counts``), if given, gains this sweep's work
    (``PLAIN_COUNTS``)."""
    _kernels.plain_calls["connect"] += 1
    _tally(counts, "vertices", act)
    B = ev_pos.shape[0]
    out = torch.zeros((B, 3), device=ev_pos.device)
    tiles = lv_tab[None] if lv_tab.dim() == 2 else lv_tab
    span = max(B, 1) if lv_tab.dim() == 2 else tile_lanes
    if span <= 0:
        raise ValueError("connect_plain: a tiled table needs tile_lanes > 0")
    if vidx is not None and lv_tab.dim() != 2:
        raise ValueError("connect_plain: vidx needs a shared (V, 40) table")
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
            if vidx is None:
                out[ln] = _connect_rows(packed, R, *args)
            else:
                M = vidx.shape[1]
                out[ln] = _connect_rows(
                    packed, lv_tab[vidx[ln].long()], *args,
                    mc=sample_chunk(M)) * sampled_scale(n_valid, M)
    return out


def sample_chunk(M: int) -> int:
    """The samples the sampled sum adds up before adding across them: the
    first of 8, 4, 2, 1 that divides M, as the JAX package's
    ``_connect_sampled`` chunks its sample axis."""
    return next(c for c in (8, 4, 2, 1) if M % c == 0)


def sampled_scale(n_valid: int, M: int) -> torch.Tensor:
    """``max(n_valid, 1) / M`` in float32, the sampled sum's scale."""
    return (torch.tensor(float(max(n_valid, 1)), dtype=torch.float32)
            / torch.tensor(float(M), dtype=torch.float32))


def sample_rows(draw, key, B: int, M: int, n_valid: int, start: int = 0,
                total: int | None = None, device=None) -> torch.Tensor:
    """Each lane's M stratified rows of the compacted table, (B, M) int32,
    as the JAX package's ``_connect_sampled`` draws them: rows ``j`` of
    ``draw(key, B, M, start, total)`` (``rng.uniform_rows`` or its plain
    version; ``key`` = ``fold_in(k, 0x5E1)`` of the bounce's key ``k``),
    ``min(int((j + u) * (nv / M)), nv - 1)`` with ``nv = max(n_valid,
    1)``."""
    nv = max(n_valid, 1)
    u = draw(key, B, M, start, total, device=device)
    j = torch.arange(M, dtype=torch.float32, device=u.device)[:, None]
    with span("sync.bdpt_conn_step"):
        step = torch.tensor(float(nv), dtype=torch.float32, device=u.device)
    step = step / float(M)
    v = torch.clamp(((j + u) * step).to(torch.int32), max=nv - 1)
    return v.t().contiguous()


def check_table(lv_tab: torch.Tensor, n_valid: int, dims=(2,)) -> None:
    """A CUDA (V, 40) table (``dims`` 2) or (T, Kp, 40) one (3) holding at
    least ``n_valid`` rows per table."""
    if (lv_tab.dim() not in dims or lv_tab.shape[-1] != LV_COLS
            or not 0 <= n_valid <= lv_tab.shape[-2]):
        raise ValueError(f"light-vertex table {tuple(lv_tab.shape)} with "
                         f"n_valid={n_valid}: expected {dims}-d rows of "
                         f"{LV_COLS} columns holding n_valid rows")
    check_tensor("lv_tab", lv_tab, tuple(lv_tab.shape))


def connect(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int,
            ev_pos, ev_normal, ev_tp, ev_mtl: Material, wo_e, wo_s, eye_f,
            act, *, clamp_val: float, dielectrics_block: bool,
            vidx: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of connection contributions per eye lane, (B, 3), against rows
    ``[0, n_valid)`` of the shared (V, 40) table ``lv_tab``, or with
    ``vidx`` (B, M) int32 against each lane's M sampled rows (scaled by
    ``n_valid / M``).  Inputs are (B, 3) positions, normals (facing the
    incoming ray), throughputs, ``wo_e`` and ``wo_s``; the (B,) material,
    ``eye_f`` and ``act``.  On CUDA tensors it launches ``connect``, or on
    a legacy-Ks scene under the GPU rule ``connect_rgb`` (the RGB shadow),
    or with ``vidx`` ``connect_sampled`` (with the RGB shadow on such a
    scene)."""
    args = (packed, lv_tab, n_valid, ev_pos, ev_normal, ev_tp, ev_mtl, wo_e,
            wo_s, eye_f, act)
    if ev_pos.device.type == "cpu":
        return connect_plain(*args, clamp_val=clamp_val,
                             dielectrics_block=dielectrics_block, vidx=vidx)
    rgb = dielectrics_block and packed.has_legacy
    name = ("connect_sampled" if vidx is not None
            else "connect_rgb" if rgb else "connect")
    return _launch(name, args, clamp_val, dielectrics_block, vidx)[0]


def connect_counts(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int,
                   ev_pos, ev_normal, ev_tp, ev_mtl: Material, wo_e, wo_s,
                   eye_f, act, *, clamp_val: float, dielectrics_block: bool
                   ) -> tuple:
    """``connect`` through the kernel's counting build: (the same sums, the
    counters as a dict keyed by ``COUNT_NAMES``).  CUDA tensors only; the
    binary shadow only (the RGB instance has no counting build)."""
    if dielectrics_block and packed.has_legacy:
        raise ValueError("connect_counts: no counting build of the RGB "
                         "shadow (a legacy-Ks scene)")
    args = (packed, lv_tab, n_valid, ev_pos, ev_normal, ev_tp, ev_mtl, wo_e,
            wo_s, eye_f, act)
    return _launch("connect_counts", args, clamp_val, dielectrics_block)


def counts_buffer(device) -> torch.Tensor:
    """The zeroed buffer a counting build adds into (uint64 on the
    card; int64 here, every count staying below 2**63)."""
    return torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=device)


def read_counts(buf: torch.Tensor) -> dict:
    return dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))


def _launch(name: str, args, clamp_val: float, dielectrics_block: bool,
            vidx=None):
    (packed, lv_tab, n_valid, ev_pos, ev_normal, ev_tp, ev_mtl, wo_e, wo_s,
     eye_f, act) = args
    B = ev_pos.shape[0]
    vec3 = (ev_pos, ev_normal, ev_tp, ev_mtl.base_color, wo_e, wo_s)
    for nm, x in zip(("ev_pos", "ev_normal", "ev_tp", "base_color", "wo_e",
                      "wo_s"), vec3):
        check_tensor(nm, x, (B, 3))
    for nm, x in (("roughness", ev_mtl.roughness),
                  ("metallic", ev_mtl.metallic), ("eta", ev_mtl.eta),
                  ("eye_f", eye_f)):
        check_tensor(nm, x, (B,))
    check_tensor("act", act, (B,), torch.bool)
    check_table(lv_tab, n_valid)
    check_tables(packed, ev_pos.device)
    rgb = dielectrics_block and packed.has_legacy
    head = []      # the RGB and sampled instances' legacy rows (or null)
    if name in ("connect_rgb", "connect_sampled"):
        if rgb:
            check_legacy(packed)
        head = [ctypes.c_void_p(packed.legacy.data_ptr() if rgb else None)]
    tail = []      # the sampled instance's rows and M
    if name == "connect_sampled":
        check_tensor("vidx", vidx, (B, vidx.shape[1]), torch.int32)
        if vidx.shape[1] < 1 or lv_tab.shape[0] < max(n_valid, 1):
            raise ValueError(f"connect_sampled: M = {vidx.shape[1]} rows a "
                             f"lane of a {lv_tab.shape[0]}-row table")
        tail = [ctypes.c_void_p(vidx.data_ptr()), vidx.shape[1]]
    out = torch.empty((B, 3), device=ev_pos.device)
    counted = name.endswith("_counts")
    buf = counts_buffer(ev_pos.device) if counted else None
    if B:
        ins = [*vec3[:4], ev_mtl.roughness, ev_mtl.metallic, ev_mtl.eta,
               wo_e, wo_s, eye_f, act]
        # the next span of lanes to hand out (the kernel's persistent warps)
        work = torch.zeros(1, dtype=torch.int32, device=ev_pos.device)
        _kernels.launch(name, *table_args(packed), *head,
                        ctypes.c_void_p(lv_tab.data_ptr()), int(n_valid),
                        *[ctypes.c_void_p(x.data_ptr()) for x in ins], *tail,
                        B, float(clamp_val), 4 if dielectrics_block else 5,
                        ctypes.c_void_p(work.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()),
                        *([ctypes.c_void_p(buf.data_ptr())] if counted
                          else []))
    return out, (read_counts(buf) if counted else None)
