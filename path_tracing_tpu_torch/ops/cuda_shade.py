"""The fused PT bounce (counterpart of ``path_tracing_tpu.ops.pallas_shade``).

``shade_step`` runs one bounce of every lane of the wavefront: nearest hit,
light-ball emission, next-event estimation with its shadow ray, the BSDF
sample and the path-state update.  It takes and returns what
``shade_step_pallas`` does; the six uniforms per lane come in as rows of
``u``, so the step matches the plain bounce lane by lane.

The step functions share that signature:

- ``shade_step``: the wrapper of the CUDA kernel ``shade_step`` (CPU tensors
  take ``shade_step_plain``); ``shade_step_counts`` launches its counting
  build, held to the plain version's counts (``STEP_COUNTS``), and
  ``occupancy`` reports both builds' registers, spills and resident
  blocks;
- ``shade_step_plain``: the plain PyTorch bounce (the JAX package's XLA
  bounce body) on the plain nearest-hit and any-blocker sweeps;
- ``shade_step_split``: the same PyTorch bounce on the nearest-hit and
  any-blocker wrappers, so on CUDA it launches those two kernels and shades
  with PyTorch (the JAX package's Pallas-intersect / XLA-shade tier);
  ``tex=True`` textures it; on a legacy-Ks scene the NEE shadow is
  ``transmittance_rgb``'s RGB factor (the plain bounces take its plain
  version), the JAX package's XLA route for those scenes;
- ``shade_step_stream``: the same PyTorch bounce on the sorted streamed
  nearest-hit and any-blocker of ``ops/cuda_stream.py`` (#6/#7), the JAX
  package's per-bounce body on meshes above the resident ceiling;
- ``shade_step_tex`` / ``shade_step_tex_plain``: the textured bounce of
  ``shade_step_tex_pallas`` (the ``with_uv`` hit, the bilinear texel
  multiplied into a textured triangle's base color, then the bounce).  The
  JAX package runs it as three steps (its nearest-hit kernel, an XLA
  gather, its shade kernel); the CUDA kernel does all three per lane.
  ``shade_step_tex_counts`` launches its counting build, held to the
  plain version's counts (``STEP_COUNTS``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels
from .bsdf import bsdf_sample
from .cuda_intersect import (PackedScene, any_blocker, any_blocker_plain,
                             atlas_args, check_tables, check_tensor,
                             nearest_hit, nearest_hit_plain, table_args,
                             transmittance_rgb, transmittance_rgb_plain)
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
            dielectrics_block, nearest, blocker, tex=False, rgb=None,
            counts=None) -> dict:
    """One PT bounce in PyTorch with the given intersection functions;
    ``tex`` textures the hit.  ``nearest`` gets the active lanes and
    ``blocker`` the NEE-eligible ones as ``live=`` (the lanes whose result
    is read: the kernels walk only those).  ``rgb``, the RGB shadow
    function (``transmittance_rgb`` or its plain version), takes the
    blocker's place on a legacy-Ks scene under the GPU rule, as the JAX
    package's ``shadow_factor`` does.  ``counts``, if
    given, gains the megakernel's work of the bounce (its active lanes as
    ``iterations``, NEE rays with their evaluation, pdf and draws, BSDF
    samples with theirs) and is handed to the intersection functions,
    which count their walks' tests."""
    from ..integrators.pt import _light_emission_radiance, _nee

    nl = light_tab.shape[0]
    if counts is not None:
        counts["iterations"] += int(act.sum())
        nearest = functools.partial(nearest, counts=counts)
        blocker = functools.partial(blocker, counts=counts)
        if rgb is not None:
            rgb = functools.partial(rgb, counts=counts)
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
        if rgb is not None and dielectrics_block and packed.has_legacy:
            def shadow(p1, srd, max_d):
                return rgb(packed, p1, srd, max_d, live=elig)
        else:
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
                     dielectrics_block, counts=None,
                     warp_walk: bool = False) -> dict:
    """Plain PyTorch version of the ``shade_step`` kernel.  ``counts``
    (``cuda_wavefront.new_counts()``), if given, gains the work its
    counting build counts (``STEP_COUNTS``: see ``_bounce``); with
    ``warp_walk`` the walks' tests as #5 makes them
    (``nearest_hit_plain``'s)."""
    _kernels.plain_calls["shade_step"] += 1
    nearest = (functools.partial(nearest_hit_plain, warp_walk=True)
               if warp_walk else nearest_hit_plain)
    return _bounce(packed, light_tab, ro, rd, tp, eta, depth, act,
                   last_delta, last_pdf, u, clamp_val=clamp_val,
                   stub_mis=stub_mis, dielectrics_block=dielectrics_block,
                   nearest=nearest, blocker=any_blocker_plain,
                   rgb=transmittance_rgb_plain, counts=counts)


def shade_step_split(packed, light_tab, ro, rd, tp, eta, depth, act,
                     last_delta, last_pdf, u, *, clamp_val, stub_mis,
                     dielectrics_block, tex=False) -> dict:
    """The PyTorch bounce on the nearest-hit and any-blocker wrappers (on
    a legacy-Ks scene the RGB shadow's, ``transmittance_rgb``)."""
    return _bounce(packed, light_tab, ro, rd, tp, eta, depth, act,
                   last_delta, last_pdf, u, clamp_val=clamp_val,
                   stub_mis=stub_mis, dielectrics_block=dielectrics_block,
                   nearest=nearest_hit, blocker=any_blocker, tex=tex,
                   rgb=transmittance_rgb)


def shade_step_stream(st, light_tab, ro, rd, tp, eta, depth, act, last_delta,
                      last_pdf, u, *, clamp_val, stub_mis, dielectrics_block,
                      tex=False) -> dict:
    """The PyTorch bounce on the streamed tables ``st``
    (``ops/cuda_stream.py``), as the JAX package's per-bounce body runs
    above the resident ceiling: the hit from #6 on rays sorted with the
    active lanes live, the NEE shadow rays through #7 sorted with the
    NEE-eligible lanes live; ``tex`` textures the hit."""
    from .cuda_stream import stream_blocked, stream_hit

    return _bounce(st, light_tab, ro, rd, tp, eta, depth, act, last_delta,
                   last_pdf, u, clamp_val=clamp_val, stub_mis=stub_mis,
                   dielectrics_block=dielectrics_block, nearest=stream_hit,
                   blocker=stream_blocked, tex=tex)


def shade_step_tex_plain(packed, light_tab, ro, rd, tp, eta, depth, act,
                         last_delta, last_pdf, u, *, clamp_val, stub_mis,
                         dielectrics_block, counts=None) -> dict:
    """Plain PyTorch version of the ``shade_step_tex`` kernel.
    ``counts`` (``cuda_wavefront.new_counts()``), if given, gains the work
    its counting build counts (``STEP_COUNTS``: see ``_bounce``)."""
    _kernels.plain_calls["shade_step_tex"] += 1
    return _bounce(packed, light_tab, ro, rd, tp, eta, depth, act,
                   last_delta, last_pdf, u, clamp_val=clamp_val,
                   stub_mis=stub_mis, dielectrics_block=dielectrics_block,
                   nearest=nearest_hit_plain, blocker=any_blocker_plain,
                   tex=True, rgb=transmittance_rgb_plain, counts=counts)


def _launch_step(name, extra, packed, light_tab, ro, rd, tp, eta, depth,
                 act, last_delta, last_pdf, u, clamp_val, stub_mis,
                 dielectrics_block, counts=None) -> dict:
    """Check the inputs of a per-bounce kernel, allocate its outputs and
    launch it; ``extra`` are the ctypes arguments between the scene tables
    and the lights, ``counts`` a zeroed int64 buffer of a counting
    build's counters."""
    B = ro.shape[0]
    dev = ro.device
    for nm, x in (("ro", ro), ("rd", rd), ("tp", tp)):
        check_tensor(nm, x, (B, 3))
    check_tensor("eta", eta, (B,))
    check_tensor("depth", depth, (B,), torch.int32)
    check_tensor("act", act, (B,), torch.bool)
    check_tensor("last_delta", last_delta, (B,), torch.bool)
    check_tensor("last_pdf", last_pdf, (B,))
    if u.dim() != 2 or u.shape[0] < 6:
        raise ValueError(f"u: expected (>= 6, {B}), got {tuple(u.shape)}")
    check_tensor("u", u, (u.shape[0], B))
    check_tensor("light_tab", light_tab, (packed.nl, LIGHT_COLS))
    check_tables(packed, dev)
    out = dict(
        radiance=torch.empty((B, 3), device=dev),
        ro=torch.empty((B, 3), device=dev),
        rd=torch.empty((B, 3), device=dev),
        tp=torch.empty((B, 3), device=dev),
        eta=torch.empty(B, device=dev),
        depth=torch.empty(B, dtype=torch.int32, device=dev),
        alive=torch.empty(B, dtype=torch.bool, device=dev),
        last_is_delta=torch.empty(B, dtype=torch.bool, device=dev),
        last_pdf=torch.empty(B, device=dev),
    )
    if B:
        ins = [light_tab, ro, rd, tp, eta, depth, act, last_delta, last_pdf,
               u]
        _kernels.launch(
            name, *table_args(packed), *extra,
            *[ctypes.c_void_p(x.data_ptr()) for x in ins],
            B, float(clamp_val), int(bool(stub_mis)),
            4 if dielectrics_block else 5,
            *[ctypes.c_void_p(x.data_ptr()) for x in out.values()],
            *([] if counts is None else [ctypes.c_void_p(counts.data_ptr())]))
    return out


def shade_step(packed: PackedScene, light_tab, ro, rd, tp, eta, depth, act,
               last_delta, last_pdf, u, *, clamp_val: float, stub_mis: bool,
               dielectrics_block: bool) -> dict:
    """One fused bounce of every lane.  ``u`` is a ``(>= 6, B)`` tensor of
    uniforms (rows 0-2 NEE, 3-5 BSDF).  Returns the bounce's radiance
    (B, 3) and the updated ro, rd, tp (B, 3), eta, depth, alive,
    last_is_delta and last_pdf (B,)."""
    args = (packed, light_tab, ro, rd, tp, eta, depth, act, last_delta,
            last_pdf, u)
    if ro.device.type == "cpu":
        return shade_step_plain(*args, clamp_val=clamp_val, stub_mis=stub_mis,
                                dielectrics_block=dielectrics_block)
    return _launch_step("shade_step", [], *args, clamp_val, stub_mis,
                        dielectrics_block)


def shade_step_counts(packed: PackedScene, light_tab, ro, rd, tp, eta, depth,
                      act, last_delta, last_pdf, u, *, clamp_val: float,
                      stub_mis: bool, dielectrics_block: bool) -> tuple:
    """``shade_step`` through the kernel's counting build: (the same
    outputs, the counters as a dict keyed by
    ``cuda_wavefront.COUNT_NAMES``).  CUDA tensors only."""
    return _counted("shade_step_counts", [], packed, light_tab, ro, rd, tp,
                    eta, depth, act, last_delta, last_pdf, u, clamp_val,
                    stub_mis, dielectrics_block)


def _counted(name, extra, *args) -> tuple:
    """A per-bounce counting build's launch: (its outputs, its counters by
    ``cuda_wavefront.COUNT_NAMES``)."""
    from .cuda_wavefront import COUNT_NAMES

    buf = torch.zeros(len(COUNT_NAMES), dtype=torch.int64,
                      device=args[2].device)
    out = _launch_step(name, extra, *args, counts=buf)
    return out, dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))


def occupancy() -> dict:
    """Per build of #3 (its flat-walk instance): resident blocks and warps
    per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads
    per block, registers and local (spill) bytes per thread, shared
    bytes."""
    names = ("shade_step", "shade_step_counts")
    out = (ctypes.c_int * (5 * len(names)))()
    fn = _kernels.library().libs["pt_kernels"].pt_step_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_step_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(names, out)


def shade_step_tex(packed: PackedScene, light_tab, ro, rd, tp, eta, depth,
                   act, last_delta, last_pdf, u, *, clamp_val: float,
                   stub_mis: bool, dielectrics_block: bool) -> dict:
    """One fused textured bounce of every lane; inputs and outputs as
    :func:`shade_step`, the texture atlas from ``packed``."""
    args = (packed, light_tab, ro, rd, tp, eta, depth, act, last_delta,
            last_pdf, u)
    if ro.device.type == "cpu":
        return shade_step_tex_plain(*args, clamp_val=clamp_val,
                                    stub_mis=stub_mis,
                                    dielectrics_block=dielectrics_block)
    return _launch_step("shade_step_tex", atlas_args(packed), *args,
                        clamp_val, stub_mis, dielectrics_block)


def shade_step_tex_counts(packed: PackedScene, light_tab, ro, rd, tp, eta,
                          depth, act, last_delta, last_pdf, u, *,
                          clamp_val: float, stub_mis: bool,
                          dielectrics_block: bool) -> tuple:
    """``shade_step_tex`` through the kernel's counting build: (the same
    outputs, the counters as a dict keyed by
    ``cuda_wavefront.COUNT_NAMES``).  CUDA tensors only."""
    return _counted("shade_step_tex_counts", atlas_args(packed), packed,
                    light_tab, ro, rd, tp, eta, depth, act, last_delta,
                    last_pdf, u, clamp_val, stub_mis, dielectrics_block)
