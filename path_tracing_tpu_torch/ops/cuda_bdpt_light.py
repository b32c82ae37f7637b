"""The BDPT light trace in one launch.  It replaces no TPU kernel: the JAX
package traces the light subpaths as an XLA ``lax.scan`` around
``nearest_hit_pallas`` (``path_tracing_tpu.integrators.bdpt.
trace_light_paths``).

``light_trace`` bounces ``P`` light subpaths from their emission sample
into a ``(P, L, ...)`` ``LightVertices``, ``L = light_depth``: vertex 0 is
the emitter, a non-delta bounce stores a vertex in the next slot, a hit on
a light ball stores a terminal light vertex, delta bounces spend no slot.
Iteration ``it`` draws rows 0-2 of ``iter_key(fold_in(key, 0x11F7), it)``
at the path's lane of a ``total``-path trace; a path is at most ``iters``
iterations long.  The epilogue drops vertices whose throughput is below
1e-6, points ``wo`` toward the previous stored vertex (the emission
direction at vertex 0) and computes the light-side MIS factor ``mis_a``.

CUDA tensors launch ``bdpt_light`` of ``csrc/bdpt_kernels.cu`` (on a
textured scene its textured instance, ``bdpt_light_tex``, which multiplies
the texel into a textured triangle's base color) or raise.  CPU tensors,
and ``plain=True`` (BDPT's ``plain`` tier), take ``light_trace_plain``:
the same loop in PyTorch over the nearest-hit and Threefry wrappers, or
over their plain versions given ``plain=True``; given a ``counts`` dict
(``new_counts``) it walks on the plain nearest hit and counts the kernel's
work (``COUNT_NAMES``).  Each call counts
``bdpt.light_kernel`` or ``bdpt.light_plain`` (``profiling.count``);
``occupancy`` reports every instance's resident blocks, registers and
spills.  ``light_vertex_bits`` lays the vertices out as 32-bit words, one
row a vertex, for the bit-for-bit comparisons.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..profiling import count, span
from ..scene.types import Material, Scene
from . import _kernels, rng
from .bsdf import bsdf_pdf, bsdf_sample
from .cuda_intersect import (PackedScene, atlas_args, check_tables,
                             check_tensor, nearest_hit, nearest_hit_plain,
                             table_args)
from .intersect import packed_hit
from .math3 import EPSILON, PI, dot, is_valid_color, length, normalize
from .sampling import EmissionSample

LIGHT_STREAM = 0x11F7
PDF_FWD_FLOOR = 1e-8   # the fmaxf clamp of both MIS walks
# The plain loop's counts of the kernel's work: the walk's sphere, box and
# triangle tests (in the kernel's cluster order), the paths, the walks (one
# an iteration of a live path), the BSDF samples (a hit past the light-ball
# test and the guards), the reverse pdfs (one a stored surface vertex), the
# draws (three a sample), the vertices stored past the emitter, and
# ``iteration_keys``, the iterations any path sampled in (the distinct
# fold_in keys, which a bound charges once each, as the kernel's per-path
# fold_in is not the algorithm's).
COUNT_NAMES = ("hit_spheres", "hit_boxes", "hit_tris", "paths", "walks",
               "bsdf_samples", "pdfs", "draws", "stored", "iteration_keys")


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


def light_vertex_bits(lv: LightVertices) -> torch.Tensor:
    """The vertices' 13 fields as 32-bit words, one row a vertex (28
    words: the bools as 0.0 / 1.0)."""
    f = lv.flat()
    col = [f.pos, f.normal, f.throughput, f.mtl.base_color, f.mtl.roughness,
           f.mtl.metallic, f.mtl.eta, f.pdf_fwd, f.pdf_rev,
           f.is_light_source.float(), f.source_cutoff, f.is_parallel.float(),
           f.emit_dir, f.wo, f.mis_a, f.valid.float()]
    return torch.cat([x if x.dim() == 2 else x[:, None] for x in col],
                     dim=1).view(torch.int32)


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES}


def light_trace_plain(packed: PackedScene, scene: Scene, emit: EmissionSample,
                      tp0, real, key, light_depth: int, iters: int,
                      start: int = 0, total: int | None = None,
                      plain: bool = False,
                      counts: dict | None = None) -> LightVertices:
    """Plain PyTorch version of the ``bdpt_light`` kernel: the trace as a
    loop over every path, four host reads an iteration.  ``plain`` runs
    the plain nearest hit and Threefry; ``counts`` (``new_counts``), if
    given, gains the kernel's work, its walks counted by the plain nearest
    hit."""
    _kernels.plain_calls["bdpt_light"] += 1
    nearest = nearest_hit_plain if plain else nearest_hit
    if counts is not None:
        nearest = functools.partial(nearest_hit_plain, counts=counts)
        counts["paths"] += emit.origin.shape[0]
    draw = rng.uniform_rows_plain if plain else rng.uniform_rows
    P, L = emit.origin.shape[0], light_depth
    dev = emit.origin.device
    f32 = dict(device=dev, dtype=torch.float32)
    li = (start + torch.arange(P, device=dev)) % scene.num_lights

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
    k_it = rng.fold_in(key, LIGHT_STREAM)
    for it in range(iters):
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
        if counts is not None:
            n_sampled = int(ok.sum())
            counts["walks"] += int(alive.sum())
            counts["bsdf_samples"] += n_sampled
            counts["draws"] += 3 * n_sampled
            counts["pdfs"] += int(store_surf.sum())
            counts["stored"] += int((store_light | store_surf).sum())
            counts["iteration_keys"] += int(n_sampled > 0)

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


def light_trace(packed: PackedScene, scene: Scene, emit: EmissionSample, tp0,
                real, key, light_depth: int, iters: int, start: int = 0,
                total: int | None = None, plain: bool = False
                ) -> LightVertices:
    """The light trace of paths with emission sample ``emit`` (origin and
    direction (P, 3)), emitted throughput ``tp0`` (P, 3) and ``real`` (P,)
    bool (the paths that exist), path ``i`` from light ``(start + i) %
    scene.num_lights``, from the trace's key ``key`` (a host tensor: its
    fold_in runs on the host, with no device round trip).
    ``start``/``total``: the paths are rows [start, start + P) of a
    ``total``-path trace."""
    if light_depth < 1:
        raise ValueError(f"light_trace: light_depth {light_depth} leaves "
                         "no slot for the emitter")
    if plain or emit.origin.device.type == "cpu":
        count("bdpt.light_plain")
        return light_trace_plain(packed, scene, emit, tp0, real, key,
                                 light_depth, iters, start, total, plain)
    out = _launch(packed, scene, emit, tp0, real, key, light_depth, iters,
                  start, total)
    count("bdpt.light_kernel")
    return out


def _launch(packed, scene, emit, tp0, real, key, L, iters, start, total):
    P = emit.origin.shape[0]
    total = P if total is None else total
    if 3 * total >= 2 ** 32 or start < 0 or start + P > total:
        raise ValueError(f"light_trace: paths [{start}, {start + P}) of a "
                         f"{total}-path trace do not fit the 32-bit Threefry "
                         "counters")
    nl = scene.num_lights
    if nl < 1:
        raise ValueError("light_trace: the scene has no light")
    dev = emit.origin.device
    for arg, x in (("origin", emit.origin), ("direction", emit.direction),
                   ("tp0", tp0)):
        check_tensor(arg, x, (P, 3))
    check_tensor("real", real, (P,), torch.bool)
    check_tensor("light_dir", scene.light_dir, (nl, 3))
    check_tensor("light_cutoff", scene.light_cutoff, (nl,))
    check_tensor("light_is_parallel", scene.light_is_parallel, (nl,),
                 torch.int32)
    check_tables(packed, dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty((P, L, *shape), dtype=dtype, device=dev)

    pos, normal, tp, bc, emit_dir, wo = (empty(3) for _ in range(6))
    rough, metal, eta, pdf_fwd, pdf_rev, cutoff, mis_a = (empty()
                                                          for _ in range(7))
    is_light, parallel, valid = (empty(dtype=torch.bool) for _ in range(3))
    if P:
        k0, k1 = (int(w) for w in rng.fold_in(key, LIGHT_STREAM).tolist())
        name = "bdpt_light_tex" if packed.textured else "bdpt_light"
        _kernels.launch(
            name, *table_args(packed),
            *(atlas_args(packed) if packed.textured else ()),
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                emit.origin, emit.direction, tp0, real, scene.light_dir,
                scene.light_cutoff, scene.light_is_parallel)),
            nl, P, k0, k1, start, total, int(L), int(iters),
            *(ctypes.c_void_p(x.data_ptr()) for x in (
                pos, normal, tp, bc, rough, metal, eta, pdf_fwd, pdf_rev,
                is_light, cutoff, parallel, emit_dir, wo, mis_a, valid)))
    return LightVertices(
        pos=pos, normal=normal, throughput=tp,
        mtl=Material(base_color=bc, roughness=rough, metallic=metal, eta=eta),
        pdf_fwd=pdf_fwd, pdf_rev=pdf_rev, is_light_source=is_light,
        source_cutoff=cutoff, is_parallel=parallel, emit_dir=emit_dir, wo=wo,
        mis_a=mis_a, valid=valid)


OCCUPANCY_KERNELS = ("bdpt_light", "bdpt_light_super", "bdpt_light_indexed",
                     "bdpt_light_tex", "bdpt_light_tex_super",
                     "bdpt_light_tex_indexed")


def occupancy() -> dict:
    """Per instance of ``bdpt_light`` (the flat, super and indexed walks',
    untextured, then textured): resident blocks and warps per SM, threads
    per block, registers and local (spill) bytes per thread, shared
    bytes."""
    out = (ctypes.c_int * (5 * len(OCCUPANCY_KERNELS)))()
    fn = _kernels.library().libs["bdpt_kernels"].pt_bdpt_light_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_bdpt_light_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(OCCUPANCY_KERNELS, out)
