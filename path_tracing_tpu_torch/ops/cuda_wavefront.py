"""The PT megakernel (counterpart of
``path_tracing_tpu.ops.pallas_shade.render_wavefront_pallas``).

``render_wavefront`` renders every sample of every pixel in one launch of
the CUDA kernel ``render_wavefront`` (``csrc/pt_kernels.cu``): persistent
threads each run one pixel's regenerating wavefront loop, with the bounce
of ``shade_step`` and the uniforms drawn in the kernel, and take the next
pixel from a global counter when it is done (the wrapper zeroes it).
Iteration ``it`` of pixel ``i`` draws from ``fold_in(key, it)`` at the
counters that ``uniform_rows(iter_key(key, it), B, 8, start, total)``
gives lane ``i``, so the image equals the per-bounce tier's
(``integrators/pt.py::wavefront_loop`` with ``shade_step``) pixel for
pixel.  The TPU kernel drew
from its on-core PRNG instead, so its image is equal to the per-bounce
tier's only in distribution.

``render_wavefront_plain`` is the same function in PyTorch: the per-bounce
loop with the plain step and the plain Threefry draws; given a ``counts``
dict (``new_counts``) it counts the kernel's work (``PLAIN_COUNTS``: the
walks' tests in the kernel's cluster order).  ``render_wavefront_counts``
launches the kernel's counting build, which returns the same image and the
work it did (``COUNT_NAMES``); ``occupancy`` reports both builds' resident
blocks, registers and spills.  Untextured scenes without legacy Ks only,
as on the TPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels, rng
from .cuda_connect import COUNT_NAMES as _WALK_NAMES
from .cuda_intersect import (PackedScene, camera_table, check_tables,
                             check_tensor, table_args)
from .cuda_shade import LIGHT_COLS, shade_step_plain

# The counting build's counters: those of the BDPT kernels
# (``cuda_connect.COUNT_NAMES``, of which #5 fills the paths started, the
# NEE evaluations, pdfs and shadow rays, the walks' tests and the shadow
# step's and a shadow walk's triangle test's lanes and slots), then the
# iterations (bounces, each a nearest-hit walk), the BSDF samples, the
# Threefry draws (a fold_in an iteration, 2 a path, 3 an NEE ray, 3 a BSDF
# sample), the lanes and slots of the walk and of the shade, and 32 times
# each warp's most iterations in one lane (iterations over it: the share a
# warp's lanes are busy), then, of the instance for scenes with a sphere
# index, the wide rays walked by their warp and the warp steps those walks
# took (``csrc/pt_kernels.cu::warp_sphere_walk``; the plain loop's walk
# model counts them, and the walks' tests, as that instance makes them).
# The plain version counts ``PLAIN_COUNTS`` and
# ``PLAIN_ONLY``: ``pixel_warp_slots``, the last for one thread per pixel in
# warps of 32 consecutive pixels (the design before work stealing), and
# ``iteration_keys``, the iterations of the frame (the distinct fold_in
# keys, which the bound charges once each).
COUNT_NAMES = _WALK_NAMES + (
    "iterations", "bsdf_samples", "draws", "walk_lanes", "walk_slots",
    "shade_lanes", "shade_slots", "warp_iter_slots", "wide_walks",
    "wide_steps")
PLAIN_COUNTS = ("samples", "evals", "pdfs", "shadow_rays", "hit_spheres",
                "hit_boxes", "hit_tris", "shadow_spheres", "shadow_boxes",
                "shadow_tris", "iterations", "bsdf_samples", "draws",
                "wide_walks", "wide_steps")
PLAIN_ONLY = ("pixel_warp_slots", "iteration_keys")


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES + PLAIN_ONLY}


def render_wavefront_plain(packed: PackedScene, light_tab, cam, px, py,
                           spp: int, cfg, key, start: int = 0,
                           total: int | None = None,
                           counts: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ``render_wavefront`` kernel
    (``counts``: see the module's notes)."""
    from ..integrators.pt import wavefront_loop

    _kernels.plain_calls["render_wavefront"] += 1
    step = (shade_step_plain if counts is None
            else functools.partial(shade_step_plain, counts=counts,
                                   warp_walk=True))
    return wavefront_loop(packed, light_tab, cam, cfg, px, py, spp, key,
                          start, total, step, rng.uniform_rows_plain,
                          counts=counts)


def render_wavefront(packed: PackedScene, light_tab, cam, px, py, spp: int,
                     cfg, key, start: int = 0, total: int | None = None
                     ) -> torch.Tensor:
    """The per-pixel radiance SUM over ``spp`` samples, (B, 3), for pixel
    indices ``px``, ``py`` (B,) int32.  ``start``/``total``: the lanes are
    columns [start, start + B) of a global ``total``-lane render."""
    if px.device.type == "cpu":
        return render_wavefront_plain(packed, light_tab, cam, px, py, spp,
                                      cfg, key, start, total)
    return _launch("render_wavefront", packed, light_tab, cam, px, py, spp,
                   cfg, key, start, total)[0]


def render_wavefront_counts(packed: PackedScene, light_tab, cam, px, py,
                            spp: int, cfg, key, start: int = 0,
                            total: int | None = None) -> tuple:
    """``render_wavefront`` through the kernel's counting build: (the same
    image, the counters as a dict keyed by ``COUNT_NAMES``).  CUDA tensors
    only."""
    return _launch("render_wavefront_counts", packed, light_tab, cam, px, py,
                   spp, cfg, key, start, total)


def _launch(name, packed, light_tab, cam, px, py, spp, cfg, key, start,
            total):
    if packed.textured:
        raise ValueError("render_wavefront: textured scenes take the "
                         "per-bounce tier")
    B = px.shape[0]
    total = B if total is None else total
    if 8 * total >= 2 ** 32 or start < 0 or start + B > total:
        raise ValueError(f"render_wavefront: lanes [{start}, {start + B}) "
                         f"of a {total}-lane render do not fit the 32-bit "
                         "Threefry counters")
    check_tensor("px", px, (B,), torch.int32)
    check_tensor("py", py, (B,), torch.int32)
    check_tensor("light_tab", light_tab, (packed.nl, LIGHT_COLS))
    check_tables(packed, px.device)
    cam_tab = camera_table(cam, px.device)
    out = torch.empty((B, 3), device=px.device)
    work = torch.zeros(1, dtype=torch.int32, device=px.device)
    counted = name.endswith("_counts")
    buf = (torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=px.device)
           if counted else None)
    if B:
        k0, k1 = (int(w) for w in key.tolist())
        _kernels.launch(
            name, *table_args(packed),
            ctypes.c_void_p(light_tab.data_ptr()),
            ctypes.c_void_p(cam_tab.data_ptr()),
            ctypes.c_void_p(px.data_ptr()), ctypes.c_void_p(py.data_ptr()),
            B, spp, cfg.eye_depth, cfg.max_eye_iters,
            spp * cfg.max_eye_iters + cfg.max_eye_iters, k0, k1, start,
            total, float(cfg.clamp), int(cfg.pt_stub_mis_strategy_a),
            4 if cfg.shadow_dielectrics_block else 5,
            ctypes.c_void_p(work.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            *([ctypes.c_void_p(buf.data_ptr())] if counted else []))
    counts = (dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))
              if counted else None)
    return out, counts


OCCUPANCY_KERNELS = ("render_wavefront", "render_wavefront_counts")


def occupancy() -> dict:
    """Per build of #5: resident blocks and warps per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads per block,
    registers and local (spill) bytes per thread, shared bytes."""
    out = (ctypes.c_int * (5 * len(OCCUPANCY_KERNELS)))()
    fn = _kernels.library().libs["pt_kernels"].pt_mega_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_mega_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(OCCUPANCY_KERNELS, out)
