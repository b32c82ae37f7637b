"""The PT megakernel (counterpart of
``path_tracing_tpu.ops.pallas_shade.render_wavefront_pallas``).

``render_wavefront`` (#5) renders every sample of every pixel in one
launch: persistent threads each run one pixel's regenerating wavefront
loop, with the bounce of ``shade_step`` and the uniforms drawn in the
kernel.  Iteration ``it`` of pixel ``i`` draws from ``fold_in(key, it)``
at the counters that ``uniform_rows(iter_key(key, it), B, 8, start,
total)`` gives lane ``i``, so the image equals the per-bounce loop's
(``integrators/pt.py::wavefront_loop``) pixel for pixel.

``render_wavefront_plain`` is its plain version: the per-bounce loop with
the plain step and the plain Threefry draws; given a ``counts`` dict
(``new_counts``) it counts the kernel's work (``PLAIN_COUNTS``: the
walks' tests in the kernel's cluster order), which the rooflines are
bounded by.  Untextured scenes only.
"""
from __future__ import annotations

import functools

import torch

from . import rng
from .cuda_connect import COUNT_NAMES as _WALK_NAMES
from .cuda_intersect import PackedScene
from .cuda_shade import shade_step_plain

# The counting build's counters: those of the BDPT kernels
# (``cuda_connect.COUNT_NAMES``, of which #5 fills the paths started, the
# NEE evaluations, pdfs and shadow rays, the walks' tests and the shadow
# step's and a shadow walk's triangle test's lanes and slots), then the
# iterations (bounces, each a nearest-hit walk), the BSDF samples, the
# Threefry draws (a fold_in an iteration, 2 a path, 3 an NEE ray, 3 a BSDF
# sample), the lanes and slots of the walk and of the shade, and 32 times
# each warp's most iterations in one lane (iterations over it: the share a
# warp's lanes are busy).  The plain version counts ``PLAIN_COUNTS`` and
# ``PLAIN_ONLY``: ``pixel_warp_slots``, the last for one thread per pixel in
# warps of 32 consecutive pixels (the design before work stealing), and
# ``iteration_keys``, the iterations of the frame (the distinct fold_in
# keys, which the bound charges once each).
COUNT_NAMES = _WALK_NAMES + (
    "iterations", "bsdf_samples", "draws", "walk_lanes", "walk_slots",
    "shade_lanes", "shade_slots", "warp_iter_slots")
PLAIN_COUNTS = ("samples", "evals", "pdfs", "shadow_rays", "hit_spheres",
                "hit_boxes", "hit_tris", "shadow_spheres", "shadow_boxes",
                "shadow_tris", "iterations", "bsdf_samples", "draws")
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

    step = (shade_step_plain if counts is None
            else functools.partial(shade_step_plain, counts=counts))
    return wavefront_loop(packed, light_tab, cam, cfg, px, py, spp, key,
                          start, total, step, rng.uniform_rows_plain,
                          counts=counts)


