"""The PT megakernel (counterpart of
``path_tracing_tpu.ops.pallas_shade.render_wavefront_pallas``).

``render_wavefront`` renders every sample of every pixel in one launch of
the CUDA kernel ``render_wavefront`` (``csrc/pt_kernels.cu``): one thread
per pixel runs the regenerating wavefront loop for its own lane, with the
bounce of ``shade_step`` and the uniforms drawn in the kernel.  Iteration
``it`` draws from ``fold_in(key, it)`` at the counters that
``uniform_rows(iter_key(key, it), B, 8, start, total)`` gives the lane, so
the image equals the per-bounce tier's (``integrators/pt.py::
wavefront_loop`` with ``shade_step``) pixel for pixel.  The TPU kernel drew
from its on-core PRNG instead, so its image is equal to the per-bounce
tier's only in distribution.

``render_wavefront_plain`` is the same function in PyTorch: the per-bounce
loop with the plain step and the plain Threefry draws.  Untextured scenes without legacy Ks only, as on
the TPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels, rng
from .cuda_intersect import PackedScene, check_tables, check_tensor, table_args
from .cuda_shade import LIGHT_COLS, shade_step_plain


def render_wavefront_plain(packed: PackedScene, light_tab, cam, px, py,
                           spp: int, cfg, key, start: int = 0,
                           total: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ``render_wavefront`` kernel."""
    from ..integrators.pt import wavefront_loop

    _kernels.plain_calls["render_wavefront"] += 1
    return wavefront_loop(packed, light_tab, cam, cfg, px, py, spp, key,
                          start, total, shade_step_plain,
                          rng.uniform_rows_plain)


def render_wavefront(packed: PackedScene, light_tab, cam, px, py, spp: int,
                     cfg, key, start: int = 0, total: int | None = None
                     ) -> torch.Tensor:
    """The per-pixel radiance SUM over ``spp`` samples, (B, 3), for pixel
    indices ``px``, ``py`` (B,) int32.  ``start``/``total``: the lanes are
    columns [start, start + B) of a global ``total``-lane render."""
    if px.device.type == "cpu":
        return render_wavefront_plain(packed, light_tab, cam, px, py, spp,
                                      cfg, key, start, total)
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
    cam_tab = torch.cat([cam.eye, cam.ul, cam.dx, cam.dy]).to(
        device=px.device, dtype=torch.float32).contiguous()
    out = torch.empty((B, 3), device=px.device)
    if B:
        k0, k1 = (int(w) for w in key.tolist())
        _kernels.launch(
            "render_wavefront", *table_args(packed),
            ctypes.c_void_p(light_tab.data_ptr()),
            ctypes.c_void_p(cam_tab.data_ptr()),
            ctypes.c_void_p(px.data_ptr()), ctypes.c_void_p(py.data_ptr()),
            B, spp, cfg.eye_depth, cfg.max_eye_iters,
            spp * cfg.max_eye_iters + cfg.max_eye_iters, k0, k1, start,
            total, float(cfg.clamp), int(cfg.pt_stub_mis_strategy_a),
            4 if cfg.shadow_dielectrics_block else 5,
            ctypes.c_void_p(out.data_ptr()))
    return out
