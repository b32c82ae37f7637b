"""The BDPT eye megakernel (counterpart of
``path_tracing_tpu.ops.pallas_bdpt_eye.bdpt_eye_pallas``).

``bdpt_eye`` runs the whole eye pass of a frame in one launch of the CUDA
kernel ``bdpt_eye`` (``csrc/bdpt_kernels.cu``): one lane per pixel runs
its ``spp`` samples one after the other, each a bounded bounce loop that
connects every vertex against the light-vertex table and carries the
eye-side MIS scalar; each warp sweeps its lanes' vertices together (the
``connect`` kernel's per-row function) and walks their shadow rays packed
32 at a time, adding each pixel's connections in row order.  Sample ``s``
draws from ``k_s = fold_in(fold_in(key, 0x0202), s)``: the camera jitter
from ``fold_in(k_s, 0xA11CE)`` and bounce ``it`` from
``fold_in(fold_in(k_s, 0xE7E), it)``, at the counters the per-bounce
tiers' ``uniform_rows`` give the pixel's lane.  So against a shared table
its image is the fused tier's; the TPU kernel drew from its on-core PRNG
instead, and agreed with its scan tier only in distribution.

The table is (V, 40), shared by every pixel, or (T, Kp, 40) with one
tile-local RIS table per ``TILE_LANES`` consecutive pixels (the JAX
package's megakernel tile: 128 rows of 128 lanes).

``bdpt_eye_plain`` is the same function in PyTorch: the per-sample bounce
loop on the plain nearest-hit, connection and Threefry versions; given a
``counts`` dict it fills the counters that do not depend on walk order.
``bdpt_eye_counts`` launches the kernel's counting build, which returns
the same image and the work it did (``cuda_connect.COUNT_NAMES``);
``occupancy`` reports the resident blocks, registers and spills of the
BDPT kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .cuda_connect import check_table, counts_buffer, read_counts
from .cuda_intersect import (PackedScene, camera_table, check_tables,
                             check_tensor, table_args)
from . import rng

TILE_LANES = 128 * 128


def eye_tiling(B: int):
    """(number of tiles, lanes per tile) of a ``B``-pixel eye pass."""
    return -(-B // TILE_LANES), TILE_LANES


def bdpt_eye_plain(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int,
                   cam, px, py, spp: int, cfg, key, light_hit_scale: float,
                   start: int = 0, total: int | None = None,
                   counts: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ``bdpt_eye`` kernel (``counts``: see
    ``bdpt_eye_plain_loop``)."""
    from ..integrators.bdpt import bdpt_eye_plain_loop

    _kernels.plain_calls["bdpt_eye"] += 1
    return bdpt_eye_plain_loop(packed, lv_tab, n_valid, cam, px, py, spp,
                               cfg, key, light_hit_scale, start, total,
                               counts)


def bdpt_eye(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int, cam,
             px, py, spp: int, cfg, key, light_hit_scale: float,
             start: int = 0, total: int | None = None) -> torch.Tensor:
    """The per-pixel radiance SUM over ``spp`` BDPT samples, (B, 3), for
    pixel indices ``px``, ``py`` (B,) int32 against rows ``[0, n_valid)``
    of ``lv_tab`` (of each tile's table when it is (T, Kp, 40), T =
    ``eye_tiling(B)[0]``).  ``start``/``total``: the lanes are columns
    [start, start + B) of a global ``total``-lane render."""
    if px.device.type == "cpu":
        return bdpt_eye_plain(packed, lv_tab, n_valid, cam, px, py, spp, cfg,
                              key, light_hit_scale, start, total)
    return _launch("bdpt_eye", packed, lv_tab, n_valid, cam, px, py, spp,
                   cfg, key, light_hit_scale, start, total)[0]


def bdpt_eye_counts(packed: PackedScene, lv_tab: torch.Tensor, n_valid: int,
                    cam, px, py, spp: int, cfg, key, light_hit_scale: float,
                    start: int = 0, total: int | None = None) -> tuple:
    """``bdpt_eye`` through the kernel's counting build: (the same image,
    the counters as a dict keyed by ``COUNT_NAMES``).  CUDA tensors only."""
    return _launch("bdpt_eye_counts", packed, lv_tab, n_valid, cam, px, py,
                   spp, cfg, key, light_hit_scale, start, total)


def _launch(name, packed, lv_tab, n_valid, cam, px, py, spp, cfg, key,
            light_hit_scale, start, total):
    B = px.shape[0]
    total = B if total is None else total
    if 3 * total >= 2 ** 32 or start < 0 or start + B > total:
        raise ValueError(f"bdpt_eye: lanes [{start}, {start + B}) of a "
                         f"{total}-lane render do not fit the 32-bit "
                         "Threefry counters")
    check_tensor("px", px, (B,), torch.int32)
    check_tensor("py", py, (B,), torch.int32)
    check_table(lv_tab, n_valid, dims=(2, 3))
    tiled = lv_tab.dim() == 3
    if tiled and lv_tab.shape[0] != eye_tiling(B)[0]:
        raise ValueError(f"bdpt_eye: {lv_tab.shape[0]} tile tables for "
                         f"{eye_tiling(B)[0]} tiles of {TILE_LANES} pixels")
    check_tables(packed, px.device)
    cam_tab = camera_table(cam, px.device)
    out = torch.empty((B, 3), device=px.device)
    counted = name.endswith("_counts")
    buf = counts_buffer(px.device) if counted else None
    if B:
        k0, k1 = (int(w) for w in rng.fold_in(key, 0x0202).tolist())
        _kernels.launch(
            name, *table_args(packed),
            ctypes.c_void_p(lv_tab.data_ptr()), int(n_valid),
            TILE_LANES if tiled else 0,
            lv_tab.shape[1] * lv_tab.shape[2] if tiled else 0,
            ctypes.c_void_p(cam_tab.data_ptr()),
            ctypes.c_void_p(px.data_ptr()), ctypes.c_void_p(py.data_ptr()),
            B, spp, cfg.eye_depth, cfg.max_eye_iters, k0, k1, start, total,
            float(cfg.clamp), 4 if cfg.shadow_dielectrics_block else 5,
            float(light_hit_scale), ctypes.c_void_p(out.data_ptr()),
            *([ctypes.c_void_p(buf.data_ptr())] if counted else []))
    return out, (read_counts(buf) if counted else None)


OCCUPANCY_KERNELS = ("connect", "connect_counts", "bdpt_eye",
                     "bdpt_eye_counts")


def occupancy(n_valid: int) -> dict:
    """Per BDPT kernel, for an eye launch against ``n_valid`` table rows:
    resident blocks and warps per SM at its launch shape
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads per block,
    registers and local (spill) bytes per thread, dynamic shared bytes."""
    out = (ctypes.c_int * (5 * len(OCCUPANCY_KERNELS)))()
    fn = _kernels.library().libs["bdpt_kernels"].pt_bdpt_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    rc = fn(int(n_valid), out)
    if rc != 0:
        raise RuntimeError(f"pt_bdpt_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(OCCUPANCY_KERNELS, out)
