"""The texture-fetch probe (``path_tracing_tpu.ops.probes``), #12.

``onehot_fetch(tab, idx)``: for a ``(12, D)`` float32 table (4 bilinear
taps x RGB of a flat texel index) and ``(rows, 128)`` int32 indices,
``out[r * 12 + j, l] = tab[j, idx[r, l]]``, shape ``(rows * 12, 128)``; an
index outside ``[0, D)`` gives 0.  The JAX package's kernel computes it as
a one-hot contraction on the TPU's matrix unit (``bench.py --config
texprobe`` times it); CUDA tensors launch the gather kernel of
``csrc/probe_kernels.cu``, CPU tensors take the plain version, which
repeats the one-hot contraction.  The chunk width ``DC`` of the TPU kernel
is a TPU parameter and is not kept.
"""
from __future__ import annotations

import torch

from . import _kernels
from .cuda_intersect import _PLAIN_CHUNK, check_tensor

COLS, LANES = 12, 128


def onehot_fetch_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic: per row, a one-hot ``(D, 128)`` matrix
    contracted with the table in float32 (exact: every sum is one product
    by 1 and zeros), in chunks of rows so the one-hot stays within
    ``_PLAIN_CHUNK`` elements."""
    _kernels.plain_calls["onehot_fetch"] += 1
    rows, D = idx.shape[0], tab.shape[1]
    iota = torch.arange(D, dtype=idx.dtype, device=idx.device)
    step = max(1, _PLAIN_CHUNK // max(D * LANES, 1))
    out = []
    for a in range(0, rows, step):
        oh = (iota[None, :, None] == idx[a:a + step, None, :]).to(tab.dtype)
        out.append(torch.matmul(tab[None], oh))      # (r, 12, 128)
    if not out:
        return torch.zeros((0, LANES), dtype=tab.dtype, device=tab.device)
    return torch.cat(out).reshape(rows * COLS, LANES)


def onehot_fetch(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(rows * 12, 128)`` gathered table columns (see above)."""
    if tab.device.type == "cpu" and idx.device.type == "cpu":
        return onehot_fetch_plain(tab, idx)
    # one test on the path a call takes, since a call's time is mostly the
    # host's; _refuse says what is wrong
    if not (tab.dim() == 2 and tab.shape[0] == COLS and idx.dim() == 2
            and idx.shape[1] == LANES and tab.dtype == torch.float32
            and idx.dtype == torch.int32 and tab.is_cuda
            and idx.device == tab.device and tab.is_contiguous()
            and idx.is_contiguous()):
        _refuse(tab, idx)
    rows = idx.shape[0]
    out = torch.empty((rows * COLS, LANES), device=tab.device)
    if rows:
        _kernels.launch("onehot_fetch", tab.data_ptr(), tab.shape[1],
                        idx.data_ptr(), rows, out.data_ptr())
    return out


def _refuse(tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.dim() != 2 or tab.shape[0] != COLS:
        raise ValueError(f"tab: expected (12, D), got {tuple(tab.shape)}")
    if idx.dim() != 2 or idx.shape[1] != LANES:
        raise ValueError(f"idx: expected (rows, 128), got {tuple(idx.shape)}")
    check_tensor("tab", tab, tuple(tab.shape))
    check_tensor("idx", idx, tuple(idx.shape), torch.int32)
    raise ValueError(f"idx on {idx.device}, tab on {tab.device}")
