"""Counter-based Threefry-2x32 streams, bit-exact with ``jax.random``.

Every random number is a pure function of ``(seed, stream, iteration,
lane)``, as in ``path_tracing_tpu.ops.rng``: renders are reproducible per
seed, and the port draws the very same uniforms as the JAX package, so the
two can be compared lane by lane.

A key is a ``(2,)`` int64 CPU tensor holding two uint32 words; keys are
derived on the host and only the bulk draws run on the render device.
torch's uint32 lacks most arithmetic, so words live in int64 and are
masked to 32 bits after every add and rotate (the same code runs on Python
ints for the keys).

Layouts matched (jax with ``jax_threefry_partitionable``, its default):

- ``PRNGKey(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- element ``[j, i]`` of ``uniform(key, (n, B))`` takes ``o1 ^ o2`` of
  ``threefry2x32(key, (0, j*B + i))``, keeps the top 23 bits as the
  mantissa of a float in [1, 2) and subtracts 1.

``uniform_rows`` on a CUDA device launches the ``threefry_rows`` kernel
(``csrc/pt_kernels.cu``, the same Threefry on native uint32 words that the
megakernel draws from); ``uniform_rows_plain`` is its plain version, the
int64 torch code, which CPU draws run.  ``uniform_at`` is a scalar mirror
of the device draw on Python ints.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in Python ints or
    int64 tensors."""
    k0 = k0 & _M32
    k1 = k1 & _M32
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64)


def _words(key: torch.Tensor):
    k0, k1 = (int(w) for w in key.tolist())
    return k0, k1


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from a key and a 32-bit integer."""
    o0, o1 = threefry2x32(*_words(key), 0, int(data) & _M32)
    return torch.tensor([o0, o1], dtype=torch.int64)


def make_key(seed: int, stream: int) -> torch.Tensor:
    return fold_in(prng_key(seed), stream)


def iter_key(key: torch.Tensor, iteration: int) -> torch.Tensor:
    return fold_in(key, iteration)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in (0, 1] (the package's ``1 - u``)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fb.view(torch.float32) - 1.0
    return 1.0 - u


def uniform_at(key: torch.Tensor, j: int, lane: int, start: int = 0,
               total: int | None = None) -> float:
    """Element ``[j, lane]`` of ``uniform_rows(key, P, n, start, total)``
    as a Python float: Threefry at counter ``j*total + start + lane``, as
    the kernels draw it.  ``total=None`` means ``start + lane + 1``."""
    total = start + lane + 1 if total is None else total
    o0, o1 = threefry2x32(*_words(key), 0, (j * total + start + lane) & _M32)
    # the top 23 bits as a mantissa in [1, 2), minus 1, then 1 - u: exact
    # in float64 and representable in float32
    return 1.0 - ((o0 ^ o1) >> 9) / float(1 << 23)


def _check_window(P: int, n: int, start: int, total: int) -> None:
    if n * total >= 2 ** 32:
        raise ValueError("uniform_rows: n * total must stay below 2**32")
    if start < 0 or start + P > total:
        raise ValueError(f"uniform_rows: lanes [{start}, {start + P}) lie "
                         f"outside a {total}-lane draw")


def uniform_rows_plain(key: torch.Tensor, P: int, n: int, start: int = 0,
                       total: int | None = None, device="cpu"
                       ) -> torch.Tensor:
    """Plain PyTorch version of the ``threefry_rows`` kernel: words in
    int64 tensors, masked to 32 bits."""
    _kernels.plain_calls["threefry_rows"] += 1
    total = P if total is None else total
    _check_window(P, n, start, total)
    lanes = start + torch.arange(P, dtype=torch.int64, device=device)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None] * total
    flat = rows + lanes[None, :]
    o0, o1 = threefry2x32(*_words(key), torch.zeros_like(flat), flat)
    return _bits_to_unit(o0 ^ o1)


def uniform_rows(key: torch.Tensor, P: int, n: int, start: int = 0,
                 total: int | None = None, device="cpu") -> torch.Tensor:
    """An ``(n, P)`` float32 tensor of uniforms on (0, 1] on ``device``.

    The lanes are columns ``[start, start + P)`` of a global
    ``(n, total)`` draw; ``total=None`` draws ``(n, P)`` itself.  The CPU
    draws with :func:`uniform_rows_plain`; a CUDA device launches the
    ``threefry_rows`` kernel; any other device raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_rows_plain(key, P, n, start, total, device)
    if device.type != "cuda":
        raise ValueError(f"uniform_rows: expected a CPU or CUDA device, "
                         f"got {device}")
    total = P if total is None else total
    _check_window(P, n, start, total)
    out = torch.empty((n, P), dtype=torch.float32, device=device)
    if n * P:
        k0, k1 = _words(key)
        _kernels.launch("threefry_rows", k0, k1, n, P, start, total,
                        ctypes.c_void_p(out.data_ptr()))
    return out


def uniform(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), element
    ``i`` of the row-major flattened shape at counter ``i`` (no ``1 - u``
    flip), bit for bit.  Small draws (the RIS strata); the bits are made
    with the int64 Threefry on ``device``."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if size >= 2 ** 32:
        raise ValueError("uniform: the counters hold 32 bits")
    flat = torch.arange(size, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(*_words(key), torch.zeros_like(flat), flat)
    fb = (((o0 ^ o1) >> 9) | 0x3F800000).to(torch.int32)
    return (fb.view(torch.float32) - 1.0).reshape(shape)


def uniforms_g(key: torch.Tensor, P: int, n: int, start: int = 0,
               total: int | None = None, device="cpu"):
    """``n`` uniform (P,) tensors: the rows of :func:`uniform_rows`."""
    u = uniform_rows(key, P, n, start, total, device)
    return tuple(u[i] for i in range(n))


def uniforms(key: torch.Tensor, shape, n: int, device="cpu"):
    """``n`` independent uniform tensors of ``shape`` on (0, 1]."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    u = uniform_rows(key, size, n, device=device)
    return tuple(u[i].reshape(shape) for i in range(n))
