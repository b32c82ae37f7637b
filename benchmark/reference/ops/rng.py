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

``uniform_rows_plain`` is the plain version of the ``threefry_rows``
kernel (the same Threefry on native uint32 words that the megakernel
draws from), in int64 torch code.
"""
from __future__ import annotations


import torch


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


def iter_key(key: torch.Tensor, iteration: int) -> torch.Tensor:
    return fold_in(key, iteration)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in (0, 1] (the package's ``1 - u``)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fb.view(torch.float32) - 1.0
    return 1.0 - u


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
    int64 tensors, masked to 32 bits.  ``start`` may also be a (P,) tensor
    of the lanes' columns in the global draw, for lanes that are not
    consecutive."""
    total = P if total is None else total
    if isinstance(start, torch.Tensor):
        lanes = start.to(device=device, dtype=torch.int64)
        if n * total >= 2 ** 32 or lanes.shape != (P,) or (
                P and (int(lanes.min()) < 0 or int(lanes.max()) >= total)):
            raise ValueError("uniform_rows: lanes outside the draw")
    else:
        _check_window(P, n, start, total)
        lanes = start + torch.arange(P, dtype=torch.int64, device=device)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None] * total
    flat = rows + lanes[None, :]
    o0, o1 = threefry2x32(*_words(key), torch.zeros_like(flat), flat)
    return _bits_to_unit(o0 ^ o1)


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


