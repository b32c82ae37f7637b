"""Threefry in the PyTorch port against jax.random: bit-exact keys and
uniforms, inputs given to both packages."""
import jax
import numpy as np
import pytest
import torch

from path_tracing_tpu.ops import rng as jrng
from path_tracing_tpu_torch.ops import rng

SEEDS = [0, 1, 3, 2 ** 31 - 1]


def _key_np(k):
    return np.asarray(jax.random.key_data(k)
                      if jax.dtypes.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bit_exact(seed):
    # keys are uint32 words: exact equality, no tolerance
    np.testing.assert_array_equal(_key_np(jax.random.PRNGKey(seed)),
                                  rng.prng_key(seed).numpy())
    np.testing.assert_array_equal(_key_np(jrng.make_key(seed, 1)),
                                  rng.make_key(seed, 1).numpy())
    k = jrng.make_key(seed, 1)
    for it in (0, 1, 7, 12345):
        np.testing.assert_array_equal(
            _key_np(jrng.iter_key(k, it)),
            rng.iter_key(rng.make_key(seed, 1), it).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("window", [None, (37, 1000), (0, 300)])
def test_uniforms_g_bit_exact(seed, window):
    # float32 uniforms compared with np.array_equal: the port must draw the
    # very same bits, so renders can be compared lane by lane
    start, total = window if window else (0, None)
    kj = jrng.iter_key(jrng.make_key(seed, 1), 5)
    kt = rng.iter_key(rng.make_key(seed, 1), 5)
    a = jrng.uniforms_g(kj, 300, 8, start, total)
    b = rng.uniforms_g(kt, 300, 8, start, total)
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
        assert y.dtype == torch.float32


def test_uniforms_shape_and_support():
    k = rng.make_key(3, 1)
    a = jrng.uniforms(jrng.make_key(3, 1), (4, 5), 2)
    b = rng.uniforms(k, (4, 5), 2)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    u = rng.uniform_rows(k, 4096, 8)
    assert u.shape == (8, 4096)
    assert bool((u > 0).all()) and bool((u <= 1).all())   # (0, 1]


@pytest.mark.parametrize("it,start,total", [(0, 0, None), (7, 37, 1000),
                                            (12345, 5, 2_073_600)])
def test_uniform_at_bit_exact(it, start, total):
    """The scalar mirror of the kernels' draw: element [j, lane] of
    ``uniforms_g(iter_key(k, it), P, 8, start, total)``, bit for bit."""
    P = 64
    kj = jrng.iter_key(jrng.make_key(5, 1), it)
    kt = rng.iter_key(rng.make_key(5, 1), it)
    ref = np.stack([np.asarray(x) for x in
                    jrng.uniforms_g(kj, P, 8, start, total)])
    for j in range(8):
        for lane in (0, 1, 31, P - 1):
            got = np.float32(rng.uniform_at(kt, j, lane, start,
                                            P if total is None else total))
            assert got == ref[j, lane]


def test_uniform_rows_refuses_other_devices():
    """A CPU device draws with the plain version; CUDA launches the
    kernel; anything else raises, as does a window past the counters."""
    k = rng.make_key(1, 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rng.uniform_rows(k, 8, 2, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.uniform_rows(k, 8, 8, total=2 ** 29)
    with pytest.raises(ValueError, match="outside"):
        rng.uniform_rows(k, 8, 2, start=4, total=10)
    assert torch.equal(rng.uniform_rows(k, 8, 2),
                       rng.uniform_rows_plain(k, 8, 2))


def test_window_is_slice_of_global_draw():
    k = rng.make_key(11, 1)
    full = rng.uniform_rows(k, 1000, 8)
    win = rng.uniform_rows(k, 100, 8, start=250, total=1000)
    assert torch.equal(win, full[:, 250:350])
