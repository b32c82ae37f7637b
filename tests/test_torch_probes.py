"""The texture-fetch probe (#12) in the PyTorch port against the JAX
package's ``onehot_fetch`` kernel in interpret mode, at the shape
``tests/test_probes.py`` pins: bit-equal (every output is one table
element times 1 plus zeros)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu.ops.probes import onehot_fetch as j_onehot_fetch
from path_tracing_tpu_torch.ops import _kernels, probes

ROWS, D, DC = 8, 1024, 256


def _inputs(seed=0, lo=0, hi=D):
    tab = np.random.RandomState(seed).rand(12, D).astype(np.float32)
    idx = np.random.RandomState(seed + 1).randint(lo, hi, (ROWS, 128))
    return tab, idx.astype(np.int32)


@pytest.mark.parametrize("seed,lo,hi", [(0, 0, D), (2, -40, D + 40)])
def test_onehot_fetch_matches_jax_kernel(seed, lo, hi):
    """In range, and with indices outside [0, D), which the one-hot
    contraction turns into zeros."""
    tab, idx = _inputs(seed, lo, hi)
    ref = np.asarray(j_onehot_fetch(ROWS, D, DC, interpret=True)(
        jnp.asarray(tab), jnp.asarray(idx)))
    _kernels.reset_counts()
    got = probes.onehot_fetch(torch.from_numpy(tab), torch.from_numpy(idx))
    assert _kernels.plain_calls["onehot_fetch"] == 1
    assert got.shape == (ROWS * 12, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(ref, got.numpy())
    inside = (idx >= 0) & (idx < D)
    exp = tab[:, np.clip(idx, 0, D - 1)] * inside[None]   # (12, rows, 128)
    np.testing.assert_array_equal(
        got.numpy().reshape(ROWS, 12, 128).transpose(1, 0, 2), exp)
    assert (~inside).any() == (lo < 0)


def test_onehot_fetch_plain_chunks_rows(monkeypatch):
    """The plain version's row chunks (a one-hot of at most _PLAIN_CHUNK
    elements) do not change the result."""
    tab, idx = (torch.from_numpy(x) for x in _inputs(4))
    whole = probes.onehot_fetch_plain(tab, idx)
    monkeypatch.setattr(probes, "_PLAIN_CHUNK", D * 128 * 3)
    assert torch.equal(whole, probes.onehot_fetch_plain(tab, idx))
    assert probes.onehot_fetch_plain(tab, idx[:0]).shape == (0, 128)
