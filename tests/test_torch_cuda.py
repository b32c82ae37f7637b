"""The CUDA kernels against their plain versions on the card.

These need an NVIDIA card, nvcc and the port's build, so they skip
without a card.  This file imports neither jax nor the JAX package; where
jax is not installed, run it without the suite's conftest (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import pytest
import torch

from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.integrators.pt import _light_table
from path_tracing_tpu_torch.ops import _kernels, cuda_intersect, cuda_shade
from path_tracing_tpu_torch.ops import intersect, rng
from path_tracing_tpu_torch.scene.parser import load_scene

CORNELL = Path(__file__).resolve().parent.parent / "scenes" / "cornell.txt"
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _kernels.library()          # builds, or raises with nvcc's output
    scene = load_scene(str(CORNELL)).to_device("cuda")
    return scene, cuda_intersect.pack_scene(scene)


def _rays(n, seed, lo=-0.9, hi=0.9):
    u = rng.uniform_rows(rng.prng_key(seed), n, 8, device="cuda")
    ro = (lo + (hi - lo) * u[0:3]).T.contiguous()
    rd = (u[3:6] - 0.5).T.contiguous()
    return ro, intersect.shadow_ray(torch.zeros_like(rd), rd)[0]


def test_nearest_hit_kernel_matches_plain(card):
    _, pk = card
    ro, rd = _rays(1 << 16, 0)
    a = cuda_intersect.nearest_hit(pk, ro, rd)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd)
    torch.cuda.synchronize()
    assert torch.equal(a["flag"], b["flag"])
    same = torch.isclose(a["t"], b["t"], rtol=1e-5)
    assert same.float().mean().item() >= 0.9995


@pytest.mark.parametrize("dielectrics_block", [True, False])
def test_any_blocker_kernel_matches_plain(card, dielectrics_block):
    _, pk = card
    p1, _ = _rays(1 << 16, 1, -0.95, 0.95)
    p2, _ = _rays(1 << 16, 2, -0.95, 0.95)
    rd, _, md = intersect.shadow_ray(p1, p2)
    a = cuda_intersect.any_blocker(pk, p1, rd, md, dielectrics_block)
    b = cuda_intersect.any_blocker_plain(pk, p1, rd, md, dielectrics_block)
    assert torch.equal(a, b)


def test_shade_step_kernel_matches_plain(card):
    scene, pk = card
    lt = _light_table(scene)
    B = 1 << 15
    ro, rd = _rays(B, 3)
    u = rng.uniform_rows(rng.prng_key(4), B, 8, device="cuda")
    st = (ro, rd, torch.ones(B, 3, device="cuda"),
          torch.ones(B, device="cuda"),
          torch.zeros(B, dtype=torch.int32, device="cuda"),
          torch.ones(B, dtype=torch.bool, device="cuda"),
          torch.ones(B, dtype=torch.bool, device="cuda"),
          torch.ones(B, device="cuda"))
    kw = dict(clamp_val=RenderConfig().clamp, stub_mis=True,
              dielectrics_block=True)
    a = cuda_shade.shade_step(pk, lt, *st, u, **kw)
    b = cuda_shade.shade_step_plain(pk, lt, *st, u, **kw)
    for k in a:
        ok = torch.isclose(a[k].double(), b[k].double(), rtol=1e-4,
                           atol=1e-5)
        if ok.dim() > 1:
            ok = ok.all(dim=1)
        assert ok.float().mean().item() >= 0.999, k
