"""The CUDA kernels against their plain versions on the card, and the
megakernel's image against the fused tier's.

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
from path_tracing_tpu_torch.integrators.pt import _light_table, render_pt
from path_tracing_tpu_torch.ops import _kernels, cuda_intersect, cuda_shade
from path_tracing_tpu_torch.ops import intersect, rng
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.camera import make_camera
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


@pytest.fixture(scope="module")
def mesh(card):
    scene = synth.icosphere_scene(1280, textured=True).to_device("cuda")
    return scene, cuda_intersect.pack_scene(scene)


def _state(ro, rd):
    B = ro.shape[0]
    return (ro, rd, torch.ones(B, 3, device="cuda"),
            torch.ones(B, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, dtype=torch.bool, device="cuda"),
            torch.ones(B, device="cuda"))


@pytest.mark.parametrize("textured", [False, True])
def test_shade_step_kernels_match_plain(card, mesh, textured):
    scene, pk = mesh if textured else card
    fast, plain = ((cuda_shade.shade_step_tex, cuda_shade.shade_step_tex_plain)
                   if textured else
                   (cuda_shade.shade_step, cuda_shade.shade_step_plain))
    lt = _light_table(scene)
    B = 1 << 15
    ro, rd = _rays(B, 3)
    if textured:   # rays from outside toward the icosphere
        rd = intersect.shadow_ray(ro * 4.0, -ro)[0]
        ro = (ro * 4.0).contiguous()
    u = rng.uniform_rows(rng.prng_key(4), B, 8, device="cuda")
    kw = dict(clamp_val=RenderConfig().clamp, stub_mis=True,
              dielectrics_block=True)
    a = fast(pk, lt, *_state(ro, rd), u, **kw)
    b = plain(pk, lt, *_state(ro, rd), u, **kw)
    for k in a:
        ok = torch.isclose(a[k].double(), b[k].double(), rtol=1e-4,
                           atol=1e-5)
        if ok.dim() > 1:
            ok = ok.all(dim=1)
        assert ok.float().mean().item() >= 0.999, k


def test_nearest_hit_with_uv_kernel_matches_plain(mesh):
    _, pk = mesh
    ro, rd = _rays(1 << 16, 5, -3.0, 3.0)
    a = cuda_intersect.nearest_hit(pk, ro, rd, with_uv=True)
    b = cuda_intersect.nearest_hit_plain(pk, ro, rd, with_uv=True)
    assert torch.equal(a["flag"], b["flag"]) and torch.equal(a["tex"],
                                                             b["tex"])
    hit = b["flag"] > 0
    for f in ("iu", "iv"):
        ok = (a[f] - b[f]).abs() <= 1e-5
        assert ok[hit].float().mean().item() >= 0.9995, f


def test_threefry_rows_kernel_is_bit_exact(card):
    k = rng.iter_key(rng.make_key(3, 1), 9)
    a = rng.uniform_rows(k, 100_000, 8, start=7, total=200_000,
                         device="cuda")
    b = rng.uniform_rows_plain(k, 100_000, 8, start=7, total=200_000,
                               device="cuda")
    assert torch.equal(a, b)
    assert a[3, 11].item() == rng.uniform_at(k, 3, 11, 7, 200_000)


def test_megakernel_equals_fused_tier(card):
    scene, _ = card
    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, 64, 48,
                      device="cuda")
    cfg = RenderConfig(width=64, height=48, eye_depth=4)
    key = rng.prng_key(0)
    imgs = [render_pt(scene, cam, 64, 48, 4, cfg, key, tier=t)
            for t in ("mega", "fused")]
    assert torch.equal(imgs[0], imgs[1])
