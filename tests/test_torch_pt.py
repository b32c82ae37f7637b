"""The PT slice end to end: the port's ``render_pt`` against the JAX
package's ``render_pt`` from the same key on the same tables, and the CLI.

The port's default tier is the megakernel, which draws the uniforms of the
fused per-bounce tier, so the reference is the JAX package's own fused
tier (``PT_TPU_NO_MEGAKERNEL=1``) with its Pallas kernels in interpret
mode.  Bar of tests/test_pallas_interpret.py
(fused pipeline against XLA): mean within 1e-3 relative, and at least 99%
of pixels within rtol 1e-4 / atol 1e-5; a pixel whose path takes a
knife-edge hit or branch the other way differs by a whole path.  Against
the JAX XLA tier only the mean bar holds on this scene: the JAX package's
own two tiers agree on 98.8% of its pixels here."""
import jax
import numpy as np
import pytest
import torch

from path_tracing_tpu.config import RenderConfig as JConfig
from path_tracing_tpu.film import read_png
from path_tracing_tpu.integrators.pt import render_pt as j_render_pt
from path_tracing_tpu_torch import cli
from path_tracing_tpu_torch.config import RenderConfig
from path_tracing_tpu_torch.film import tonemap_u8
from path_tracing_tpu_torch.integrators.pt import render_pt
from path_tracing_tpu_torch.ops import rng

from test_torch_scene import CORNELL, jax_cornell

W = H = 16
SPP = 2
CFG = dict(width=W, height=H, eye_depth=3, light_depth=3, delta_budget=3)


@pytest.fixture(scope="module")
def port_image():
    js, jc, ts, tc = jax_cornell(W, H)
    img = render_pt(ts, tc, W, H, SPP, RenderConfig(**CFG),
                    rng.prng_key(0)).numpy()
    return js, jc, img


def _bar(a, b, pixel_share):
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 1e-3
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= pixel_share, close.mean()


def test_render_pt_matches_jax_fused_tier(port_image, monkeypatch):
    js, jc, img = port_image
    assert img.shape == (W * H, 3) and img.mean() > 0.05
    monkeypatch.setenv("PT_TPU_INTERPRET", "1")
    monkeypatch.setenv("PT_TPU_NO_MEGAKERNEL", "1")
    jax.clear_caches()
    try:
        ref = np.asarray(j_render_pt(js, jc, W, H, SPP, JConfig(**CFG),
                                     jax.random.PRNGKey(0)))
    finally:
        jax.clear_caches()
    _bar(ref, img, 0.99)


def test_render_pt_mean_matches_jax_xla_tier(port_image):
    js, jc, img = port_image
    ref = np.asarray(j_render_pt(js, jc, W, H, SPP, JConfig(**CFG),
                                 jax.random.PRNGKey(0)))
    _bar(ref, img, 0.95)


def test_render_tiers_identical_on_cpu():
    _, _, ts, tc = jax_cornell(8, 8)
    cfg = RenderConfig(width=8, height=8, eye_depth=3, delta_budget=3)
    imgs = [render_pt(ts, tc, 8, 8, 1, cfg, rng.prng_key(1), tier=t)
            for t in ("auto", "mega", "fused", "split", "plain")]
    for img in imgs[1:]:
        assert torch.equal(imgs[0], img)
    with pytest.raises(ValueError):
        render_pt(ts, tc, 8, 8, 1, cfg, rng.prng_key(1), tier="bogus")


def test_cli_writes_png(tmp_path):
    out = tmp_path / "out.png"
    argv = ["--input", str(CORNELL), "--mode", "pt", "--spp", "1",
            "--width", "12", "--height", "8", "--device", "cpu",
            "--output", str(out)]
    assert cli.main(argv) == 0
    img = read_png(str(out))
    assert img.shape == (8, 12, 3) and img.dtype == np.uint8
    res = cli.run(argv)
    linear = res["image"]
    assert linear.shape == (96, 3) and np.isfinite(linear).all()
    assert linear.mean() > 0
    # the PNG is the tonemapped linear image of the same render
    np.testing.assert_array_equal(read_png(str(out)),
                                  tonemap_u8(linear, 12, 8))


SPHERE_OBJ = CORNELL.parent.parent / "tests" / "fixtures" / "sphere.obj"


@pytest.mark.parametrize("which", ["sphere", "textured_quad"])
def test_cli_renders_obj(which, tmp_path, capsys):
    """An .obj renders through the CLI with the default framing: the
    untextured sphere in the mega tier, the textured quad in the fused
    tier with the textured bounce."""
    from conftest import make_textured_quad_obj

    inp = SPHERE_OBJ if which == "sphere" else make_textured_quad_obj(
        tmp_path)
    out = tmp_path / "obj.png"
    res = cli.run(["--input", str(inp), "--spp", "1", "--width", "8",
                   "--height", "6", "--device", "cpu", "--output", str(out)])
    assert res["tier"] == ("mega" if which == "sphere" else "fused")
    assert res["image"].shape == (48, 3)
    assert np.isfinite(res["image"]).all() and res["image"].mean() > 0
    assert read_png(str(out)).shape == (6, 8, 3)
    assert f"({res['tier']} tier)" in capsys.readouterr().out


def test_cli_mega_on_textured_scene_exits_nonzero(tmp_path, capsys):
    from conftest import make_textured_quad_obj

    out = tmp_path / "out.png"
    rc = cli.main(["--input", make_textured_quad_obj(tmp_path), "--spp", "1",
                   "--width", "4", "--height", "4", "--device", "cpu",
                   "--tier", "mega", "--output", str(out)])
    assert rc != 0 and not out.exists()
    assert "mega" in capsys.readouterr().err


def test_cli_cuda_without_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the CPU-only box")
    out = tmp_path / "out.png"
    rc = cli.main(["--input", str(CORNELL), "--device", "cuda", "--spp", "1",
                   "--width", "4", "--height", "4", "--output", str(out)])
    assert rc != 0
    assert not out.exists()
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["bdpt", "ppm"])
def test_cli_unported_modes_exit_nonzero(mode, capsys, tmp_path):
    """BDPT and PPM render textured scenes; the tier each does not have
    for them (BDPT's eye megakernel, PPM's fused) exits non-zero with the
    reason."""
    from conftest import make_textured_quad_obj

    inp = make_textured_quad_obj(tmp_path)
    tier = {"bdpt": "mega", "ppm": "fused"}[mode]
    rc = cli.main(["--input", inp, "--mode", mode, "--device", "cpu",
                   "--tier", tier, "--width", "4", "--height", "4",
                   "--output", str(tmp_path / "t.png")])
    assert rc != 0 and not (tmp_path / "t.png").exists()
    assert tier in capsys.readouterr().err
    res = cli.run(["--input", inp, "--mode", mode, "--device", "cpu",
                   "--spp", "1", "--spl", "16", "--width", "4", "--height",
                   "4", "--output", str(tmp_path / "u.png")])
    assert res["tier"] == {"bdpt": "fused", "ppm": "mega"}[mode]
    assert res["image"].shape == (16, 3) and np.isfinite(res["image"]).all()
