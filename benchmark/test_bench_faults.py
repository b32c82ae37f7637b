"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (the look for a
card skipped), with one fault planted in the program: the accumulation
step returning its state unchanged; half of each iteration's samples (or
photons) left out, the mean taken over the rest; each iteration's answer
altered where it is produced.  A one-chip cell has no exchange between
chips to leave out.  The control, the reference rounded to bfloat16 in the
program's place, comes out not correct too, and a sound run correct."""
from __future__ import annotations

import pytest
import torch

from benchmark.cells import load_cell
from benchmark.run import run_cell

MODES = ("pt", "bdpt", "ppm", "tex", "enclosed")


def _run(root, mode, **kw):
    cell = load_cell(f"tiny-{mode}", bench=root / "BENCHMARK.json",
                     root=root)
    return run_cell(cell, 2 ** 32 + 9, 0.5, False, device="cpu", **kw)


def _wrap(monkeypatch, mode, change_args=None, change_out=None):
    from path_tracing_tpu_torch.integrators import bdpt, ppm, pt

    mod, name = {"pt": (pt, "render_pt"), "tex": (pt, "render_pt"),
                 "enclosed": (pt, "render_pt"),
                 "bdpt": (bdpt, "render_bdpt"),
                 "ppm": (ppm, "render_ppm_with_stats")}[mode]
    orig = getattr(mod, name)

    def broken(*args, **kw):
        args = change_args(list(args)) if change_args else args
        out = orig(*args, **kw)
        return change_out(out) if change_out else out
    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("mode", MODES)
def test_sound_run_is_correct(tiny_root, mode):
    out = _run(tiny_root, mode)
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_state_left_unchanged(tiny_root, mode, monkeypatch):
    from path_tracing_tpu_torch import film

    monkeypatch.setattr(film.AccumState, "add", lambda self, f: self)
    out = _run(tiny_root, mode)
    assert not out["correct"]
    assert out["compared"]["accum_mismatch"]["value"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_half_the_batch_left_out(tiny_root, mode, monkeypatch):
    # spp (PT, BDPT: argument 4) or spl (PPM: argument 4) halved
    def half(a):
        a[4] = a[4] // 2
        return a
    _wrap(monkeypatch, mode, change_args=half)
    out = _run(tiny_root, mode)
    assert not out["correct"]
    assert out["compared"]["frame_rel_l1"]["value"] > 1e-6


@pytest.mark.parametrize("mode", MODES)
def test_answer_altered_where_produced(tiny_root, mode, monkeypatch):
    def alter(out):
        img = out[0] if isinstance(out, tuple) else out
        img = img.clone()
        img[::7] *= 1.5
        return (img, *out[1:]) if isinstance(out, tuple) else img
    _wrap(monkeypatch, mode, change_out=alter)
    out = _run(tiny_root, mode)
    assert not out["correct"]


@pytest.mark.parametrize("mode", MODES)
def test_control_is_not_correct(tiny_root, mode):
    out = _run(tiny_root, mode, control=torch.bfloat16)
    assert not out["correct"]
    assert out["compared"]["frame_rel_l1"]["value"] > 1e-2
