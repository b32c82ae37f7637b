"""The reference against the port's plain tiers at a tiny size on the CPU:
a block of pixels the reference renders from the seed equals those pixels
of the port's whole frame, bit for bit (both run the same plain code)."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from benchmark import check
from benchmark.cells import load_cell
from benchmark.program import Program
from benchmark.scenes import scene_file

REF = Path(__file__).resolve().parent / "reference"


def _pair(tiny_root, mode):
    cell = load_cell(f"tiny-{mode}", bench=tiny_root / "BENCHMARK.json",
                     root=tiny_root)
    path = scene_file(cell.config_name, cell.config, tiny_root)
    seed = 2 ** 31 + 77
    return (Program(cell.traffic, path, seed, "cpu"),
            check.Reference(cell.traffic, path, seed, "cpu"))


@pytest.mark.parametrize("mode,start,n,step", [
    ("pt", 0, 768, 1), ("pt", 300, 200, 1), ("tex", 0, 768, 1),
    ("tex", 300, 200, 1), ("tex", 5, 96, 8), ("pt", 2, 100, 7),
    ("ppm", 0, 384, 1), ("ppm", 100, 150, 1), ("enclosed", 0, 768, 1),
    ("enclosed", 300, 200, 1), ("enclosed", 5, 96, 8)])
def test_block_equals_the_ports_frame(tiny_root, mode, start, n, step):
    prog, ref = _pair(tiny_root, mode)
    sl = check.pixel_slice(start, n, step)
    for i in (0, 5):
        whole = prog.frame(i)
        assert torch.equal(ref.frame(i, start, n, step), whole[sl])


def test_bdpt_block_reads_its_tiles_table(tiny_root, monkeypatch):
    """With tiles of 256 pixels, a block at a tile's first pixel renders
    against that tile's RIS table, as the port's eye pass does."""
    from path_tracing_tpu_torch.integrators import bdpt as port_bdpt
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as port_eye

    from benchmark.reference.integrators import bdpt as ref_bdpt

    for mod in (port_bdpt, port_eye, ref_bdpt, check):
        monkeypatch.setattr(mod, "TILE_LANES", 256)
    prog, ref = _pair(tiny_root, "bdpt")
    whole = prog.frame(3)
    for start in (0, 256, 512):
        assert torch.equal(ref.frame(3, start, 256),
                           whole[start:start + 256])


def test_control_separates(tiny_root):
    """The reference rounded to bfloat16 reads far from the reference."""
    _, ref = _pair(tiny_root, "pt")
    a = ref.frame(1, 0, 768)
    b = ref.frame(1, 0, 768, round_to=torch.bfloat16)
    assert check.rel_l1(b, a) > 0.05
    assert torch.equal(ref.frame(1, 0, 768), a)   # the rounding is undone


def test_reference_imports_nothing_of_the_program():
    for f in REF.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "path_tracing_tpu_torch", "path_tracing_tpu", "jax",
                    "benchmark"), f"{f}: imports {name}"


def test_subset_is_a_tile_and_fits_the_prim_budget():
    t = json.loads((REF.parent / "workloads" / "pt-1080p.json").read_text())
    B = 1920 * 1080
    for seed in range(20):
        start, n, step = check.subset(t, 41, seed)
        assert start % check.TILE_LANES == 0 and n == 16384 and step == 1
        assert start + n <= B
    for seed in range(20):
        # a block under a row of the image would miss what it shows: the
        # pixels spread over the whole frame instead
        start, n, step = check.subset(t, 327681, seed)
        assert n * 327681 <= t["check_prim_tests"] and n >= 256
        assert step == B // n and 0 <= start < step
        assert start + step * (n - 1) < B
