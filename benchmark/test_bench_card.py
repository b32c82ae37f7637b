"""A short run of every cell on the card (marked ``cuda``; skips without
one, decided inside the test):

    python -m pytest --noconftest -m cuda benchmark/test_bench_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.cells import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 17), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=REPO, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
