"""Nothing the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``path_tracing_tpu`` (the port's name begins with it, so the
names are compared whole)."""
from __future__ import annotations

import subprocess
import sys
import types

from benchmark.cells import REPO
from benchmark.conftest import make_tiny_root
from benchmark.run import forbidden_modules


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "path_tracing_tpu_torch_x",
                        types.ModuleType("path_tracing_tpu_torch_x"))
    base = forbidden_modules()
    monkeypatch.setitem(sys.modules, "path_tracing_tpu.ops",
                        types.ModuleType("path_tracing_tpu.ops"))
    assert forbidden_modules() == sorted(set(base) | {"path_tracing_tpu"})
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert "jaxlib" in forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell in a fresh process, the port and the
    reference with it, leaves no forbidden module loaded."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from benchmark.cells import load_cell\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "root = Path(sys.argv[2])\n"
        "cell = load_cell('tiny-ppm', bench=root / 'BENCHMARK.json', "
        "root=root)\n"
        "out = run_cell(cell, 3, 0.3, True, device='cpu')\n"
        "import benchmark.calibrate\n"
        "print(json.dumps([out['correct'], forbidden_modules(), "
        "'path_tracing_tpu_torch' in sys.modules]))\n")
    root = make_tiny_root(tmp_path / "root")
    r = subprocess.run([sys.executable, "-c", code, str(REPO), str(root)],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[true, [], true]"


def test_exits_without_a_result_when_only_the_benchmark_is_there(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "cornell-pt-1080p", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path, env=_env(drop_path=True))
    assert r.returncode != 0 and r.stdout.strip() == ""


def _env(drop_path: bool = False):
    import os

    env = dict(os.environ)
    env.pop("PYTHONPATH", None) if drop_path else None
    return env


def test_no_result_when_a_reader_loads_jax_after_the_window(
        tiny_root, monkeypatch, capsys):
    """The last look at ``sys.modules`` comes after the reference and every
    metric reader: a reader that loads JAX leaves the run without a
    result."""
    import functools
    import json

    import torch

    from benchmark import run
    from benchmark.cells import load_cell

    (tiny_root / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n\ndef read(ctx):\n"
        "    sys.modules.setdefault('jax', types.ModuleType('jax'))\n"
        "    return 1.0\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "loads_jax", "unit": "1",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(run, "load_cell", lambda name: load_cell(
        name, bench=tiny_root / "BENCHMARK.json", root=tiny_root))
    monkeypatch.setattr(run, "run_cell",
                        functools.partial(run.run_cell, device="cpu"))
    monkeypatch.setattr(run, "power_limit", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    had = "jax" in sys.modules
    try:
        rc = run.main(["--workload", "tiny-pt", "--seed", "5", "--seconds",
                       "0.3", "--trace", "0"])
    finally:
        if not had:
            sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax" in out.err
