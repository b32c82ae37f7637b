"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``.  The build runs at first use, into
``path_tracing_tpu_torch/build/``, under a name keyed on a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  A failed build raises with nvcc's output; nothing falls back.

Each launch adds one to ``launches[name]``; each call of a plain version
adds one to ``plain_calls[name]``.  A run reads them to show which path it
went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("pt_kernels.cu", "pt_device.cuh")
# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions round them; no --use_fast_math, so division, sqrt
# and the transcendentals keep their IEEE-accurate forms.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = ("nearest_hit", "any_blocker", "shade_step", "shade_step_tex",
           "render_wavefront", "threefry_rows")
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# sph, ns, nl, tri, uv, cl, n_clusters
_TABLES = [_P, _I, _I, _P, _P, _P, _I]
# lights, ro, rd, tp, eta, depth, act, last_delta, last_pdf, u | B, clamp,
# stub_mis, blocks_col | 9 outputs
_STEP = [_P] * 10 + [_I, _F, _I, _I] + [_P] * 9
# every entry ends in the stream
_ARGTYPES = {
    "nearest_hit": _TABLES + [_I, _P, _P, _I, _P, _P, _P],
    "any_blocker": _TABLES + [_P, _P, _P, _I, _I, _P, _P],
    "shade_step": _TABLES + _STEP + [_P],
    "shade_step_tex": _TABLES + [_P, _P, _I, _I, _I] + _STEP + [_P],
    "render_wavefront": _TABLES + [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _U, _U, _U, _U, _F, _I, _I, _P, _P],
    "threefry_rows": [_U, _U, _I, _I, _U, _U, _P, _P],
}


def reset_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
        plain_calls[k] = 0


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was reused
    ptxas_log: str


_LOADED: KernelLibrary | None = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """The loaded kernel library, built first if needed."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    so = BUILD_DIR / f"libpt_kernels_{_source_hash()}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / "pt_kernels.cu")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        log = r.stderr
        os.replace(tmp, so)
        (so.with_suffix(".log")).write_text(log)
    elif so.with_suffix(".log").exists():
        log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"pt_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED = KernelLibrary(lib=lib, path=so, build_seconds=seconds,
                            ptxas_log=log)
    return _LOADED


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream and count it.
    Raises if the launch reports an error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(library().lib, f"pt_{name}")
    rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    launches[name] += 1
