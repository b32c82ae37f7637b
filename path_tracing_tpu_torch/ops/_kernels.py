"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each library's source is compiled with ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes``: ``pt_kernels.cu`` (the PT
kernels), ``bdpt_kernels.cu`` (the BDPT kernels), ``ppm_kernels.cu`` (the
PPM kernels) and ``mesh_kernels.cu`` (the streamed mesh kernels), all on
the device functions of ``pt_device.cuh``, and ``probe_kernels.cu`` (the
texture-fetch probe).  The builds run at first use, all at once
(one ``nvcc`` per source), into ``path_tracing_tpu_torch/build/``, each
under a name keyed on a hash of its sources and the flags, so an edited
source is rebuilt and an unchanged one is reused; a file lock makes
processes that start together build once.  A failed build raises
with nvcc's output; nothing falls back.

``transmittance_rgb`` (in ``pt_kernels.cu``) is the RGB shadow of
legacy-Ks scenes; ``connect_rgb`` and ``connect_sampled`` are #8's RGB and
sampled instances, ``photon_trace_tex`` #10's textured one and
``ppm_eye_tex`` the PPM eye pass's (``ppm_eye``, in ``ppm_kernels.cu``)
and ``bdpt_light_tex`` the BDPT light trace's (``bdpt_light``, in
``bdpt_kernels.cu``), each launched under its own name.

Each launch adds one to ``launches[name]``; each call of a plain version
adds one to ``plain_calls[name]``.  A run reads them to show which path it
went through.  ``nearest_hit_counts``, ``any_blocker_counts``,
``connect_counts``, ``bdpt_eye_counts``,
``render_wavefront_counts``, ``shade_step_counts``,
``shade_step_tex_counts``, ``photon_trace_counts``,
``gather_flux_counts``, ``nearest_hit_stream_counts`` and
``any_blocker_stream_counts`` are the counting builds of ``nearest_hit``,
``any_blocker``, ``connect``, ``bdpt_eye``, ``render_wavefront``,
``shade_step``, ``shade_step_tex``, ``photon_trace``, ``gather_flux``,
``nearest_hit_stream`` and ``any_blocker_stream``, launched under their
own names.
"""
from __future__ import annotations

import ctypes
import fcntl
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
HEADERS = ("pt_device.cuh",)
# each library: its source (csrc/<name>.cu) and the kernels it holds
LIBRARIES = {
    "pt_kernels": ("nearest_hit", "any_blocker", "shade_step",
                   "shade_step_tex", "render_wavefront", "threefry_rows",
                   "transmittance_rgb", "nearest_hit_counts",
                   "any_blocker_counts", "render_wavefront_counts",
                   "shade_step_counts", "shade_step_tex_counts"),
    "bdpt_kernels": ("connect", "bdpt_eye", "connect_rgb", "connect_sampled",
                     "connect_counts", "bdpt_eye_counts", "bdpt_light",
                     "bdpt_light_tex"),
    "ppm_kernels": ("photon_trace", "gather_flux", "photon_trace_tex",
                    "photon_trace_counts", "gather_flux_counts", "ppm_eye",
                    "ppm_eye_tex"),
    "mesh_kernels": ("nearest_hit_stream", "any_blocker_stream",
                     "nearest_hit_stream_counts", "any_blocker_stream_counts"),
    "probe_kernels": ("onehot_fetch",),
}
# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions round them; no --use_fast_math, so division, sqrt
# and the transcendentals keep their IEEE-accurate forms.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = tuple(k for ks in LIBRARIES.values() for k in ks)
launches = {k: 0 for k in KERNELS}
plain_calls = {k: 0 for k in KERNELS}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# sph, ns, nl, tri, uv, cl, n_clusters, sup, n_super, and the sphere
# index's scl, n_clusters, ssup, n_super (pt_device.cuh::PTK_TABLE_PARAMS)
_TABLES = [_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I]
# sph, ns, nl, tri, cl, n_clusters, sup, n_super, blk (ops/cuda_stream.py)
_STREAM = [_P, _I, _I, _P, _P, _I, _P, _I, _P]
# lights, ro, rd, tp, eta, depth, act, last_delta, last_pdf, u | B, clamp,
# stub_mis, blocks_col | 9 outputs
_STEP = [_P] * 10 + [_I, _F, _I, _I] + [_P] * 9
# every entry ends in the stream
_ARGTYPES = {
    # with_uv ro rd live | B | out flag
    "nearest_hit": _TABLES + [_I, _P, _P, _P, _I, _P, _P, _P],
    # p1 rd max_d live | B blocks_col | out
    "any_blocker": _TABLES + [_P, _P, _P, _P, _I, _I, _P, _P],
    "shade_step": _TABLES + _STEP + [_P],
    "shade_step_tex": _TABLES + [_P, _P, _I, _I, _I] + _STEP + [_P],
    # lights cam px py | B spp eye_depth max_path_iters max_total | k0 k1
    # start total | clamp stub_mis blocks_col | work img
    "render_wavefront": _TABLES + [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _U, _U, _U, _U, _F, _I, _I, _P, _P, _P],
    "threefry_rows": [_U, _U, _I, _I, _U, _U, _P, _P],
    # lv, n_valid | pos n tp bc rough metal eta wo_e wo_s eye_f act | B,
    # clamp, blocks_col | work out
    "connect": _TABLES + [_P, _I] + [_P] * 11 + [_I, _F, _I, _P, _P, _P],
    # ks lv, n_valid | pos n tp bc rough metal eta wo_e wo_s eye_f act | B,
    # clamp, blocks_col | work out
    "connect_rgb": _TABLES + [_P, _P, _I] + [_P] * 11 + [_I, _F, _I, _P, _P,
                                                        _P],
    # ks lv, n_valid | the 11 lane inputs | vidx M B, clamp, blocks_col |
    # work out
    "connect_sampled": _TABLES + [_P, _P, _I] + [_P] * 12 + [_I, _I, _F, _I,
                                                            _P, _P, _P],
    # lv, n_valid, tile_lanes, tile_stride | cam px py | B spp eye_depth
    # max_iters | k0 k1 start total | clamp blocks_col light_hit_scale | img
    "bdpt_eye": _TABLES + [_P, _I, _I, ctypes.c_longlong, _P, _P, _P,
                           _I, _I, _I, _I, _U, _U, _U, _U, _F, _I, _F,
                           _P, _P],
    # ro rd flux real P | k0 k1 start total | light_depth iters | work ev
    # valid
    "photon_trace": _TABLES + [_P] * 4 + [_I, _U, _U, _U, _U, _I, _I, _P, _P,
                                          _P, _P],
    # the atlas's five arguments, then photon_trace's after the tables
    "photon_trace_tex": _TABLES + [_P, _P, _I, _I, _I] + [_P] * 4 + [
        _I, _U, _U, _U, _U, _I, _I, _P, _P, _P, _P],
    # cam px py B | j0 j1 i0 i1 start total | iters clamp | direct pos
    # normal wo bc rough metal eta tp valid
    "ppm_eye": _TABLES + [_P, _P, _P, _I, _U, _U, _U, _U, _U, _U, _I, _F]
    + [_P] * 11,
    # the atlas's five arguments, then ppm_eye's after the tables
    "ppm_eye_tex": _TABLES + [_P, _P, _I, _I, _I]
    + [_P, _P, _P, _I, _U, _U, _U, _U, _U, _U, _I, _F] + [_P] * 11,
    # ro rd tp0 real light_dir light_cutoff light_is_parallel | n_lights P
    # | k0 k1 start total | light_depth iters | the 16 vertex fields
    "bdpt_light": _TABLES + [_P] * 7 + [_I, _I, _U, _U, _U, _U, _I, _I]
    + [_P] * 17,
    # the atlas's five arguments, then bdpt_light's after the tables
    "bdpt_light_tex": _TABLES + [_P, _P, _I, _I, _I] + [_P] * 7
    + [_I, _I, _U, _U, _U, _U, _I, _I] + [_P] * 17,
    # ks p1 rd max_d live | B | out
    "transmittance_rgb": _TABLES + [_P, _P, _P, _P, _P, _I, _P, _P],
    # hp perm win ev items | n_items r2 | flux count
    "gather_flux": [_P] * 5 + [_I, _F, _P, _P, _P],
    # the streamed tables | ro rd B n_live | t idx kind
    "nearest_hit_stream": _STREAM + [_P, _P, _I, _P, _P, _P, _P, _P],
    # the streamed tables | p1 rd max_d B n_live blocks_col | out
    "any_blocker_stream": _STREAM + [_P, _P, _P, _I, _P, _I, _P, _P],
    # tab D idx rows out
    "onehot_fetch": [_P, _I, _P, _I, _P, _P],
}
# the counting builds: the same arguments, then the uint64 counters
_ARGTYPES["nearest_hit_counts"] = _ARGTYPES["nearest_hit"][:-1] + [_P, _P]
_ARGTYPES["any_blocker_counts"] = _ARGTYPES["any_blocker"][:-1] + [_P, _P]
_ARGTYPES["connect_counts"] = _ARGTYPES["connect"][:-1] + [_P, _P]
_ARGTYPES["bdpt_eye_counts"] = _ARGTYPES["bdpt_eye"][:-1] + [_P, _P]
_ARGTYPES["render_wavefront_counts"] = (_ARGTYPES["render_wavefront"][:-1]
                                        + [_P, _P])
_ARGTYPES["gather_flux_counts"] = _ARGTYPES["gather_flux"][:-1] + [_P, _P]
_ARGTYPES["photon_trace_counts"] = _ARGTYPES["photon_trace"][:-1] + [_P, _P]
_ARGTYPES["nearest_hit_stream_counts"] = (_ARGTYPES["nearest_hit_stream"][:-1]
                                          + [_P, _P])
_ARGTYPES["shade_step_counts"] = _ARGTYPES["shade_step"][:-1] + [_P, _P]
_ARGTYPES["shade_step_tex_counts"] = (_ARGTYPES["shade_step_tex"][:-1]
                                      + [_P, _P])
_ARGTYPES["any_blocker_stream_counts"] = (_ARGTYPES["any_blocker_stream"][:-1]
                                          + [_P, _P])


def occupancy_rows(names, out) -> dict:
    """Five ints a kernel from an occupancy entry of ``csrc`` (resident
    blocks per SM, threads per block, registers and local bytes per thread,
    shared bytes per block) as a dict a kernel name."""
    res = {}
    for k, name in enumerate(names):
        blocks, threads, regs, local, smem = out[5 * k:5 * k + 5]
        res[name] = dict(blocks_per_sm=blocks, threads=threads,
                         warps_per_sm=blocks * threads // 32, registers=regs,
                         local_bytes=local, smem_bytes=smem)
    return res


def reset_counts() -> None:
    for k in KERNELS:
        launches[k] = 0
        plain_calls[k] = 0


@dataclass
class KernelLibrary:
    fns: dict              # kernel name -> its C entry point
    libs: dict             # library name -> the loaded ctypes.CDLL
    paths: list            # the loaded shared libraries
    build_seconds: float   # wall time of the builds; 0.0 when all reused
    ptxas_log: str


_LOADED: KernelLibrary | None = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*HEADERS, f"{name}.cu"):
        h.update((SRC_DIR / src).read_bytes())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Every kernel's entry point, the libraries built first if needed
    (the missing ones in parallel)."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sos = {n: BUILD_DIR / f"lib{n}_{_source_hash(n)}.so" for n in LIBRARIES}
    t0 = time.perf_counter()
    procs = {}
    if not all(so.exists() for so in sos.values()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # processes starting together (ranks on one card) build once: the
        # first takes the lock, the others wait and find its libraries
        with open(BUILD_DIR / "kernels.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            for n, so in sos.items():
                if not so.exists():
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SRC_DIR / f"{n}.cu")]
                    procs[n] = (tmp, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True))
            failed = []
            for n, (tmp, proc) in procs.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(
                        f"nvcc {n}.cu failed ({proc.returncode}):\n{err}")
                    continue
                os.replace(tmp, sos[n])
                sos[n].with_suffix(".log").write_text(err)
        if failed:
            raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0 if procs else 0.0
    fns, libs, logs = {}, {}, []
    for n, so in sos.items():
        lib = libs[n] = ctypes.CDLL(str(so))
        if so.with_suffix(".log").exists():
            logs.append(so.with_suffix(".log").read_text())
        for k in LIBRARIES[n]:
            fn = getattr(lib, f"pt_{k}")
            fn.argtypes = _ARGTYPES[k]
            fn.restype = ctypes.c_int
            fns[k] = fn
    _LOADED = KernelLibrary(fns=fns, libs=libs, paths=list(sos.values()),
                            build_seconds=seconds, ptxas_log="".join(logs))
    return _LOADED


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream and count it.
    Raises if the launch reports an error.  The stream is read as the raw
    handle, as PyTorch's compiler runtime reads it (no ``torch.cuda.Stream``
    object built), since a launch's host time is most of a small kernel's
    time."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    rc = (_LOADED or library()).fns[name](*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    launches[name] += 1
