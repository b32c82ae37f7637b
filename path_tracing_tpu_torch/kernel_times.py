"""Time a redesigned kernel on the card against other builds of it, on
the main path's inputs:

    python -m path_tracing_tpu_torch.kernel_times --kernel KERNEL
        [--old-csrc DIR]... [--reps N]

``KERNEL`` and its inputs:

- ``gather_flux`` (#11): the CLI's first 512x512 PPM pass on
  ``scenes/cornell.txt`` (4 lights x 262,144 = 1,048,576 photons, depths
  4, seed 0), the tables built by ``cuda_ppm_gather.prepare``;
- ``render_wavefront`` (#5): the CLI's 1920x1080 spp 4 frame on cornell
  (eye depth 4, seed 0) and on SPD's sphereflake (``flake``: the
  instance for scenes with a sphere index, with its counting build's wide
  rays a bounce, ``wide_walks`` over ``iterations``, and ``wide_steps``);
- ``photon_trace`` (#10): that PPM pass's 1,048,576 emitted photons
  (the wrapper makes no device round trip: the pass's key lives on the
  host);
- ``nearest_hit_stream`` (#6): the lanes of the first bounce of the
  stream tier's 1920x1080 spp 4 frame on the 327,680-triangle textured
  icosphere (seed 0), recorded from the render itself, sorted as the path
  sorts them and unsorted (the live lanes in lane order); then that whole
  frame rendered in the stream tier with the build's #6 in place of the
  package's (its image compared pixel by pixel);
- ``any_blocker_stream`` (#7): the NEE shadow rays of every bounce of
  that frame, recorded from the render and sorted as the path sorts them
  (the frame's blocking rule), then 2,073,600 random segments through the
  mesh under both rules (``chip_smoke.py``'s), every verdict compared;
- ``shade_step_tex`` (#4): the lanes of the first bounce of the CLI's
  1920x1080 spp 4 frame (the fused tier) on the 81,920-triangle textured
  icosphere read back from OBJ + MTL + PNG (seed 0), recorded from the
  render; then that whole frame with the build's #4 in place of the
  package's (its image compared pixel by pixel);
- ``bdpt_eye`` (#9): the tables of the 1920x1080 BDPT frame on cornell
  (spl 8, tile-local RIS K = 32, spp 4, depths 4, seed 0), as
  ``chip_smoke.py`` builds them;
- ``connect`` (#8): the 1920x1080 primary hits of the BDPT frame on
  cornell (spl 8, the exact sweep's shared table, spp 4, depths 4, seed 0)
  as ``chip_smoke.py`` phase 6 builds them (``primary``); every launch of
  that frame's fused tier, recorded by running its eye samples with a
  recording ``connect_fn`` (``launches``, timed as the sum of the frame's
  launches, every launch's output compared);
  then the whole fused frame with the build's #8 in place of the
  package's (``frame``, its image compared pixel by pixel);
- ``shade_step`` (#3): the lanes of the first bounce of the fused tier's
  1920x1080 spp 4 frame on cornell (eye depth 4, seed 0), recorded from
  the render (``first``); every bounce of that frame, recorded
  (``bounces``, timed as the sum of the frame's launches); then the whole
  fused frame with the build's #3 in place of the package's (``frame``).
- ``nearest_hit`` (#1): every launch of the split tier's 1920x1080 spp 4
  frame on cornell (eye depth 4, seed 0) with its mask, recorded from the
  render (``launches``, timed as the sum of the frame's launches); its
  first launch, every lane live (``first``); every launch of the BDPT
  fused exact frame (spl 8, spp 4, depths 4: the eye pass's, since the
  light trace is ``bdpt_light``; ``bdpt``) and of the first 512x512 PPM
  pass's eye pass as the loop ran it before ``ppm_eye`` (``ppm``,
  ``ppm_eye_plain`` on #1);
  then the whole split frame with the build's #1 in place of
  the package's (``frame``);
- ``any_blocker`` (#2): the split frame's launches (``launches``), its
  first (``first``) and the whole split frame (``frame``), as for #1;
- ``ppm_eye``: the eye pass of the CLI's first 512x512 PPM pass on
  cornell (seed 0), and ``ppm_eye_tex`` (its textured instance) that of
  a 512x512 PPM pass on the 327,680-triangle textured icosphere
  (``synth.icosphere_scene``, default framing: the super walk), each with
  the plain loop on #1 and ``threefry_rows`` (the eye pass before the
  kernel) timed and compared on every pixel, and the instances'
  occupancy;
- ``bdpt_light``: the light trace of the 1920x1080 BDPT frame on cornell
  (spl 8: 4 lights x 8 x 8 = 256 paths, light depth 4, seed 0), recorded
  from ``light_side``, with the loop on #1 and ``threefry_rows`` (the
  trace before the kernel, ``light_trace_plain``) timed with its host and
  compared on every vertex, and the six instances' occupancy.  An older
  build has no such kernel: of an ``--old-csrc`` build only its registers
  and spills are read.

#1's and #2's launches are recorded where the wrappers launch
(``record_launches``), and their outputs compared on the live lanes (the
lanes read: an older build walks every lane).

The package's kernel is timed (CUDA events, the mean of ``--reps``
launches after a warm-up), then each ``--old-csrc DIR``: the source of
``KERNEL`` in ``DIR`` with its own ``pt_device.cuh`` (for example the
parent commit's ``csrc``, unpacked with ``git archive`` into the
gitignored ``path_tracing_tpu_torch/build/``, or a copy of it edited to
try one change), all built at once with the same flags and timed on the
same inputs in turns (new, old, old, new), swapped into the library's
entries in place of the package's build, with the share of rows
(hitpoints, pixels, photons' event rows or lanes) bit-equal to the new
one's, held to ``BARS`` where one is set (the exit code is 1 if a build
misses its bar).  A build that exports the counting entry
``pt_KERNEL_counts``, or whose design kept its argument list (not in
``OLD_ARGS``), is called as the package calls its kernel; one without it
through the argument list of the design before (``OLD_ARGS``; #1 and #2
before they took a mask are called without it).  A build
whose ``pt_device.cuh`` predates the super table takes the seven
scene-table arguments of before (``prev_table_args``: the 8-column
cluster rows, no super table) in place
of the package's thirteen; one whose ``pt_device.cuh`` predates the
sphere index is called with the package's arguments less the index's
four (the spheres then in turn, as that design tests them).  A #8 build whose ``pt_connect`` takes no ``work``
counter is called with the package's arguments less that counter.

``--graph`` times the cases whose calls make no host sync (#1's and #2's
launch sets, ``ppm_eye``) device-only, by CUDA-graph replay: the PPM eye
loop's small launches are shorter than their host enqueue.

Given ``--old-csrc`` or ``--variant``, ptxas's registers and spills of
every instance of #1, #3, #4, #5, #8, #9, #10, ``ppm_eye`` and
``bdpt_light`` (``PTXAS_KERNELS``) are printed for the package's build and
for each other build, whose libraries of those kernels are built whole,
so a kernel's build can be checked against its parent's where shared
device code or another kernel of its source changed.

``--variant NAME`` (repeatable) times a copy of the package's ``csrc``
with one change (``VARIANTS``: a table placement, a launch bound, a
design option), written to ``build/variants/NAME``, as another build.
``--case LABEL`` (repeatable) times only those cases.

Prints one JSON object as its last line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .ops import _kernels

SOURCE = {"gather_flux": "ppm_kernels.cu", "render_wavefront": "pt_kernels.cu",
          "photon_trace": "ppm_kernels.cu",
          "nearest_hit_stream": "mesh_kernels.cu",
          "any_blocker_stream": "mesh_kernels.cu",
          "shade_step_tex": "pt_kernels.cu", "bdpt_eye": "bdpt_kernels.cu",
          "connect": "bdpt_kernels.cu", "shade_step": "pt_kernels.cu",
          "nearest_hit": "pt_kernels.cu", "any_blocker": "pt_kernels.cu",
          "ppm_eye": "ppm_kernels.cu", "ppm_eye_tex": "ppm_kernels.cu",
          "bdpt_light": "bdpt_kernels.cu"}
# the kernels whose registers and spills every build beside the package's
# reports: those on pt_device.cuh's BSDF (#3, #4, #5, #8, #9, #10), #1,
# ppm_eye and bdpt_light
PTXAS_KERNELS = ("shade_step", "shade_step_tex", "render_wavefront",
                 "connect", "bdpt_eye", "photon_trace", "nearest_hit",
                 "ppm_eye", "bdpt_light")
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# the scene tables before the super table: sph ns nl tri uv cl n_clusters
_TABLES = [_P, _I, _I, _P, _P, _P, _I]
# and before the sphere index: those, sup n_super
_TABLES9 = _kernels._TABLES[:9]
# the C entries of the designs before the counted ones: #11 one thread per
# hitpoint (hp hp_cell perm B | win ev r2 | flux count | stream), #5 one
# thread per pixel (no work counter), #10 one thread per photon (no work
# counter), #8 one thread per lane (no work counter), #1 and #2 without
# a mask; #6 kept its argument list
OLD_ARGS = {
    "nearest_hit": _TABLES9 + [_I, _P, _P, _I, _P, _P, _P],
    "any_blocker": _TABLES9 + [_P, _P, _P, _I, _I, _P, _P],
    "connect": _TABLES9 + [_P, _I] + [_P] * 11 + [_I, _F, _I, _P, _P],
    "gather_flux": [_P, _P, _P, _I, _P, _P, _F, _P, _P, _P],
    "render_wavefront": _TABLES + [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U,
                                   _U, _U, _U, _F, _I, _I, _P, _P],
    "photon_trace": _TABLES + [_P] * 4 + [_I, _U, _U, _U, _U, _I, _I, _P, _P,
                                          _P],
}
# a mark in the C entry of the package's design whose argument list
# changed with it (a build without it takes OLD_ARGS)
NEW_MARK = {"connect": "int* work", "nearest_hit": "const bool* live",
            "any_blocker": "const bool* live"}
# One change each to a copy of the package's csrc: (file, old, new) edits.
_PLACE = ("*place = connect_smem(kRowsResident, n_valid) <= (size_t)optin "
          "? kRowsResident : kRowsChunked;")
_CHUNKED = ("bdpt_kernels.cu", _PLACE, "*place = kRowsChunked;")
_RES_W = "constexpr int kResWarps = 24, kResMinBlocks = 1;"
_CHUNK_W = "constexpr int kChunkWarps = 4, kChunkMinBlocks = 6;"
_STEP_MIN = "constexpr int kStepMinBlocks = 8;"
_STEP_LANE = """  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) bounce_lane<false, kW>(tb, Tex{}, c, in, out, B, i, cnt);  // every lane flushes"""
_STEP_WARPS = """  __shared__ int lanes[kThreads / 32][64];
  LaneQueue lq{lanes[threadIdx.x >> 5], 0, true};
  for (;;) {
    lq.fill(&g_step_work, B, in.act, [&](int i) { SKIP; });
    const int nb = min(lq.n, 32);
    if (nb == 0) break;
    if ((int)(threadIdx.x & 31) < nb)
      bounce_lane<false, kW>(tb, Tex{}, c, in, out, B, lq.q[threadIdx.x & 31], cnt);
    lq.pop(nb);
  }"""
_STEP_GRID = ("  fn<<<blocks_for(B), kThreads, 0, stream>>>(tb, c, in, out, B, "
              "counts);")
_STEP_PERSISTENT = """  int blocks = 0, *work = nullptr;
  cudaError_t err = cudaGetSymbolAddress((void**)&work, g_step_work);
  if (err == cudaSuccess) err = cudaMemsetAsync(work, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = persistent_blocks(fn, kThreads, 0, blocks_for(B), &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, kThreads, 0, stream>>>(tb, c, in, out, B, counts);"""
_HIT_MIN = "constexpr int kHitMinBlocks = 10;"
_SHADOW_MIN = "constexpr int kShadowMinBlocks = 8;"
VARIANTS = {
    # #1's and #2's blocks of 128 an SM
    **{f"hit-min{m}": [("pt_kernels.cu", _HIT_MIN,
                        f"constexpr int kHitMinBlocks = {m};")]
       for m in (6, 8, 12)},
    **{f"shadow-min{m}": [("pt_kernels.cu", _SHADOW_MIN,
                           f"constexpr int kShadowMinBlocks = {m};")]
       for m in (6, 10, 12)},
    # #1 on persistent warps that take the live lanes 32 at a time
    # (LaneQueue), #2 one thread a lane (each kernel's other design)
    "hit-queue": [("pt_kernels.cu", "constexpr bool kHitQueue = false;",
                   "constexpr bool kHitQueue = true;")],
    "shadow-lanes": [("pt_kernels.cu", "constexpr bool kShadowQueue = true;",
                      "constexpr bool kShadowQueue = false;")],
    # #8's table placements besides the resident one: per-warp 16-row
    # chunks, rows read from device memory (both 4 warps x 6 blocks an SM)
    "connect-chunked": [_CHUNKED],
    "connect-device": [_CHUNKED,
                       ("bdpt_kernels.cu",
                        "chunk = sp + warp * kChunk * kLvCols;",
                        "chunk = nullptr;")],
    # #8's warps a block with the table resident (one block an SM)
    **{f"connect-warps{w}": [("bdpt_kernels.cu", _RES_W,
                              f"constexpr int kResWarps = {w}, "
                              "kResMinBlocks = 1;")] for w in (16, 32)},
    # #8's chunked blocks an SM
    **{f"connect-chunked-min{m}": [
        _CHUNKED,
        ("bdpt_kernels.cu", _CHUNK_W,
         f"constexpr int kChunkWarps = 4, kChunkMinBlocks = {m};")]
       for m in (4, 8)},
    # #3's blocks of 128 an SM
    **{f"shade_step-min{m}": [("pt_kernels.cu", _STEP_MIN,
                               f"constexpr int kStepMinBlocks = {m};")]
       for m in (10, 12)},
    # #3 on persistent warps that take spans of 32 lanes from a counter
    # and run the active ones 32 at a time (LaneQueue), the inactive lanes
    # of a span passed through by a copy of their state or by the bounce
    # body itself (its alive-false path)
    **{f"shade_step-{v}": [
        ("pt_kernels.cu", "// #3.  kW:",
         "__device__ int g_step_work;  // the next span of lanes\n// #3.  kW:"),
        ("pt_kernels.cu", _STEP_LANE, _STEP_WARPS.replace("SKIP", skip)),
        ("pt_kernels.cu", _STEP_GRID, _STEP_PERSISTENT)]
       for v, skip in (("copy", "store_state(out, i, load_state(in, i), "
                        "mk(0.f, 0.f, 0.f))"),
                       ("packed", "bounce_lane<false, kW>(tb, Tex{}, c, in, "
                        "out, B, i, cnt)"))},
}
PPM_W = PPM_H = 512
PPM_SPL = 262144
W, H, SPP = 1920, 1080, 4
BIG_TRIS, MESH_TRIS = 327680, 81920
SPL, RIS_K = 8, 32
ROOT = Path(__file__).resolve().parent.parent


def _ptxas(log: str, kernel: str) -> list:
    """ptxas's registers and spills of each instance of ``kernel`` in
    ``log``, a template's arguments as mangled before its line."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = re.search(rf"\d{kernel}_kernel(I\w*?EE)?", line)
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            n = re.search(r"Used (\d+) registers", line).group(1)
            inst = f"{entry.group(1)}: " if entry.group(1) else ""
            out.append(f"{inst}{n} registers, {spill}")
            entry = None
    return out


def print_ptxas(build, log: str, kernels) -> None:
    for k in kernels:
        print(f"[build] {build} {k}: " + "; ".join(_ptxas(log, k)))


def _resident(kernel: str) -> bool:
    """The kernel takes the resident scene tables first."""
    n = len(_kernels._TABLES)
    return _kernels._ARGTYPES[kernel][:n] == _kernels._TABLES


def make_variant(name: str) -> Path:
    """A copy of the package's csrc with the edits of ``VARIANTS[name]``,
    or of each variant in ``name`` joined by ``+``, in the build
    directory."""
    d = _kernels.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_kernels.SRC_DIR, d)
    for part in name.split("+"):
        for fname, old, new in VARIANTS[part]:
            f = d / fname
            text = f.read_text()
            if old not in text and new not in text:
                raise ValueError(f"variant {part}: {old!r} not in {fname}")
            f.write_text(text.replace(old, new))
    return d


def _old_abi(lib, d: Path, kernel: str) -> bool:
    """The build in ``d`` takes the argument list of the design before."""
    if kernel in NEW_MARK:
        sig = re.search(rf"int pt_{kernel}\(([^)]*)\)",
                        (d / SOURCE[kernel]).read_text()).group(1)
        return NEW_MARK[kernel] not in sig
    return (kernel in OLD_ARGS
            and not hasattr(lib, f"pt_{kernel}_counts"))


def build_all(dirs, kernel: str) -> list:
    """nvcc each directory's sources of ``kernel`` and of
    ``PTXAS_KERNELS`` (with its own header) into the build directory, all
    at once, and print each build's registers and spills of those
    kernels; returns for each directory None if its source has no
    ``kernel`` (a build from before it), else (the C entry, "now" if it
    takes the package's argument list (a build before the sphere index
    wrapped to drop the index's arguments), "tables7" if only the scene
    tables of before the super table, "old" if the design before's)."""
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = tuple(dict.fromkeys((kernel, *PTXAS_KERNELS)))
    srcs = sorted({SOURCE[k] for k in names})

    def so(i: int, src: str) -> Path:
        return _kernels.BUILD_DIR / f"lib{Path(src).stem}_old{i}.so"

    procs = {(i, src): subprocess.Popen(
        [_kernels._find_nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so(i, src)),
         str(d / src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i, d in enumerate(dirs) for src in srcs}
    logs = [""] * len(dirs)
    for (i, src), proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {dirs[i] / src} failed:\n{err}")
        logs[i] += err
    out = []
    for i, d in enumerate(dirs):
        print_ptxas(d, logs[i], names)
        lib = ctypes.CDLL(str(so(i, SOURCE[kernel])))
        if not hasattr(lib, f"pt_{kernel}"):
            print(f"[build] {d}: no {kernel}, not timed")
            out.append(None)
            continue
        fn = getattr(lib, f"pt_{kernel}")
        header = (d / "pt_device.cuh").read_text()
        n = len(_kernels._TABLES)
        if _old_abi(lib, d, kernel):
            fn.argtypes, abi = OLD_ARGS[kernel], "old"
        elif _resident(kernel) and "int nsup" not in header:
            fn.argtypes = _TABLES + _kernels._ARGTYPES[kernel][n:]
            abi = "tables7"
        elif _resident(kernel) and "int nssup" not in header:
            fn.argtypes = _TABLES9 + _kernels._ARGTYPES[kernel][n:]
            abi = "now"
        else:
            fn.argtypes, abi = _kernels._ARGTYPES[kernel], "now"
        fn.restype = ctypes.c_int
        if (_resident(kernel) and "int nsup" in header
                and "int nssup" not in header):
            fn = _without_index(fn)
        out.append((fn, abi))
    return out


def _without_index(fn):
    """A build before the sphere index, called with the package's
    arguments: the index's four dropped."""
    n = len(_TABLES9)
    return lambda *a: fn(*a[:n], *a[len(_kernels._TABLES):])


_FLAT = {}


def prev_table_args(packed) -> list:
    """The scene tables as a build before the super table takes them: the
    8-column cluster rows (a copy kept per table while it lives), no
    super table."""
    src, flat = _FLAT.get(id(packed.cl), (None, None))
    if src is not packed.cl:
        flat = packed.cl[:, :8].contiguous()
        _FLAT[id(packed.cl)] = (packed.cl, flat)
    return [ctypes.c_void_p(packed.sph.data_ptr()), packed.ns, packed.nl,
            ctypes.c_void_p(packed.tri.data_ptr()),
            ctypes.c_void_p(packed.uv.data_ptr()),
            ctypes.c_void_p(flat.data_ptr()), flat.shape[0]]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, n: int = 100, reps: int = 10) -> float:
    """Device milliseconds a call of ``fn``: ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    enqueue is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: cudaError {rc}")


def _cornell(w: int, h: int):
    """cornell on the card and its camera at w x h."""
    from .scene.camera import make_camera
    from .scene.parser import load_scene

    p = load_scene(str(ROOT / "scenes" / "cornell.txt"))
    return p.to_device("cuda"), make_camera(p.eye, p.look_at, p.view_up,
                                            p.fov, w, h, device="cuda")


class Case:
    """A kernel's inputs: ``run(fn, abi)`` launches build ``fn`` on them
    (``abi`` as ``build_all`` returns it) and keeps its outputs,
    ``rows()`` reads the last run's outputs as comparable rows; ``reps``,
    if set, caps the timed calls (a whole frame); ``graph``: the run makes
    no host sync, so ``--graph`` can time it by CUDA-graph replay."""

    def __init__(self, label: str, run, rows, info: dict, reps=None,
                 graph=False):
        self.label, self.run, self.rows, self.info = label, run, rows, info
        self.reps, self.graph = reps, graph


def _through_wrapper(name: str, wrapper, out: dict, module=None):
    """``run`` for a kernel timed through its package wrapper: a build
    with the package's argument list is swapped in for the package's own
    entry during the call, one that takes the scene tables of before with
    ``module``'s ``table_args`` (the wrapper's) swapped for
    ``prev_table_args`` too; one of the design before is called by
    ``out['old']``."""
    def run(fn, abi):
        if abi == "old":
            out["last"] = out["old"](fn)
            return
        fns = _kernels.library().fns
        own, fns[name] = fns[name], fn
        if abi == "tables7":
            own_args, module.table_args = module.table_args, prev_table_args
        try:
            out["last"] = wrapper()
        finally:
            fns[name] = own
            if abi == "tables7":
                module.table_args = own_args
    return run


def gather_case():
    """The first 512x512 PPM pass's gather tables (the CLI's own set-up)."""
    from .config import RenderConfig
    from .integrators import ppm
    from .ops import cuda_ppm_gather as cg
    from .ops import rng

    scene, cam = _cornell(PPM_W, PPM_H)
    cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                       eye_depth=4, light_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    _, hp = ppm.ppm_eye_trace(scene, cam, cfg, idx % PPM_W, idx // PPM_W,
                              rng.fold_in(key, 1))
    events = ppm.ppm_photon_trace(scene, cfg, scene.num_lights * PPM_SPL,
                                  PPM_SPL, rng.fold_in(key, 2))
    t = cg.prepare(scene, cfg, hp, events)

    def old(fn):
        B = t.hp.shape[0]
        flux = torch.empty((B, 3), device="cuda")
        count = torch.empty(B, dtype=torch.int32, device="cuda")
        _check(fn(_ptr(t.hp), _ptr(t.hp_cell), _ptr(t.perm), B, _ptr(t.win),
                  _ptr(t.ev), float(t.r2), _ptr(flux), _ptr(count),
                  _stream()), "old gather_flux")
        return flux, count

    out = dict(old=old)

    def rows():
        flux, count = out["last"]
        return torch.cat([flux, count.float()[:, None]], dim=1)

    info = dict(hitpoints=t.hp.shape[0], pairs=t.candidate_pairs(),
                items=int((t.items[:, 2] > 0).sum()),
                staged_bytes=t.staged_bytes())
    return [Case("", _through_wrapper("gather_flux", lambda: cg.join(t), out),
                 rows, info)]


def wavefront_case():
    """The 1080p spp 4 megakernel frames' arguments: cornell's (the flat
    walk) and, labelled ``flake``, SPD's sphereflake's (the indexed
    instance, whose counting build's wide-ray counters go in the case's
    line)."""
    from .config import RenderConfig
    from .ops import cuda_intersect as ci
    from .ops import cuda_wavefront as cw
    from .ops import rng
    from .scene import synth
    from .scene.camera import make_camera

    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda")
    px, py = idx % W, idx // W
    k0, k1 = (int(w) for w in key.tolist())
    B = W * H
    flake = synth.sphereflake_scene(4)
    scenes = [("", *_cornell(W, H)),
              ("flake", flake.to_device("cuda"),
               make_camera(flake.eye, flake.look_at, flake.view_up,
                           flake.fov, W, H, device="cuda"))]
    cases = []
    for label, scene, cam in scenes:
        pk = scene.packed
        lt = pk.light
        cam_tab = torch.cat([cam.eye, cam.ul, cam.dx, cam.dy]).contiguous()

        def old(fn, pk=pk, lt=lt, cam_tab=cam_tab):
            img = torch.empty((B, 3), device="cuda")
            _check(fn(*ci.table_args(pk), _ptr(lt), _ptr(cam_tab), _ptr(px),
                      _ptr(py), B, SPP, cfg.eye_depth, cfg.max_eye_iters,
                      SPP * cfg.max_eye_iters + cfg.max_eye_iters, k0, k1, 0,
                      B, float(cfg.clamp), int(cfg.pt_stub_mis_strategy_a),
                      4 if cfg.shadow_dielectrics_block else 5, _ptr(img),
                      _stream()), "old render_wavefront")
            return img

        out = dict(old=old)
        args = (pk, lt, cam, px, py, SPP, cfg, key)
        info = dict(pixels=B, spp=SPP)
        if pk.nsc:
            _, kc = cw.render_wavefront_counts(*args)
            info.update(
                iterations=kc["iterations"], wide_walks=kc["wide_walks"],
                wide_steps=kc["wide_steps"],
                wide_walks_per_iteration=kc["wide_walks"] / kc["iterations"],
                steps_per_wide_walk=kc["wide_steps"] / max(kc["wide_walks"],
                                                           1))
        cases.append(Case(label, _through_wrapper(
            "render_wavefront", lambda args=args: cw.render_wavefront(*args),
            out, cw), lambda out=out: out["last"], info))
    return cases


def photon_case():
    """The first 512x512 PPM pass's photons on cornell."""
    from .config import RenderConfig
    from .integrators import ppm
    from .ops import cuda_intersect as ci
    from .ops import cuda_photon as cp
    from .ops import rng

    scene, _ = _cornell(PPM_W, PPM_H)
    cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                       eye_depth=4, light_depth=4)
    kp = rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 2)
    emit = ppm.photon_emission(scene, scene.num_lights * PPM_SPL, PPM_SPL, kp)
    pk = scene.packed
    targs = (pk, *emit, kp, cfg.light_depth, cfg.max_light_iters)
    P = emit[0].shape[0]
    k0, k1 = (int(w) for w in rng.fold_in(kp, cp.PHOTON_STREAM).tolist())

    def old(fn):
        slots = cp.event_slots(cfg.light_depth, cfg.max_light_iters)
        ev = torch.empty((slots * P, cp.EV_COLS), device="cuda")
        valid = torch.zeros(slots * P, dtype=torch.bool, device="cuda")
        _check(fn(*ci.table_args(pk), *(_ptr(x) for x in emit), P, k0, k1, 0,
                  P, cfg.light_depth, cfg.max_light_iters, _ptr(ev),
                  _ptr(valid), _stream()), "old photon_trace")
        return ev, valid

    out = dict(old=old)

    def rows():  # the bits of each row (a NaN equals itself)
        ev, valid = out["last"]
        return torch.cat([valid.int()[:, None],
                          torch.where(valid[:, None], ev, 0.0)
                          .view(torch.int32)], dim=1)

    slots = cp.event_slots(cfg.light_depth, cfg.max_light_iters)
    return [Case("", _through_wrapper("photon_trace",
                                      lambda: cp.photon_trace(*targs), out,
                                      cp),
                 rows, dict(photons=P, event_rows=slots * P))]


def stream_case():
    """The first bounce's lanes of the stream tier's 1080p frame on the
    327,680-triangle textured icosphere, recorded from the render, sorted
    as the path sorts them and unsorted; then the whole frame."""
    from .config import RenderConfig
    from .integrators.pt import render_pt
    from .ops import cuda_stream as cst
    from .ops import rng
    from .ops.intersect import sorted_call
    from .scene import synth
    from .scene.camera import make_camera

    p = synth.icosphere_scene(BIG_TRIS, textured=True)
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    got = {}

    class Recorded(Exception):
        pass

    def record(st, ro, rd, with_uv=False, live=None):
        got.update(st=st, ro=ro, rd=rd, live=live)
        raise Recorded

    cfg = RenderConfig(width=W, height=H, spp=SPP)
    key = rng.fold_in(rng.prng_key(0), 0)
    hit = cst.stream_hit
    cst.stream_hit = record
    try:
        render_pt(scene, cam, W, H, SPP, cfg, key, tier="stream")
    except Recorded:
        pass
    finally:
        cst.stream_hit = hit
    st, live = got["st"], got["live"]

    def keep(a, b, n_live):
        got.update(sro=a.contiguous(), srd=b.contiguous(), n_live=n_live)
        return a

    sorted_call(st.bounds, got["ro"], got["rd"], keep, live=live)
    cases = []
    for label, ro, rd, n_live in (
            ("sorted", got["sro"], got["srd"], got["n_live"]),
            ("unsorted", got["ro"][live].contiguous(),
             got["rd"][live].contiguous(), None)):
        B = ro.shape[0]
        args = cst._stream_args(st, ro.device, n_live)
        outs = (torch.empty(B, device="cuda"),
                torch.empty(B, dtype=torch.int32, device="cuda"),
                torch.empty(B, dtype=torch.int32, device="cuda"))

        def run(fn, abi, args=args, ro=ro, rd=rd, B=B, n_live=n_live,
                outs=outs):
            _check(fn(*args, _ptr(ro), _ptr(rd), B,
                      ctypes.c_void_p(None if n_live is None
                                      else n_live.data_ptr()),
                      *(_ptr(x) for x in outs), _stream()),
                   "nearest_hit_stream")

        def rows(outs=outs):
            return torch.stack([outs[0].view(torch.int32), outs[1], outs[2]],
                               dim=1)

        cases.append(Case(label, run, rows, dict(
            lanes=B, live=int(live.sum()), triangles=st.nt)))
    # the whole stream frame (its 10 bounces), the build's #6 swapped in
    out = {}
    frame = _through_wrapper("nearest_hit_stream", lambda: render_pt(
        scene, cam, W, H, SPP, cfg, key, tier="stream"), out)
    cases.append(Case("frame", frame,
                      lambda: out["last"].reshape(-1, 3).view(torch.int32),
                      dict(pixels=W * H, spp=SPP)))
    return cases


def shadow_segments(st, n: int, seed: int):
    """``tests/test_torch_cuda.py``'s shadow segments at the streamed
    mesh's scale: origins in a box 1.5 times its bounds, half the segments
    aimed at its centre and half in random directions, lengths 0.05 to
    1.55 times the half-extent.  Returns (p1, rd, max_d), every lane
    live."""
    from .ops.intersect import shadow_ray

    g = torch.Generator(device=st.device).manual_seed(seed)
    u = torch.rand((7, n), device=st.device, generator=g)
    c = (st.scene_min + st.scene_max) / 2
    half = (st.scene_max - st.scene_min) / 2
    p1 = c + (2.0 * u[0:3].T - 1.0) * 1.5 * half
    d = torch.where((torch.arange(n, device=st.device) % 2 == 0)[:, None],
                    c - p1, u[3:6].T - 0.5)
    d = shadow_ray(torch.zeros_like(d), d)[0]
    length = (0.05 + 1.5 * u[6]) * half.max()
    rd, _, md = shadow_ray(p1, p1 + d * length[:, None])
    return p1.contiguous(), rd.contiguous(), md.contiguous()


def _sorted(st, p1, rd, md, live):
    """The segments in the order the path sorts them, and the live count
    it hands the kernel."""
    from .ops.intersect import sorted_call

    got = {}

    def keep(a, b, m, n_live):
        got.update(args=[a.contiguous(), b.contiguous(), m.contiguous()],
                   n_live=n_live)
        return a

    sorted_call(st.bounds, p1, rd, keep, md, live=live)
    return got["args"], got["n_live"]


def blocker_case():
    """The NEE shadow rays of every bounce of the stream tier's 1080p
    frame on the 327,680-triangle textured icosphere, recorded from the
    render and sorted as the path sorts them; then random segments
    through the mesh under both blocking rules."""
    from .config import RenderConfig
    from .integrators.pt import render_pt
    from .ops import cuda_stream as cst
    from .ops import rng
    from .scene import synth
    from .scene.camera import make_camera

    p = synth.icosphere_scene(BIG_TRIS, textured=True)
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    own, got = cst.stream_blocked, []

    def record(st, p1, rd, max_d, rule, live=None):
        got.append((st, p1.clone(), rd.clone(), max_d.clone(), rule,
                    live.clone()))
        return own(st, p1, rd, max_d, rule, live=live)

    cst.stream_blocked = record
    try:
        render_pt(scene, cam, W, H, SPP,
                  RenderConfig(width=W, height=H, spp=SPP, eye_depth=4),
                  rng.fold_in(rng.prng_key(0), 0), tier="stream")
    finally:
        cst.stream_blocked = own
    st = got[0][0]
    segs = [(f"bounce{it}", *_sorted(st, p1, rd, md, live), rule)
            for it, (_, p1, rd, md, rule, live) in enumerate(got)]
    p1, rd, md = shadow_segments(st, W * H, 7)
    every = torch.ones_like(md, dtype=torch.bool)
    segs += [(f"random_{'gpu' if rule else 'oracle'}_rule",
              *_sorted(st, p1, rd, md, every), rule) for rule in (True, False)]
    cases = []
    for label, (sp1, srd, smd), n_live, rule in segs:
        B = sp1.shape[0]
        args = cst._stream_args(st, sp1.device, n_live)
        out = torch.empty(B, dtype=torch.bool, device="cuda")

        def run(fn, abi, args=args, sp1=sp1, srd=srd, smd=smd, B=B,
                n_live=n_live, rule=rule, out=out):
            _check(fn(*args, _ptr(sp1), _ptr(srd), _ptr(smd), B,
                      _ptr(n_live), 4 if rule else 5, _ptr(out), _stream()),
                   "any_blocker_stream")

        cases.append(Case(label, run, lambda out=out: out.int()[:, None],
                          dict(lanes=B, live=int(n_live),
                               dielectrics_block=rule)))
    return cases


def _state_rows(o: dict) -> torch.Tensor:
    """A bounce's outputs as rows of 32-bit words (floats by their
    bits)."""
    n = o["ro"].shape[0]
    return torch.cat([x.reshape(n, -1).view(torch.int32)
                      if x.dtype == torch.float32 else x.reshape(n, -1).int()
                      for x in o.values()], dim=1)


def tex_case():
    """The first bounce's lanes of the CLI's 1080p frame on the
    81,920-triangle textured icosphere (OBJ + MTL + PNG, the fused tier),
    recorded from the render; then the whole frame."""
    from .config import RenderConfig
    from .integrators.pt import render_pt
    from .ops import cuda_shade as cs
    from .ops import rng
    from .scene import synth
    from .scene.camera import make_camera
    from .scene.obj_loader import load_any_scene

    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = synth.write_obj(synth.icosphere_scene(MESH_TRIS, textured=True),
                          str(_kernels.BUILD_DIR / f"icosphere_{MESH_TRIS}"
                              ".obj"))
    p = load_any_scene(obj)
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    own, got = cs.shade_step_tex, {}

    def record(*args, **kw):
        if not got:
            got.update(args=[x.clone() if torch.is_tensor(x) else x
                             for x in args], kw=kw)
        return own(*args, **kw)

    cs.shade_step_tex = record
    try:
        render_pt(scene, cam, W, H, SPP, cfg, key, tier="fused")
    finally:
        cs.shade_step_tex = own
    args, kw = got["args"], got["kw"]
    out, frame = {}, {}
    lanes = Case("lanes", _through_wrapper(
        "shade_step_tex", lambda: cs.shade_step_tex(*args, **kw), out, cs),
        lambda: _state_rows(out["last"]),
        dict(lanes=args[2].shape[0], active=int(args[7].sum()),
             supers=args[0].n_super))
    whole = Case("frame", _through_wrapper(
        "shade_step_tex", lambda: render_pt(scene, cam, W, H, SPP, cfg, key,
                                            tier="fused"), frame, cs),
        lambda: frame["last"].reshape(-1, 3).view(torch.int32),
        dict(pixels=W * H, spp=SPP))
    return [lanes, whole]


def eye_case():
    """The tables of the 1080p BDPT frame on cornell (tile-local RIS K =
    32, spl 8, spp 4), built by the integrator's own functions."""
    from .config import RenderConfig
    from .integrators import bdpt
    from .ops import cuda_bdpt_eye as ce
    from .ops import rng

    scene, cam = _cornell(W, H)
    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=RIS_K)
    key = rng.fold_in(rng.prng_key(0), 0)
    used, lv, scale = bdpt.light_side(scene, cfg, SPL, key)
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda")
    px, py = idx % W, idx // W
    tab, nv = bdpt.light_table(used, lv, cam, cfg, px, py, key)
    pk, out = used.packed, {}
    wrapper = (lambda: ce.bdpt_eye(pk, tab, nv, cam, px, py, SPP, cfg, key,
                                   scale))
    return [Case("", _through_wrapper("bdpt_eye", wrapper, out, ce),
                 lambda: out["last"].view(torch.int32),
                 dict(pixels=W * H, spp=SPP, rows=int(nv)))]


def _old_entry(fn, abi, m: int):
    """Build ``fn`` as the library's entry of its kernel: one of the design
    before (``abi`` "old") is called with the package's arguments less
    argument ``m`` (#8's ``work`` counter, #1's and #2's mask)."""
    if abi != "old":
        return fn
    return lambda *a: fn(*a[:m], *a[m + 1:])


# the argument the designs before #8's and #1's/#2's did not take: #8's
# work counter (before out and the stream), the mask (after with_uv ro rd,
# or p1 rd max_d)
_CONNECT_WORK = len(_kernels._ARGTYPES["connect"]) - 3
_MASK = len(_kernels._TABLES) + 3


def _swapped(name: str, fn, call):
    """``call()`` with build ``fn`` in place of the package's kernel
    ``name`` in the library's entries."""
    fns = _kernels.library().fns
    own, fns[name] = fns[name], fn
    try:
        return call()
    finally:
        fns[name] = own


def _recorder(fn, got: list, check=None):
    """``fn`` that appends the arguments and keywords of every call to
    ``got``, the tensors cloned, with whether ``check(args, out)`` held
    (when given)."""
    def record(*args, **kw):
        out = fn(*args, **kw)
        got.append(([x.clone() if torch.is_tensor(x) else x for x in args],
                    kw, check is None or check(args, out)))
        return out
    return record


def _recorded(module, attr: str, call) -> list:
    """The arguments and keywords of every call of ``module.attr`` made by
    ``call()`` (``_recorder``'s)."""
    own, got = getattr(module, attr), []
    setattr(module, attr, _recorder(own, got))
    try:
        call()
    finally:
        setattr(module, attr, own)
    return got


def connect_case():
    """#8 on the 1080p primary hits of the exact BDPT frame on cornell,
    on every launch of its fused tier, and the whole fused frame."""
    from .config import RenderConfig
    from .integrators import bdpt
    from .ops import cuda_connect as cc
    from .ops import cuda_intersect as ci
    from .ops import rng
    from .ops.intersect import hit_from_fields
    from .ops.math3 import normalize
    from .scene.camera import primary_ray_dirs

    scene, cam = _cornell(W, H)
    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=0)
    key = rng.fold_in(rng.prng_key(0), 0)
    B = W * H
    used, lv, lhs = bdpt.light_side(scene, cfg, SPL, key)
    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    tab, nv = bdpt.light_table(used, lv, cam, cfg, idx % W, idx // W, key)
    pk = used.packed
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    rd = primary_ray_dirs(cam, idx % W, idx // W, u[6], u[7])
    ro = cam.eye[None].expand(B, 3).contiguous()
    hit = hit_from_fields(ci.nearest_hit(pk, ro, rd), ro, rd)
    act = hit.hit & ~hit.is_light
    eye_f = torch.where(hit.mtl.eta > 0.0, torch.zeros_like(u[0]),
                        1e8 * (1.0 + u[0] * 4.0))
    args = (pk, tab, nv, hit.pos, hit.normal,
            (u[1:4].T * 0.5 + 0.5).contiguous(), hit.mtl, -rd,
            normalize(cam.eye[None] - hit.pos), eye_f, act)
    kw = dict(clamp_val=15.0, dielectrics_block=True)

    def connect_with(fn, abi, a, k):
        return _swapped("connect", _old_entry(fn, abi, _CONNECT_WORK),
                        lambda: cc.connect(*a, **k))

    out = {}

    def primary(fn, abi):
        out["primary"] = connect_with(fn, abi, args, kw)

    def render():
        return bdpt.render_bdpt(scene, cam, W, H, SPP, SPL, cfg, key,
                                tier="fused")

    # the fused frame's launches: its eye samples, as its tier runs them,
    # through a connect_fn that records them
    calls = []
    record = _recorder(cc.connect, calls,
                       lambda a, o: bool((o[~a[10]] == 0).all()))
    for s in range(SPP):
        bdpt.eye_sample(pk, cam, cfg, tab, nv, idx % W, idx // W,
                        bdpt._sample_key(key, s), lhs, connect_fn=record)
    zero = all(z for _, _, z in calls)

    def launches(fn, abi):
        out["launches"] = [connect_with(fn, abi, a, k) for a, k, _ in calls]

    def frame(fn, abi):
        out["frame"] = _swapped("connect",
                                _old_entry(fn, abi, _CONNECT_WORK), render)

    def bits(x):
        return x.reshape(-1, 3).view(torch.int32)

    active = [int(a[10].sum()) for a, _, _ in calls]
    primary(_kernels.library().fns["connect"], "now")
    return [
        Case("primary", primary, lambda: bits(out["primary"]),
             dict(lanes=B, active=int(act.sum()), rows=int(nv),
                  inactive_zero=bool((out["primary"][~act] == 0).all()))),
        Case("launches", launches,
             lambda: torch.cat([bits(x) for x in out["launches"]]),
             dict(launches=len(calls), active=active, inactive_zero=zero),
             reps=1),
        Case("frame", frame, lambda: bits(out["frame"]),
             dict(pixels=B, spp=SPP), reps=1)]


def step_case():
    """#3 on the first bounce and every bounce of the fused tier's 1080p
    spp 4 frame on cornell, and the whole fused frame."""
    from .config import RenderConfig
    from .integrators.pt import render_pt
    from .ops import cuda_shade as cs
    from .ops import rng

    scene, cam = _cornell(W, H)
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)

    def render():
        return render_pt(scene, cam, W, H, SPP, cfg, key, tier="fused")

    calls = _recorded(cs, "shade_step", render)
    out = {}

    def step_with(fn, a, k):
        return _swapped("shade_step", fn, lambda: cs.shade_step(*a, **k))

    def first(fn, abi):
        out["first"] = step_with(fn, *calls[0][:2])

    def bounces(fn, abi):
        out["bounces"] = [step_with(fn, a, k) for a, k, _ in calls]

    def frame(fn, abi):
        out["frame"] = _swapped("shade_step", fn, render)

    active = [int(a[7].sum()) for a, _, _ in calls]
    return [
        Case("first", first, lambda: _state_rows(out["first"]),
             dict(lanes=W * H, active=active[0])),
        Case("bounces", bounces,
             lambda: torch.cat([_state_rows(o) for o in out["bounces"]]),
             dict(launches=len(calls), active=active)),
        Case("frame", frame,
             lambda: out["frame"].reshape(-1, 3).view(torch.int32),
             dict(pixels=W * H, spp=SPP))]


def record_launches(call) -> tuple:
    """``call()``'s result and the arguments of each launch of #1 and #2
    that it makes, recorded where the wrappers launch
    (``cuda_intersect._launch_hit``, ``_launch_blocker``), the tensors
    cloned: ``{"nearest_hit": [(packed, ro, rd, with_uv, live), ...],
    "any_blocker": [(packed, p1, rd, max_d, dielectrics_block, live),
    ...]}`` in launch order, the counting builds' launches left out."""
    from .ops import cuda_intersect as ci

    got = {"nearest_hit": [], "any_blocker": []}
    own = {"_launch_hit": ci._launch_hit,
           "_launch_blocker": ci._launch_blocker}

    def recording(fn):
        def launch(name, *args, **kw):
            if name in got:
                got[name].append(tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in args))
            return fn(name, *args, **kw)
        return launch

    for attr, fn in own.items():
        setattr(ci, attr, recording(fn))
    try:
        res = call()
    finally:
        for attr, fn in own.items():
            setattr(ci, attr, fn)
    return res, got


def launch_rows(name: str, out, args) -> torch.Tensor:
    """A recorded launch's outputs (#1's fields or #2's verdicts) as rows
    of 32-bit words on its live lanes (``args``' last, the mask)."""
    if name == "any_blocker":
        x = out.int()[:, None]
    else:
        x = torch.stack([v.view(torch.int32) if v.dtype == torch.float32
                         else v for v in out.values()], dim=1)
    return x if args[-1] is None else x[args[-1]]


def lanes_case(name: str) -> list:
    """#1 (``name`` "nearest_hit") or #2 ("any_blocker") on the recorded
    launches of the split frame, its first, the BDPT fused exact frame and
    the PPM eye loop (#1), and the whole split frame."""
    from .config import RenderConfig
    from .integrators import bdpt
    from .integrators.pt import render_pt
    from .ops import cuda_intersect as ci
    from .ops import cuda_ppm_eye as ce
    from .ops import rng

    scene, cam = _cornell(W, H)
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    wrapper = getattr(ci, name)

    def split():
        return render_pt(scene, cam, W, H, SPP, cfg, key, tier="split")

    sets = {"launches": record_launches(split)[1][name]}
    sets["first"] = sets["launches"][:1]
    if name == "nearest_hit":
        bcfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                            light_depth=4, bdpt_resample_vertices=0)
        sets["bdpt"] = record_launches(lambda: bdpt.render_bdpt(
            scene, cam, W, H, SPP, SPL, bcfg, key, tier="fused"))[1][name]
        pscene, pcam = _cornell(PPM_W, PPM_H)
        pcfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                            eye_depth=4, light_depth=4)
        idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
        sets["ppm"] = record_launches(lambda: ce.ppm_eye_plain(
            pscene.packed, pcam, pcfg, idx % PPM_W, idx // PPM_W,
            rng.fold_in(key, 1)))[1][name]
    out, cases = {}, []
    for label, calls in sets.items():
        def run(fn, abi, label=label, calls=calls):
            out[label] = _swapped(name, _old_entry(fn, abi, _MASK),
                                  lambda: [wrapper(*a) for a in calls])

        def rows(label=label, calls=calls):
            return torch.cat([launch_rows(name, o, a)
                              for o, a in zip(out[label], calls)])

        live = [a[1].shape[0] if a[-1] is None else int(a[-1].sum())
                for a in calls]
        cases.append(Case(label, run, rows, dict(
            launches=len(calls), lanes=calls[0][1].shape[0], live=live),
            reps=1 if len(calls) > 1 else None, graph=True))

    def frame(fn, abi):
        out["frame"] = _swapped(name, _old_entry(fn, abi, _MASK), split)

    cases.append(Case("frame", frame,
                      lambda: out["frame"].reshape(-1, 3).view(torch.int32),
                      dict(pixels=W * H, spp=SPP), reps=1))
    return cases


def eye_pass_case(textured: bool) -> list:
    """The eye pass of a 512x512 PPM pass (seed 0's first) through
    ``ppm_eye``: on cornell, or on the 327,680-triangle textured icosphere
    (``ppm_eye_tex``); the plain loop on #1 and ``threefry_rows`` timed
    and compared bit for bit beside it."""
    from .config import RenderConfig
    from .ops import cuda_ppm_eye as ce
    from .ops import rng
    from .ops.cuda_ppm_eye import eye_pass_bits
    from .scene import synth
    from .scene.camera import make_camera

    if textured:
        p = synth.icosphere_scene(BIG_TRIS, textured=True)
        scene = p.to_device("cuda")
        cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, PPM_W, PPM_H,
                          device="cuda")
    else:
        scene, cam = _cornell(PPM_W, PPM_H)
    cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                       eye_depth=4, light_depth=4)
    key = rng.fold_in(rng.fold_in(rng.prng_key(0), 0), 1)
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    pk, out = scene.packed, {}
    args = (pk, cam, cfg, idx % PPM_W, idx // PPM_W, key)
    name = "ppm_eye_tex" if textured else "ppm_eye"
    run = _through_wrapper(name, lambda: ce.ppm_eye(*args), out, ce)
    run(_kernels.library().fns[name], "now")
    plain = ce.ppm_eye_plain(*args)
    same = (eye_pass_bits(plain) == eye_pass_bits(out["last"])).all(
        dim=1).float().mean()
    return [Case("", run, lambda: eye_pass_bits(out["last"]), dict(
        pixels=PPM_W * PPM_H, triangles=scene.num_triangles,
        supers=pk.n_super, hitpoints=int(out["last"][1].valid.sum()),
        plain_ms=time_ms(lambda: ce.ppm_eye_plain(*args), 3),
        plain_bit_equal=same.item(), occupancy=ce.occupancy()[name]),
        graph=True)]


def light_case() -> list:
    """The light trace of the 1920x1080 BDPT frame on cornell (spl 8, 256
    paths, light depth 4, seed 0's first frame) through ``bdpt_light``,
    its arguments recorded from ``light_side``; the loop on #1 and
    ``threefry_rows`` (the trace before the kernel) timed with its host
    and compared on every vertex beside it."""
    from .config import RenderConfig
    from .integrators import bdpt
    from .ops import cuda_bdpt_light as cbl
    from .ops import rng

    scene, _ = _cornell(W, H)
    cfg = RenderConfig(width=W, height=H, spp=SPP, spl=SPL, eye_depth=4,
                       light_depth=4, bdpt_resample_vertices=RIS_K)
    key = rng.fold_in(rng.prng_key(0), 0)
    args = _recorded(bdpt, "light_trace", lambda: bdpt.light_side(
        scene, cfg, SPL, key))[0][0]
    out = {}
    run = _through_wrapper("bdpt_light", lambda: cbl.light_trace(*args), out)
    run(_kernels.library().fns["bdpt_light"], "now")
    plain = cbl.light_vertex_bits(cbl.light_trace_plain(*args))
    same = (plain == cbl.light_vertex_bits(out["last"])).all(
        dim=1).float().mean()
    return [Case("", run, lambda: cbl.light_vertex_bits(out["last"]), dict(
        paths=args[3].shape[0], stored=int(out["last"].valid[:, 1:].sum()),
        plain_ms=time_ms(lambda: cbl.light_trace_plain(*args), 3),
        plain_bit_equal=same.item(),
        occupancy=cbl.occupancy()), graph=True)]


CASES = {"gather_flux": gather_case, "render_wavefront": wavefront_case,
         "photon_trace": photon_case, "nearest_hit_stream": stream_case,
         "any_blocker_stream": blocker_case, "shade_step_tex": tex_case,
         "bdpt_eye": eye_case, "connect": connect_case,
         "shade_step": step_case,
         "nearest_hit": lambda: lanes_case("nearest_hit"),
         "any_blocker": lambda: lanes_case("any_blocker"),
         "ppm_eye": lambda: eye_pass_case(False),
         "ppm_eye_tex": lambda: eye_pass_case(True),
         "bdpt_light": light_case}
# the share of rows an older build must give bit for bit, where a bar is
# set: #4 may pick another triangle on an exact tie of t (its frame the
# image's pixels), #7's verdicts never differ, #8's, #3's, #1's and #2's
# redesigns change no lane read, launch or pixel
BARS = {("shade_step_tex", "lanes"): 0.9999,
        ("shade_step_tex", "frame"): 0.999, ("any_blocker_stream", None): 1.0,
        ("connect", None): 1.0, ("shade_step", None): 1.0,
        ("nearest_hit", None): 1.0, ("any_blocker", None): 1.0}
ROWS = {"gather_flux": "hitpoints", "render_wavefront": "pixels",
        "photon_trace": "event rows", "nearest_hit_stream": "lanes",
        "any_blocker_stream": "lanes", "shade_step_tex": "lanes",
        "bdpt_eye": "pixels", "connect": "lanes", "shade_step": "lanes",
        "nearest_hit": "live lanes", "any_blocker": "live lanes",
        "ppm_eye": "pixels", "ppm_eye_tex": "pixels",
        "bdpt_light": "vertices"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=sorted(SOURCE))
    ap.add_argument("--old-csrc", type=Path, action="append", default=[],
                    help="an older kernel source directory (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="the package's csrc with one change of VARIANTS, "
                    "or several joined by + (repeatable)")
    ap.add_argument("--case", action="append", default=[],
                    help="time only the cases of this label (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--graph", action="store_true",
                    help="time the cases that allow it device-only, by "
                    "CUDA-graph replay")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    k = a.kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    own = _kernels.library().fns[k]
    dirs = a.old_csrc + [make_variant(v) for v in a.variant]
    print_ptxas("package", _kernels.library().ptxas_log,
                dict.fromkeys((k, *PTXAS_KERNELS)) if dirs else (k,))
    olds = build_all(dirs, k)
    out = dict(card=torch.cuda.get_device_name(0), kernel=k)
    missed = []
    for case in CASES[k]():
        if a.case and case.label not in a.case:
            continue
        tag = f"{k} {case.label}".strip()
        reps = min(a.reps, case.reps or a.reps)
        timer = graph_ms if a.graph and case.graph else time_ms
        if case.info.get("inactive_zero") is False:
            missed.append(f"{tag}: the package's build wrote non-zero "
                          "inactive lanes")

        def new(case=case):
            case.run(own, "now")

        new()
        ref = case.rows().clone()
        res = dict(case.info, ms=timer(new, reps))
        print(f"[{tag}] {case.info}: {res['ms']:.3f} ms")
        for d, old in zip(dirs, olds):
            if old is None:
                continue
            fn, abi = old

            def other(fn=fn, abi=abi, case=case):
                case.run(fn, abi)

            other()
            equal = (case.rows() == ref).all(dim=1).float().mean().item()
            turns = [timer(new, reps), timer(other, reps),
                     timer(other, reps), timer(new, reps)]
            res[f"old {d}"] = dict(bit_equal=equal,
                                   turns_new_other_other_new=turns)
            bar = BARS.get((k, case.label), BARS.get((k, None)))
            if bar is not None and equal < bar:
                missed.append(f"{tag} old {d}: {equal:.6f} < {bar}")
            print(f"[{tag}] old {d}: bit-equal on {equal:.6f} of "
                  f"{ROWS[k]}; new, old, old, new: "
                  f"{[round(x, 4) for x in turns]} ms")
        if case.label:
            out[case.label] = res
        else:
            out.update(res)
    print(json.dumps(out))
    for m in missed:
        print(f"kernel_times: bit-equal bar missed: {m}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
