"""Time the PPM gather #11 ``gather_flux`` or the PT megakernel #5
``render_wavefront`` on the card against other builds of it, on the main
path's inputs:

    python -m path_tracing_tpu_torch.kernel_times --kernel gather_flux
        [--old-csrc DIR]... [--reps N]

``gather_flux``: the CLI's first 512x512 PPM pass on ``scenes/cornell.txt``
(4 lights x 262,144 = 1,048,576 photons, depths 4, seed 0), the tables
built by ``cuda_ppm_gather.prepare``.  ``render_wavefront``: the CLI's
1920x1080 spp 4 frame on cornell (eye depth 4, seed 0).  The package's
kernel is timed (CUDA events, the mean of ``--reps`` launches after a
warm-up), then:

- each ``--old-csrc DIR``: ``DIR/ppm_kernels.cu`` or ``DIR/pt_kernels.cu``
  with its own ``pt_device.cuh`` (for example the parent commit's
  ``csrc``, unpacked with ``git archive`` into the gitignored
  ``path_tracing_tpu_torch/build/``), built with the same flags, called
  through the argument list of the design before this one (``OLD_ARGS``)
  and timed on the same inputs in turns (new, old, old, new), with the
  share of hitpoints (flux and count) or pixels bit-equal to the new one.

Prints one JSON object as its last line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

from .ops import _kernels

SOURCE = {"gather_flux": "ppm_kernels.cu", "render_wavefront": "pt_kernels.cu"}
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_TABLES = [_P, _I, _I, _P, _P, _P, _I]
# the C entries of the designs before this one: #11 one thread per
# hitpoint (hp hp_cell perm B | win ev r2 | flux count | stream), #5 one
# thread per pixel (no work counter)
OLD_ARGS = {
    "gather_flux": [_P, _P, _P, _I, _P, _P, _F, _P, _P, _P],
    "render_wavefront": _TABLES + [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U,
                                   _U, _U, _U, _F, _I, _I, _P, _P],
}
PPM_W = PPM_H = 512
PPM_SPL = 262144
W, H, SPP = 1920, 1080, 4


def build(src_dir: Path, kernel: str, tag: str, argtypes):
    """nvcc ``src_dir``'s source of ``kernel`` (with its own header) into
    the build directory; returns its C entry with ``argtypes`` (the stream
    last)."""
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _kernels.BUILD_DIR / f"lib{kernel}_{tag}.so"
    subprocess.run([_kernels._find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                    str(so), str(src_dir / SOURCE[kernel])], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), f"pt_{kernel}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: cudaError {rc}")


def gather_case():
    """The first 512x512 PPM pass's gather tables (the CLI's own set-up),
    the new kernel and the calls of the other builds."""
    from .config import RenderConfig
    from .integrators import ppm
    from .ops import cuda_ppm_gather as cg
    from .ops import rng
    from .scene.camera import make_camera
    from .scene.parser import load_scene

    p = load_scene(str(Path(__file__).resolve().parent.parent / "scenes"
                       / "cornell.txt"))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, PPM_W, PPM_H,
                      device="cuda")
    cfg = RenderConfig(width=PPM_W, height=PPM_H, spp=SPP, spl=PPM_SPL,
                       eye_depth=4, light_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(PPM_W * PPM_H, dtype=torch.int32, device="cuda")
    _, hp = ppm.ppm_eye_trace(scene, cam, cfg, idx % PPM_W, idx // PPM_W,
                              rng.fold_in(key, 1))
    events = ppm.ppm_photon_trace(scene, cfg, scene.num_lights * PPM_SPL,
                                  PPM_SPL, rng.fold_in(key, 2))
    t = cg.prepare(scene, cfg, hp, events)

    def new():
        return torch.cat([x.float()[:, None] if x.dim() == 1 else x
                          for x in cg.join(t)], dim=1)

    def old(fn):
        B = t.hp.shape[0]
        flux = torch.empty((B, 3), device="cuda")
        count = torch.empty(B, dtype=torch.int32, device="cuda")
        _check(fn(_ptr(t.hp), _ptr(t.hp_cell), _ptr(t.perm), B, _ptr(t.win),
                  _ptr(t.ev), float(t.r2), _ptr(flux), _ptr(count),
                  _stream()), "old gather_flux")
        return torch.cat([flux, count.float()[:, None]], dim=1)

    info = dict(hitpoints=t.hp.shape[0], pairs=t.candidate_pairs(),
                items=int((t.items[:, 2] > 0).sum()),
                staged_bytes=t.staged_bytes())
    return new, old, info


def wavefront_case():
    """The 1080p spp 4 cornell frame's megakernel arguments, the new
    kernel and the calls of the other builds."""
    from .config import RenderConfig
    from .integrators.pt import _light_table
    from .ops import cuda_intersect as ci
    from .ops import cuda_wavefront as cw
    from .ops import rng
    from .scene.camera import make_camera
    from .scene.parser import load_scene

    p = load_scene(str(Path(__file__).resolve().parent.parent / "scenes"
                       / "cornell.txt"))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    cfg = RenderConfig(width=W, height=H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    idx = torch.arange(W * H, dtype=torch.int32, device="cuda")
    pk, lt = ci.pack_scene(scene), _light_table(scene)
    px, py = idx % W, idx // W
    cam_tab = torch.cat([cam.eye, cam.ul, cam.dx, cam.dy]).contiguous()
    k0, k1 = (int(w) for w in key.tolist())
    B = W * H

    def args(out):
        return (*ci.table_args(pk), _ptr(lt), _ptr(cam_tab), _ptr(px),
                _ptr(py), B, SPP, cfg.eye_depth, cfg.max_eye_iters,
                SPP * cfg.max_eye_iters + cfg.max_eye_iters, k0, k1, 0, B,
                float(cfg.clamp), int(cfg.pt_stub_mis_strategy_a),
                4 if cfg.shadow_dielectrics_block else 5)

    def new():
        return cw.render_wavefront(pk, lt, cam, px, py, SPP, cfg, key)

    def old(fn):
        out = torch.empty((B, 3), device="cuda")
        _check(fn(*args(out), _ptr(out), _stream()), "old render_wavefront")
        return out

    return new, old, dict(pixels=B, spp=SPP)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=sorted(SOURCE))
    ap.add_argument("--old-csrc", type=Path, action="append", default=[],
                    help="an older kernel source directory (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    k = a.kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    _kernels.library()
    olds = [(f"old {d}", build(d, k, f"old{i}", OLD_ARGS[k]))
            for i, d in enumerate(a.old_csrc)]
    new, old, info = (gather_case if k == "gather_flux"
                      else wavefront_case)()
    out = dict(card=torch.cuda.get_device_name(0), kernel=k, **info)
    ref = new()
    out["ms"] = time_ms(new, a.reps)
    print(f"[{k}] {info}: {out['ms']:.3f} ms")
    for what, fn in olds:
        call = functools.partial(old, fn)
        img = call()
        torch.cuda.synchronize()
        equal = (img == ref).all(dim=1).float().mean().item()
        turns = [time_ms(new, a.reps), time_ms(call, a.reps),
                 time_ms(call, a.reps), time_ms(new, a.reps)]
        out[what] = dict(bit_equal=equal, turns_new_other_other_new=turns)
        print(f"[{k}] {what}: bit-equal on {equal:.6f} of "
              f"{'hitpoints' if k == 'gather_flux' else 'pixels'}; new, "
              f"{what}, {what}, new: {[round(x, 3) for x in turns]} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
