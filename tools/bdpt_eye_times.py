"""Time the BDPT eye megakernel #9 ``bdpt_eye`` on the card against other
builds of it, on the tables of ``chip_smoke.py``'s 1920x1080 BDPT frame:

    python3 tools/bdpt_eye_times.py [--old-csrc DIR]... [--variant NAME]...
        [--reps N]

For tile-RIS K = 32 at spp 4 (the main path) and the exact sweep at spp 1,
#9's time (CUDA events, the mean of ``--reps`` launches after a warm-up),
then:

- each ``--old-csrc DIR``: ``DIR/bdpt_kernels.cu`` with its own
  ``pt_device.cuh`` (for example the parent commit's ``csrc``, unpacked
  with ``git archive`` into the gitignored ``path_tracing_tpu_torch/build/``),
  built with the same flags and timed on the same inputs in turns (new,
  old, old, new), its image compared with the new one;
- each ``--variant`` (``VARIANTS``): the package's sources rebuilt with a
  part of the work cut out, and timed.  ``no-shadow`` takes every shadow
  ray as clear and ``no-sweep`` skips the connection sweep, so their
  images are wrong; their times split the kernel's time, since no profiler
  of the card's counters runs there.

The counts, the counted bound and the occupancy are ``chip_smoke.py``'s
phase 6: run it in the same call to set these times against that bound.
Prints one JSON object as its last line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

EYE = "bdpt_kernels.cu"
# each: the text of bdpt_kernels.cu to replace, and its replacement
VARIANTS = {
    "no-shadow": ("add = !shadow_blocked_dev(tb, p1, srd, md, blocks_col, "
                  "cnt) && who < 32;", "add = who < 32;"),
    "no-sweep": ("const V3 acc =\n        warp_sweep(tb, e, has_v, rows, "
                 "chunk, tab.n_valid, q, g.clamp_val, g.blocks_col, cnt);",
                 "const V3 acc = mk(0.f, 0.f, 0.f);"),
}


def build_eye(csrc: Path, tag: str):
    """Build ``csrc/bdpt_kernels.cu`` beside the package's libraries and
    return its ``pt_bdpt_eye``."""
    from path_tracing_tpu_torch.ops import _kernels

    so = _kernels.BUILD_DIR / f"libbdpt_kernels_{tag}.so"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._find_nvcc(), *_kernels.NVCC_FLAGS, "-o",
                    str(so), str(csrc / EYE)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).pt_bdpt_eye
    fn.argtypes = _kernels._ARGTYPES["bdpt_eye"]
    fn.restype = ctypes.c_int
    return fn


def variant_csrc(name: str) -> Path:
    """A copy of the package's kernel sources with variant ``name``'s
    edit."""
    from path_tracing_tpu_torch.ops import _kernels

    dest = _kernels.BUILD_DIR / f"variant_{name}"
    dest.mkdir(parents=True, exist_ok=True)
    old, new = VARIANTS[name]
    text = (_kernels.SRC_DIR / EYE).read_text()
    if old not in text:
        raise RuntimeError(f"variant {name}: {old!r} not found")
    (dest / EYE).write_text(text.replace(old, new))
    for h in _kernels.HEADERS:
        (dest / h).write_text((_kernels.SRC_DIR / h).read_text())
    return dest


def other_eye(fn, packed, tab, n_valid, cam, px, py, spp, cfg, key, scale):
    """Another build's ``pt_bdpt_eye`` on ``bdpt_eye``'s arguments."""
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.ops.cuda_bdpt_eye import TILE_LANES
    from path_tracing_tpu_torch.ops.cuda_intersect import table_args

    B = px.shape[0]
    tiled = tab.dim() == 3
    cam_tab = torch.cat([cam.eye, cam.ul, cam.dx, cam.dy]).contiguous()
    out = torch.empty((B, 3), device="cuda")
    k0, k1 = (int(w) for w in rng.fold_in(key, 0x0202).tolist())
    rc = fn(*table_args(packed), ctypes.c_void_p(tab.data_ptr()),
            int(n_valid), TILE_LANES if tiled else 0,
            tab.shape[1] * tab.shape[2] if tiled else 0,
            ctypes.c_void_p(cam_tab.data_ptr()),
            ctypes.c_void_p(px.data_ptr()), ctypes.c_void_p(py.data_ptr()),
            B, spp, cfg.eye_depth, cfg.max_eye_iters, k0, k1, 0, B,
            float(cfg.clamp), 4 if cfg.shadow_dielectrics_block else 5,
            float(scale), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"other pt_bdpt_eye: cudaError {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, action="append", default=[],
                    help="an older kernel source directory (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    out = dict(card=cs.phase_card())
    cs.phase_build()
    from path_tracing_tpu_torch.ops import cuda_bdpt_eye as ce
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    olds = {d.name: build_eye(d, f"old_{d.name}") for d in a.old_csrc}
    variants = {v: build_eye(variant_csrc(v), f"variant_{v}")
                for v in a.variant}
    parsed = load_scene(str(cs.SCENE))
    scene = parsed.to_device("cuda")
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      cs.W, cs.H, device="cuda")
    for what, K, spp in (("tile-RIS K=32", cs.RIS_K, cs.SPP),
                         ("exact", 0, 1)):
        cfg, key, used, tab, nv, px, py, scale = cs.bdpt_frame(scene, cam, K)
        args = (used.packed, tab, nv, cam, px, py, spp, cfg, key,
                scale)
        img = ce.bdpt_eye(*args)
        reps = a.reps if K else 1
        r = dict(rows=nv, spp=spp,
                 ms=cs.time_ms(lambda: ce.bdpt_eye(*args), reps))
        print(f"[1080p] {what} spp {spp} ({nv} rows): {r['ms']:.2f} ms")
        for tag, fn in olds.items():
            ref = other_eye(fn, *args)
            close = cs.share_close(img, ref)
            rel = abs(img.mean().item() - ref.mean().item()) / max(
                ref.mean().item(), 1e-6)
            turns = [cs.time_ms(lambda: ce.bdpt_eye(*args), reps),
                     cs.time_ms(lambda: other_eye(fn, *args), reps),
                     cs.time_ms(lambda: other_eye(fn, *args), reps),
                     cs.time_ms(lambda: ce.bdpt_eye(*args), reps)]
            r[f"old_{tag}"] = dict(close=close, mean_rel=rel,
                                   turns_new_old_old_new=turns)
            print(f"[1080p] {what}: {tag} within rtol 1e-4 / atol 1e-5 on "
                  f"{close:.6f} of pixels, mean rel {rel:.3g}; new, old, "
                  f"old, new: {turns} ms")
        for v, fn in variants.items():
            r[f"variant_{v}_ms"] = cs.time_ms(lambda: other_eye(fn, *args),
                                              reps)
            print(f"[1080p] {what}: variant {v}: "
                  f"{r[f'variant_{v}_ms']:.2f} ms")
        out[f"eye_{'ris' if K else 'exact'}"] = r
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
