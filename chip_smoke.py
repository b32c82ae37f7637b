"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Card: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: builds the CUDA kernels from ``path_tracing_tpu_torch/csrc`` and
   prints the build seconds and ptxas registers and spills.
3. Kernels against their plain PyTorch versions on ``scenes/cornell.txt``,
   at the main path's lane count (1920x1080 = 2,073,600), with their times
   (CUDA events).
4. Render: the PT main path through the CLI at 1920x1080, spp 4, eye depth
   4 on the card, in the fused tier (one ``shade_step`` kernel per bounce)
   and the split tier (the nearest-hit and any-blocker kernels around a
   PyTorch bounce).  Launches are counted over the fused render alone,
   which is the main path, and separately over the split render; no plain
   version may run in either.  Then 128x72 spp 4 in the kernel tiers and
   the plain tier from the same key, compared pixel by pixel.

The line before the last is a JSON object with one entry per kernel, whose
``launches`` are the counts of the main path's (fused) run; the last line is ``{"ok": true, "device": {...}}``.  Renders are written under
``path_tracing_tpu_torch/build/chip_smoke/`` (gitignored).
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "cornell.txt"
OUT = ROOT / "path_tracing_tpu_torch" / "build" / "chip_smoke"
W, H, SPP = 1920, 1080, 4
B = W * H                      # 2,073,600 lanes
SMALL_W, SMALL_H = 128, 72
SOURCE = "path_tracing_tpu_torch/csrc/pt_kernels.cu"
REPLACES = {
    "nearest_hit": "path_tracing_tpu/ops/pallas_intersect.py:1685",
    "any_blocker": "path_tracing_tpu/ops/pallas_intersect.py:1753",
    "shade_step": "path_tracing_tpu/ops/pallas_shade.py:917",
}
# Kernels the main path launches.  The fused tier runs the nearest-hit and
# shadow sweeps as __device__ functions inside shade_step, so nearest_hit
# and any_blocker are launched on their own only in phase 3 and the split
# tier, and count 0 in the main path's run.
MAIN_PATH_KERNELS = ("shade_step",)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
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


def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip())
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return name


def phase_build():
    from path_tracing_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.library()
    print(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s")
    kernel, spills = None, (0, 0)
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in REPLACES if f"{k}_kernel" in line),
                          None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            print(f"[build] {kernel}: {m.group(1)} registers, spill stores "
                  f"{spills[0]} B, spill loads {spills[1]} B")
    return lib


def main_path_state(scene, cam, u):
    """Camera rays of the main path's first iteration, (B, 3)."""
    from path_tracing_tpu_torch.scene.camera import primary_ray_dirs

    idx = torch.arange(B, dtype=torch.int32, device="cuda")
    rd = primary_ray_dirs(cam, idx % W, idx // W, u[6], u[7])
    ro = cam.eye[None].expand(B, 3).contiguous()
    return ro, rd


def phase_kernels(scene, cam) -> list:
    from path_tracing_tpu_torch.integrators.pt import _light_table
    from path_tracing_tpu_torch.ops import cuda_intersect as ci
    from path_tracing_tpu_torch.ops import cuda_shade as cs
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.ops.intersect import INF, shadow_ray

    pk = ci.pack_scene(scene)
    lt = _light_table(scene)
    key = rng.fold_in(rng.prng_key(0), 0)
    u = rng.uniform_rows(rng.iter_key(key, 0), B, 8, device="cuda")
    ro, rd = main_path_state(scene, cam, u)
    results = []

    # ---- 1. nearest hit: random rays in the box, then the camera rays ----
    ur = rng.uniform_rows(rng.prng_key(1), 1 << 18, 6, device="cuda")
    rro = (ur[0:3].T * 1.8 - 0.9).contiguous()
    rrd = shadow_ray(torch.zeros_like(rro), (ur[3:6].T - 0.5).contiguous())[0]
    err = 0.0
    for o, d in ((rro, rrd), (ro, rd)):
        a = ci.nearest_hit(pk, o, d)
        b = ci.nearest_hit_plain(pk, o, d)
        torch.cuda.synchronize()
        check(torch.equal(a["flag"], b["flag"]), "nearest_hit: flags differ")
        same = torch.isclose(a["t"], b["t"], rtol=1e-5) | (
            (a["t"] >= INF) & (b["t"] >= INF))
        share = same.float().mean().item()
        check(share >= 0.9995, f"nearest_hit: t agrees on {share:.6f}")
        hit = a["flag"] > 0
        for f in ci.HIT_FIELDS:
            err = max(err, (a[f] - b[f])[hit].abs().max().item())
        print(f"[kernels] nearest_hit on {o.shape[0]} rays: flags equal, "
              f"t within rtol 1e-5 on {share:.6f}")
    ms = time_ms(lambda: ci.nearest_hit(pk, ro, rd), 10)
    plain_ms = time_ms(lambda: ci.nearest_hit_plain(pk, ro, rd), 3)
    results.append(dict(name="nearest_hit", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms))

    # ---- 2. any blocker: NEE-like shadow rays from the camera hits ----
    hit = ci.nearest_hit(pk, ro, rd)
    pos = ro + rd * hit["t"][:, None]
    nrm = torch.stack([hit["nx"], hit["ny"], hit["nz"]], -1)
    li = torch.clamp((u[0] * pk.nl).long(), max=pk.nl - 1)
    p1 = pos + nrm * 1e-4
    p2 = lt[li, 0:3] + (u[1:4].T - 0.5) * 0.1
    srd, _, md = shadow_ray(p1, p2)
    pr1 = (ur[0:3].T * 1.9 - 0.95).contiguous()
    pr2 = (ur[3:6].T * 1.9 - 0.95).contiguous()
    rsrd, _, rmd = shadow_ray(pr1, pr2)
    err = 0.0
    for rule in (True, False):
        for a1, d1, m1 in ((pr1, rsrd, rmd), (p1, srd, md)):
            a = ci.any_blocker(pk, a1, d1, m1, rule)
            b = ci.any_blocker_plain(pk, a1, d1, m1, rule)
            torch.cuda.synchronize()
            check(torch.equal(a, b),
                  f"any_blocker: verdicts differ (dielectrics_block={rule})")
            err = max(err, (a.float() - b.float()).abs().max().item())
        print(f"[kernels] any_blocker dielectrics_block={rule}: verdicts "
              f"equal on {pr1.shape[0]} random and {B} NEE rays")
    ms = time_ms(lambda: ci.any_blocker(pk, p1, srd, md, True), 10)
    plain_ms = time_ms(lambda: ci.any_blocker_plain(pk, p1, srd, md, True), 3)
    results.append(dict(name="any_blocker", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms))

    # ---- 3. shade step on the state after two plain bounces ----
    kw = dict(clamp_val=15.0, stub_mis=True, dielectrics_block=True)
    st = [ro, rd, torch.ones(B, 3, device="cuda"),
          torch.ones(B, device="cuda"),
          torch.zeros(B, dtype=torch.int32, device="cuda"),
          torch.ones(B, dtype=torch.bool, device="cuda"),
          torch.ones(B, dtype=torch.bool, device="cuda"),
          torch.ones(B, device="cuda")]
    names = ("ro", "rd", "tp", "eta", "depth", "alive", "last_is_delta",
             "last_pdf")
    for it in (1, 2):
        out = cs.shade_step_plain(pk, lt, *st, u, **kw)
        st = [out[k] for k in names]
        u = rng.uniform_rows(rng.iter_key(key, it), B, 8, device="cuda")
    st[5] = st[5] | (torch.arange(B, device="cuda") % 3 == 0)
    a = cs.shade_step(pk, lt, *st, u, **kw)
    b = cs.shade_step_plain(pk, lt, *st, u, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        ok = torch.isclose(x, y, rtol=1e-4, atol=1e-5)
        if ok.dim() > 1:
            ok = ok.all(dim=1)
        share = ok.float().mean().item()
        check(share >= 0.999, f"shade_step: {k} agrees on {share:.6f}")
        err = max(err, (x - y).abs().max().item())
    print(f"[kernels] shade_step on {B} lanes ({st[5].float().mean().item():.3f}"
          f" active): every output within rtol 1e-4 / atol 1e-5 on >= 99.9%")
    ms = time_ms(lambda: cs.shade_step(pk, lt, *st, u, **kw), 10)
    plain_ms = time_ms(lambda: cs.shade_step_plain(pk, lt, *st, u, **kw), 3)
    results.append(dict(name="shade_step", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms))
    for r in results:
        check(math.isfinite(r["max_abs_err"]),
              f"{r['name']}: max abs err {r['max_abs_err']}")
        print(f"[kernels] {r['name']}: {r['ms']:.3f} ms kernel, "
              f"{r['plain_ms']:.3f} ms plain at {B} lanes, max abs err "
              f"{r['max_abs_err']:.3g}")
    return results


def run_cli(w, h, tier, name):
    from path_tracing_tpu_torch import cli

    out = OUT / f"{name}.png"
    res = cli.run(["--input", str(SCENE), "--mode", "pt", "--spp", str(SPP),
                   "--width", str(w), "--height", str(h), "--eye-depth", "4",
                   "--device", "cuda", "--tier", tier, "--output", str(out)])
    img = res["image"]
    check(img.shape == (w * h, 3), f"{name}: image shape {img.shape}")
    check(bool((img == img).all()) and bool(abs(img).max() < float("inf")),
          f"{name}: image is not finite")
    check(img.mean() > 0.0, f"{name}: image mean {img.mean()}")
    mpaths = w * h * SPP / res["seconds"] / 1e6
    print(f"[render] {name}: {w}x{h} spp {SPP} {tier} tier "
          f"{res['seconds']:.3f} s, {mpaths:.3f} Mpaths/s, mean "
          f"{img.mean():.6f}")
    return res, mpaths


def compare(a, b, what: str) -> None:
    import numpy as np

    rel = abs(a.mean() - b.mean()) / max(abs(a.mean()), 1e-6)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=1).mean()
    print(f"[render] {what}: mean rel diff {rel:.3g}, pixels within "
          f"rtol 1e-4 / atol 1e-5: {close:.6f}")
    check(rel < 1e-3, f"{what}: mean differs by {rel}")
    check(close >= 0.99, f"{what}: only {close} of pixels agree")


def phase_render() -> dict:
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.integrators.pt import render_pt
    from path_tracing_tpu_torch.ops import _kernels, rng
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    OUT.mkdir(parents=True, exist_ok=True)
    run_cli(SMALL_W, SMALL_H, "fused", "warmup")

    # ---- the main path (fused tier), counted on its own ----
    _kernels.reset_counts()
    fused, _ = run_cli(W, H, "fused", "pt_1080p_fused")
    launches = dict(_kernels.launches)
    plain = dict(_kernels.plain_calls)
    print(f"[render] main-path launches {launches}, plain calls {plain}")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    for k in MAIN_PATH_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the main path")

    # ---- the split tier: kernels #1 and #2 launched on their own ----
    _kernels.reset_counts()
    split, _ = run_cli(W, H, "split", "pt_1080p_split")
    split_launches = dict(_kernels.launches)
    plain = dict(_kernels.plain_calls)
    print(f"[render] split-tier launches {split_launches}, plain calls "
          f"{plain}")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    for k in ("nearest_hit", "any_blocker"):
        check(split_launches[k] > 0,
              f"kernel {k} was not launched by the split tier")
    rel = abs(fused["image"].mean() - split["image"].mean()) / \
        fused["image"].mean()
    print(f"[render] 1080p fused vs split: mean rel diff {rel:.3g}")
    check(rel < 1e-3, "1080p fused and split tiers disagree")

    # ---- 128x72: kernel tiers against the plain tier, same key ----
    p = load_scene(str(SCENE))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, SMALL_W, SMALL_H,
                      device="cuda")
    cfg = RenderConfig(width=SMALL_W, height=SMALL_H, spp=SPP, eye_depth=4)
    key = rng.fold_in(rng.prng_key(0), 0)
    imgs = {t: render_pt(scene, cam, SMALL_W, SMALL_H, SPP, cfg, key,
                         tier=t).cpu().numpy()
            for t in ("fused", "split", "plain")}
    compare(imgs["plain"], imgs["fused"], "128x72 fused vs plain")
    compare(imgs["plain"], imgs["split"], "128x72 split vs plain")
    return launches


def main() -> int:
    name = phase_card()
    phase_build()

    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(SCENE))
    scene = p.to_device("cuda")
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device="cuda")
    results = phase_kernels(scene, cam)
    launches = phase_render()
    for r in results:
        r.update(route="cuda", source=SOURCE, replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
