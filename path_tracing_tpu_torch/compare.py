"""The three-integrator comparator (``path_tracing_tpu.compare``): PPM,
BDPT and PT side by side with convergence telemetry, on the card.

Each iteration renders PPM, BDPT and PT (the reference GUI's loop),
accumulates linear radiance and tracks four RMS histories: each
integrator's frame-to-frame 8-bit RMS and the PPM-against-BDPT cross RMS
``diff_rms``.  It writes the side-by-side ``3W x H`` PNG
``combined.png`` ([ppm | bdpt | pt]), one PNG per integrator,
``convergence.csv`` (and ``convergence.png`` where matplotlib is
installed) and ``telemetry.jsonl`` (one row per render, timed with the
card synchronised).  ``--live-http`` serves the accumulating 3-up frame
and the four series while it runs.

    python -m path_tracing_tpu_torch.compare --input scenes/cornell.txt \\
        --iters 8 --width 64 --height 64 --out-dir compare_out

Iteration ``it`` renders from ``k = fold_in(PRNGKey(seed), it)``: PPM
from ``fold_in(k, 1)``, BDPT from ``fold_in(k, 2)``, PT from
``fold_in(k, 3)``, as the JAX package's comparator does.  ``--device
cuda`` (the default) needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

NAMES = ("ppm", "bdpt", "pt")


def rms_8bit(a_u8: np.ndarray, b_u8: np.ndarray) -> float:
    """RMS difference of two 8-bit frames (the reference GUI's
    convergence measure)."""
    d = a_u8.astype(np.float32) - b_u8.astype(np.float32)
    return float(np.sqrt(np.mean(d * d)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="path_tracing_tpu_torch.compare")
    ap.add_argument("--input", default="input.txt")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--spl", type=int, default=4)
    ap.add_argument("--ppm-photons", type=int, default=10000,
                    help="photons each light emits a PPM pass")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--eye-depth", type=int, default=4)
    ap.add_argument("--light-depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out-dir", default="compare_out")
    ap.add_argument("--live-http", nargs="?", const=8000, type=int,
                    default=None, metavar="PORT",
                    help="serve the accumulating [ppm|bdpt|pt] 3-up frame "
                         "and the RMS series at http://host:PORT/ after "
                         "every iteration (PORT 0 picks a free port)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[Error] --device cuda: no CUDA device is available",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)

    from .config import RenderConfig
    from .film import encode_png, tonemap_u8, write_png
    from .integrators.bdpt import render_bdpt
    from .integrators.ppm import render_ppm_with_stats
    from .integrators.pt import render_pt
    from .ops import rng
    from .profiling import Telemetry
    from .scene.camera import make_camera
    from .scene.obj_loader import load_any_scene

    os.makedirs(args.out_dir, exist_ok=True)
    parsed = load_any_scene(args.input)
    W = args.width or parsed.width
    H = args.height or parsed.height
    scene = parsed.to_device(device)
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H, device=device)
    cfg = RenderConfig(width=W, height=H, eye_depth=args.eye_depth,
                       light_depth=args.light_depth, seed=args.seed)
    tel = Telemetry(os.path.join(args.out_dir, "telemetry.jsonl"),
                    device=device)
    key = rng.prng_key(args.seed)
    render = {
        "ppm": lambda k: render_ppm_with_stats(
            scene, cam, W, H, args.ppm_photons, cfg, rng.fold_in(k, 1))[0],
        "bdpt": lambda k: render_bdpt(scene, cam, W, H, args.spp, args.spl,
                                      cfg, rng.fold_in(k, 2)),
        "pt": lambda k: render_pt(scene, cam, W, H, args.spp, cfg,
                                  rng.fold_in(k, 3))}
    paths = {"ppm": args.ppm_photons, "bdpt": W * H * args.spp,
             "pt": W * H * args.spp}

    acc = {n: np.zeros((W * H, 3)) for n in NAMES}
    prev_u8 = dict.fromkeys(NAMES)
    hist: list[dict] = []
    live_http = None
    if args.live_http is not None:
        from .runtime.live_http import LiveServer

        live_http = LiveServer(args.live_http)
        print(f"[Live] serving http://{live_http.host}:{live_http.port}/")
    try:
        for it in range(args.iters):
            k = rng.fold_in(key, it)
            for n in NAMES:
                with tel.phase(n, paths=paths[n], iter=it):
                    img = render[n](k)
                acc[n] += img.cpu().numpy()
            row = {"iter": it}
            u8 = {}
            for n in NAMES:
                u8[n] = tonemap_u8(acc[n] / (it + 1), W, H)
                row[f"rms_{n}"] = (rms_8bit(u8[n], prev_u8[n])
                                   if prev_u8[n] is not None
                                   else float("nan"))
                prev_u8[n] = u8[n]
            row["diff_rms"] = rms_8bit(u8["ppm"], u8["bdpt"])
            hist.append(row)
            tel.emit(**row)
            print(f"iter {it}: " + "  ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
            if live_http is not None:
                live_http.update(
                    encode_png(np.concatenate([u8[n] for n in NAMES], 1)),
                    it + 1, stats={k: v for k, v in row.items()
                                   if k != "iter"})
    finally:
        if live_http is not None:
            live_http.close()

    write_png(os.path.join(args.out_dir, "combined.png"),
              np.concatenate([u8[n] for n in NAMES], axis=1))
    for n in NAMES:
        write_png(os.path.join(args.out_dir, f"{n}.png"), u8[n])
    cols = ["iter", "rms_ppm", "rms_bdpt", "rms_pt", "diff_rms"]
    csv_path = os.path.join(args.out_dir, "convergence.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(cols) + "\n")
        for row in hist:
            f.write(",".join(str(row[c]) for c in cols) + "\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        its = [r["iter"] for r in hist]
        for col in cols[1:]:
            ax.plot(its, [r[col] for r in hist], label=col)
        ax.set_xlabel("iteration")
        ax.set_ylabel("RMS (8-bit)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, "convergence.png"), dpi=110)
    except ImportError as e:        # matplotlib is optional
        print(f"[plot skipped: {e}]")
    print(f"[done] wrote {args.out_dir}/combined.png, {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
