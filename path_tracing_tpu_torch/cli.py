"""Headless CLI of the port (``path_tracing_tpu.cli``'s render modes):

    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode pt --spp 4 --width 1920 --height 1080 --device cuda \\
        --output out.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode bdpt --spp 4 --spl 8 --resample 32 --device cuda \\
        --output bdpt.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode ppm --spl 262144 --iters 10 --width 512 --height 512 \\
        --output ppm.png
    python -m path_tracing_tpu_torch.cli --mode pt --input mesh.obj \\
        --width 1920 --height 1080 --spp 4     # > 131,072 triangles: stream

``--input`` takes a text scene or a ``.obj`` (with its MTL and textures;
the camera and lights come from a companion ``<name>.lights.txt`` or a
default framing).  Frame ``i`` renders from ``fold_in(PRNGKey(seed), i)``,
as the JAX CLI does, so both packages render the same image from the same
seed.  ``--device cuda`` needs a CUDA card and fails without one; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

class CliError(Exception):
    """A user-facing error: printed, exit code 1."""


def build_parser() -> argparse.ArgumentParser:
    from .integrators.pt import TIERS

    ap = argparse.ArgumentParser(prog="path_tracing_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--spl", type=int, default=8,
                    help="BDPT: light samples (paths per light per light "
                         "sample); PPM: photons each light emits a pass")
    ap.add_argument("--mode", choices=["pt", "bdpt", "ppm"], default="pt")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--output", default="output.png")
    ap.add_argument("--input", default="input.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=1,
                    help="progressive accumulation passes")
    ap.add_argument("--eye-depth", type=int, default=4)
    ap.add_argument("--light-depth", type=int, default=4)
    ap.add_argument("--force-fov", type=float, default=None,
                    help="override the scene fov (default honours the file)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--fix-pt-mis", action="store_true",
                    help="enable the MIS light-hit term the reference stubbed")
    ap.add_argument("--ppm-alpha", type=float, default=0.0,
                    help="PPM: progressive radius shrink factor (0 = the "
                         "reference's fixed radius)")
    ap.add_argument("--resample", type=int, default=0, metavar="K",
                    help="BDPT: connect each eye vertex to K light vertices "
                         "drawn by RIS (unbiased; tile-local tables in the "
                         "mega tier, one global table per sample "
                         "otherwise); 0 = the exact all-pairs sweep")
    ap.add_argument("--tier", choices=TIERS, default="auto",
                    help="PT: auto (default: stream for meshes above "
                         "131,072 triangles, else mega, or fused for "
                         "textured scenes), mega (one render_wavefront "
                         "kernel), fused (one bounce kernel per iteration), "
                         "split (nearest-hit/any-blocker kernels around a "
                         "PyTorch bounce), stream (the streamed mesh "
                         "kernels on sorted rays around a PyTorch bounce) "
                         "or plain PyTorch.  BDPT: auto (mega), "
                         "mega (one bdpt_eye kernel), fused (nearest-hit "
                         "and connect kernels per bounce) or plain.  PPM: "
                         "auto (mega: the photon_trace and gather_flux "
                         "kernels) or plain")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, render, write the image.  Returns the linear image
    (numpy (H*W, 3)), its size, spp, passes, the render seconds and the
    photons traced (PPM)."""
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise CliError("--device cuda: no CUDA device is available")
    device = torch.device(args.device)

    from .config import RenderConfig
    from .film import AccumState, save_image
    from .integrators import bdpt, ppm, pt
    from .ops import rng
    from .scene.camera import make_camera
    from .scene.obj_loader import load_any_scene

    if not os.path.exists(args.input):
        raise CliError(f"Cannot open input file: {args.input}")
    parsed = load_any_scene(args.input)
    W = args.width or parsed.width
    H = args.height or parsed.height
    scene = parsed.to_device(device)
    cfg = RenderConfig(width=W, height=H, spp=args.spp, spl=args.spl,
                       eye_depth=args.eye_depth, light_depth=args.light_depth,
                       seed=args.seed,
                       pt_stub_mis_strategy_a=not args.fix_pt_mis,
                       ppm_alpha=args.ppm_alpha,
                       bdpt_resample_vertices=max(0, args.resample))
    try:
        if args.mode == "pt":
            tier = pt.resolve_tier(scene, args.tier)
        elif args.mode == "bdpt":
            tier = bdpt.resolve_tier(scene, args.tier, cfg)
        else:
            tier = ppm.resolve_tier(scene, args.tier)
    except (ValueError, NotImplementedError) as e:
        raise CliError(str(e)) from e
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H, device=device, force_fov=args.force_fov)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("====================================")
    print(f" Device : {args.device} ({name})")
    print(f" Mode   : {args.mode} ({tier} tier)")
    print(f" SPP    : {args.spp}")
    if args.mode == "bdpt":
        print(f" SPL    : {args.spl}  light depth {args.light_depth}  "
              f"resample {cfg.bdpt_resample_vertices}")
    if args.mode == "ppm":
        print(f" Photons: {scene.num_lights * args.spl} a pass ({args.spl} "
              f"per light)  light depth {args.light_depth}  alpha "
              f"{args.ppm_alpha}")
    print(f" Input  : {args.input}")
    print(f" Output : {args.output}")
    print(f" Res    : {W}x{H}  seed={args.seed}  iters={args.iters}")
    print("====================================")
    print(f"Ball: {scene.num_spheres}  Triangle: {scene.num_triangles}  "
          f"Light: {scene.num_lights}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    key = rng.prng_key(args.seed)
    state = AccumState.zeros(W, H, device)
    print("[Render] Starting Render...")
    sync()
    t0 = time.perf_counter()
    for i in range(args.iters):
        k = rng.fold_in(key, i)
        if args.mode == "pt":
            frame = pt.render_pt(scene, cam, W, H, args.spp, cfg, k,
                                 tier=tier)
        elif args.mode == "bdpt":
            frame = bdpt.render_bdpt(scene, cam, W, H, args.spp, args.spl,
                                     cfg, k, tier=tier)
        else:
            frame, _, overflow = ppm.render_ppm_with_stats(
                scene, cam, W, H, args.spl, cfg, k,
                ppm.ppm_radius_scale(i, cfg.ppm_alpha), tier)
            dropped = int(overflow)
            if dropped:
                print(f"[Warn] PPM gather dropped {dropped} hitpoints and "
                      "photon events (raise ppm_max_cells or "
                      "ppm_event_cap_frac)", file=sys.stderr)
        state = state.add(frame)
        sync()
        print(f"[Render] iter {i + 1}: "
              f"{(time.perf_counter() - t0) * 1000:.1f} ms cumulative")
    seconds = time.perf_counter() - t0
    rate = 1e-6 * args.iters / max(seconds, 1e-9)
    if args.mode == "ppm":
        print(f"[Render] Finished in {seconds * 1000:.1f} ms "
              f"({W * H * rate:.2f} Mpaths/s, "
              f"{scene.num_lights * args.spl * rate:.2f} Mphotons/s, "
              f"{seconds * 1000 / max(args.iters, 1):.1f} ms per pass, "
              f"{args.iters} iters)")
    else:
        print(f"[Render] Finished in {seconds * 1000:.1f} ms "
              f"({W * H * args.spp * rate:.2f} Mpaths/s, "
              f"{args.iters} iters)")

    linear = state.mean().cpu().numpy()
    print(f"[Save] Writing to {args.output}...")
    save_image(args.output, linear, W, H)
    print("[Success] Image saved!")
    photons = scene.num_lights * args.spl * args.iters if args.mode == "ppm" \
        else 0
    return dict(image=linear, width=W, height=H, spp=args.spp,
                iters=args.iters, seconds=seconds, device=name, tier=tier,
                photons=photons)


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"[Error] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
