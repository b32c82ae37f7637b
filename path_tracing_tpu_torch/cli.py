"""Headless CLI of the port (``path_tracing_tpu.cli``'s options):

    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode pt --spp 4 --width 1920 --height 1080 --device cuda \\
        --output out.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode bdpt --spp 4 --spl 8 --resample 32 --device cuda \\
        --output bdpt.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode bdpt --spp 4 --spl 8 --conn-samples 16 --output bdpt_m16.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --mode ppm --spl 262144 --iters 10 --width 512 --height 512 \\
        --output ppm.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --device oracle --spp 16 --width 256 --height 256 --output gt.png
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --iters 2 --checkpoint ck.npz     # again to resume from ck.npz
    python -m path_tracing_tpu_torch.cli --input scenes/cornell.txt \\
        --iters 64 --live-http 0 --profile trace_dir

``--input`` takes a text scene or a ``.obj`` (with its MTL and textures;
the camera and lights come from a companion ``<name>.lights.txt`` or a
default framing); meshes of any size render on the resident kernels.
Frame ``i`` renders from ``fold_in(PRNGKey(seed), i)``, as the JAX CLI
does, so both packages render the same image from the same seed, and a
resumed render equals an uninterrupted one.  ``--device cuda`` (and
``oracle``) needs a CUDA card and fails without one; nothing falls back
to the CPU.

While it renders: SIGUSR1 writes ``<output>.snap<N>.png`` (and the
checkpoint) after the current iteration; SIGUSR2 stops after it and saves
as at the end.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys
import time


class CliError(Exception):
    """A user-facing error: printed, exit code 1."""


def build_parser() -> argparse.ArgumentParser:
    from .integrators import ppm, pt

    tiers = tuple(dict.fromkeys(pt.TIERS + ppm.TIERS))
    ap = argparse.ArgumentParser(prog="path_tracing_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--spl", type=int, default=8,
                    help="BDPT: light samples (paths per light per light "
                         "sample); PPM: photons each light emits a pass")
    ap.add_argument("--mode", choices=["pt", "bdpt", "ppm"], default="pt")
    ap.add_argument("--device", choices=["cuda", "cpu", "oracle"],
                    default="cuda",
                    help="'oracle' renders the deterministic BDPT ground "
                         "truth on the card (the CPU oracle's flags: raw "
                         "flux, dielectrics do not block shadow rays; the "
                         "fused tier)")
    ap.add_argument("--output", default="output.png")
    ap.add_argument("--input", default="input.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=1,
                    help="progressive accumulation passes")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path; resumed if it exists, saved after the "
                         "render (the JAX package's format)")
    ap.add_argument("--eye-depth", type=int, default=4)
    ap.add_argument("--light-depth", type=int, default=4)
    ap.add_argument("--force-fov", type=float, default=None,
                    help="override the scene fov (default honours the file)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--ppm-alpha", type=float, default=0.0,
                    help="PPM: progressive radius shrink factor (0 = the "
                         "reference's fixed radius)")
    ap.add_argument("--resample", type=int, default=0, metavar="K",
                    help="BDPT: connect each eye vertex to K light vertices "
                         "drawn by RIS (unbiased; tile-local tables in the "
                         "mega tier, one global table per sample "
                         "otherwise); 0 = the exact all-pairs sweep")
    ap.add_argument("--conn-samples", type=int, default=0, metavar="M",
                    help="BDPT: connect each eye vertex to M stratified "
                         "light vertices, scaled by n_valid / M (bench.py's "
                         "--conn-samples; the fused tier); 0 = all of them")
    ap.add_argument("--fix-pt-mis", action="store_true",
                    help="enable the MIS light-hit term the reference stubbed")
    ap.add_argument("--debug-nan", action="store_true",
                    help="check every iteration's frame and the "
                         "accumulation; raise FloatingPointError at the "
                         "first non-finite value, naming the iteration")
    ap.add_argument("--live", default=None, metavar="PATH",
                    help="after every iteration write the accumulated image "
                         "to PATH (atomically replaced); a literal '{i}' in "
                         "PATH is replaced by the iteration number")
    ap.add_argument("--live-term", nargs="?", const=80, type=int,
                    default=None, metavar="COLS",
                    help="after every iteration redraw the accumulated image "
                         "in the terminal as 24-bit ANSI half-blocks, COLS "
                         "cells wide (default 80)")
    ap.add_argument("--live-http", nargs="?", const=8000, type=int,
                    default=None, metavar="PORT",
                    help="serve the accumulated frame at http://host:PORT/ "
                         "(a refreshing page, /frame.png, /meta.json with "
                         "the frame-to-frame RMS), updated after every "
                         "iteration; PORT 0 picks a free port (printed)")
    ap.add_argument("--retries", type=int, default=1,
                    help="per-iteration retry budget for device faults: on "
                         "an exception the accumulation is checkpointed (if "
                         "--checkpoint is set), the card synchronised and "
                         "the iteration re-run on the same device; 0 "
                         "disables")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the scene's "
                         "set-up and the render loop to DIR/trace.json "
                         "(Chrome trace format)")
    ap.add_argument("--tier", choices=tiers, default="auto",
                    help="PT: auto (default: mega, or fused for textured "
                         "scenes, at any triangle count), mega (one "
                         "render_wavefront kernel), fused (one bounce kernel "
                         "per iteration), split (nearest-hit/any-blocker "
                         "kernels around a PyTorch bounce), stream (the "
                         "streamed mesh kernels on sorted rays around a "
                         "PyTorch bounce, the JAX package's route above "
                         "131,072 triangles) or plain PyTorch.  BDPT: auto "
                         "(mega; fused for --device oracle), mega (one "
                         "bdpt_eye kernel), fused (nearest-hit and connect "
                         "kernels per bounce) or plain.  PPM: auto (mega: "
                         "the photon_trace and gather_flux kernels), hash "
                         "(photon_trace, then the reference's spatial-hash "
                         "gather in PyTorch) or plain")
    return ap


@contextlib.contextmanager
def _signal_flags():
    """SIGUSR1 / SIGUSR2 set ``flags["snap"]`` / ``flags["stop"]`` while
    the block runs, and the previous handlers come back afterwards.  Where
    they cannot be installed (not the main thread, a platform without
    them) the block runs without them, and a handler installed before the
    failure is restored at once."""
    flags = {"snap": False, "stop": False}
    old = {}
    try:
        for sig, name in (("SIGUSR1", "snap"), ("SIGUSR2", "stop")):
            old[getattr(signal, sig)] = signal.signal(
                getattr(signal, sig),
                lambda *_, n=name: flags.__setitem__(n, True))
    except (ValueError, OSError, AttributeError):
        for s, h in old.items():
            signal.signal(s, h)
        old = {}
    try:
        yield flags
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def run(argv=None) -> dict:
    """Parse ``argv``, render, write the image.  Returns the linear image
    (numpy (H*W, 3)), its size, spp, the iterations completed in this run,
    the render seconds, the device, the tier and the photons traced
    (PPM)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.live_term is not None and args.live_term < 2:
        parser.error("--live-term COLS must be >= 2")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available")
    device = torch.device("cpu" if args.device == "cpu" else "cuda")

    from .profiling import maybe_trace

    with maybe_trace(args.profile, cuda=device.type == "cuda"):
        out = _render(args, device)
    if args.profile:
        print(f"[Profile] trace in {args.profile}")
    return out


def _render(args, device) -> dict:
    """``run``'s render from the parsed arguments on ``device``."""
    import numpy as np
    import torch

    from . import film
    from .config import RenderConfig, oracle_config
    from .integrators import bdpt, ppm, pt
    from .ops import rng
    from .runtime.resilience import RenderSupervisor, StopRender
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
                       bdpt_resample_vertices=max(0, args.resample),
                       bdpt_connection_samples=max(0, args.conn_samples))
    mode, oracle = args.mode, args.device == "oracle"
    if oracle:
        cfg, mode = oracle_config(cfg), "bdpt"
    try:
        if mode == "pt":
            tier = pt.resolve_tier(scene, args.tier)
        elif mode == "bdpt":
            tier = bdpt.resolve_tier(
                scene, "fused" if oracle and args.tier == "auto"
                else args.tier, cfg)
        else:
            tier = ppm.resolve_tier(scene, args.tier)
    except ValueError as e:
        raise CliError(str(e)) from e
    cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up, parsed.fov,
                      W, H, device=device, force_fov=args.force_fov)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("====================================")
    print(f" Device : {args.device} ({name})")
    print(f" Mode   : {mode} ({tier} tier)")
    print(f" SPP    : {args.spp}")
    if mode == "bdpt":
        print(f" SPL    : {args.spl}  light depth {args.light_depth}  "
              f"resample {cfg.bdpt_resample_vertices}  connection samples "
              f"{cfg.bdpt_connection_samples}")
    if mode == "ppm":
        print(f" Photons: {scene.num_lights * args.spl} a pass ({args.spl} "
              f"per light)  light depth {args.light_depth}  alpha "
              f"{args.ppm_alpha}")
    print(f" Input  : {args.input}")
    print(f" Output : {args.output}")
    print(f" Res    : {W}x{H}  seed={args.seed}  iters={args.iters}")
    print("====================================")
    print(f"Ball: {scene.num_spheres}  Triangle: {scene.num_triangles}  "
          f"Light: {scene.num_lights}")

    meta = {"mode": mode, "width": W, "height": H}
    state = film.AccumState.zeros(W, H, device)
    if args.checkpoint and os.path.exists(args.checkpoint):
        state, ck = film.load_checkpoint(args.checkpoint, device)
        ck_mode = str(ck.get("mode", mode))
        if state.radiance_sum.shape[0] != W * H or ck_mode != mode:
            raise CliError(f"checkpoint {args.checkpoint} is for "
                           f"{ck.get('width')}x{ck.get('height')} "
                           f"mode={ck_mode}, not {W}x{H} mode={mode}")
        print(f"[Resume] {args.checkpoint}: {state.n_iters} iters "
              "accumulated")
    start_iter = state.n_iters

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def host_mean(st):
        return st.mean().cpu().numpy()

    key = rng.prng_key(args.seed)

    def frame(i):
        k = rng.fold_in(key, i)
        if mode == "pt":
            return pt.render_pt(scene, cam, W, H, args.spp, cfg, k, tier=tier)
        if mode == "bdpt":
            return bdpt.render_bdpt(scene, cam, W, H, args.spp, args.spl,
                                    cfg, k, oracle=oracle, tier=tier)
        img, _, overflow = ppm.render_ppm_with_stats(
            scene, cam, W, H, args.spl, cfg, k,
            ppm.ppm_radius_scale(i, cfg.ppm_alpha), tier)
        dropped = int(overflow)
        if dropped and tier == "hash":
            print(f"[Warn] PPM gather dropped {dropped} candidate events "
                  "(raise ppm_max_per_cell or use ppm_cell_samples)",
                  file=sys.stderr)
        elif dropped:
            print(f"[Warn] PPM gather dropped {dropped} hitpoints and "
                  "photon events (raise ppm_max_cells or "
                  "ppm_event_cap_frac)", file=sys.stderr)
        return img

    live_http = None
    prev_u8 = None      # the last tonemapped frame, for the live RMS series

    def on_frame(i, f):
        nonlocal state, prev_u8
        # accumulate into a local and commit at the end: the live outputs
        # below can raise, and a retry must not add the frame twice
        if args.debug_nan and not bool(torch.isfinite(f).all()):
            raise FloatingPointError(
                f"--debug-nan: {mode} iteration {i + 1} rendered a "
                "non-finite value")
        new_state = state.add(f)
        if args.debug_nan and not bool(
                torch.isfinite(new_state.radiance_sum).all()):
            raise FloatingPointError(
                f"--debug-nan: the {mode} accumulation is non-finite after "
                f"iteration {i + 1}")
        sync()
        print(f"[Render] iter {i + 1}: "
              f"{(time.perf_counter() - t0) * 1000:.1f} ms cumulative")
        if args.live or args.live_term is not None or live_http is not None:
            linear = host_mean(new_state)
            u8 = film.tonemap_u8(linear, W, H)
        if args.live:
            live = args.live.replace("{i}", str(i + 1))
            film.save_image(live + ".tmp", linear, W, H)
            os.replace(live + ".tmp", live)
            print(f"[Live] wrote {live}")
        if args.live_term is not None:
            pre = film.ansi_preview(u8, max_cols=args.live_term)
            # redraw in place: climb past the previous preview, its status
            # line, this iteration's '[Render] iter' line and '[Live] wrote'
            up = pre.count("\n") + 3 + (1 if args.live else 0)
            lead = f"\x1b[{up}A" if i > start_iter else ""
            print(f"{lead}{pre}\n[Live] iter {i + 1}", flush=True)
        if live_http is not None:
            rms = None
            if prev_u8 is not None:
                d = u8.astype(np.float32) - prev_u8.astype(np.float32)
                rms = float(np.sqrt(np.mean(d * d)))
            prev_u8 = u8
            live_http.update(film.encode_png(u8), i + 1,
                             stats=None if rms is None else {"rms": rms})
        state = new_state
        if flags["snap"]:
            flags["snap"] = False
            snap = f"{args.output}.snap{i + 1}.png"
            film.save_image(snap, host_mean(state), W, H)
            if args.checkpoint:
                film.save_checkpoint(args.checkpoint, state, meta)
            print(f"[Signal] SIGUSR1: snapshot -> {snap}", flush=True)
        if flags["stop"]:
            print(f"[Signal] SIGUSR2: stopping after iteration {i + 1}; "
                  "saving", flush=True)
            raise StopRender

    def salvage_checkpoint():
        if args.checkpoint:
            film.save_checkpoint(args.checkpoint, state, meta)

    print("[Render] Starting Render...")
    sync()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        flags = stack.enter_context(_signal_flags())
        if args.live_http is not None:
            from .runtime.live_http import LiveServer

            live_http = LiveServer(args.live_http)
            stack.callback(live_http.close)
            print(f"[Live] serving http://{live_http.host}:"
                  f"{live_http.port}/")
        try:
            RenderSupervisor(
                max_retries=max(args.retries, 0), backoff_s=2.0,
                checkpoint=salvage_checkpoint,
                log=lambda m: print(m, file=sys.stderr),
            ).run(frame, start_iter, args.iters, on_frame)
        except StopRender:
            pass            # SIGUSR2: save as at the end
        sync()
    seconds = time.perf_counter() - t0
    # completed iterations: a SIGUSR2 stop renders fewer than --iters
    done = state.n_iters - start_iter
    rate = 1e-6 * done / max(seconds, 1e-9)
    if mode == "ppm":
        print(f"[Render] Finished in {seconds * 1000:.1f} ms "
              f"({W * H * rate:.2f} Mpaths/s, "
              f"{scene.num_lights * args.spl * rate:.2f} Mphotons/s, "
              f"{seconds * 1000 / max(done, 1):.1f} ms per pass, "
              f"{done} iters)")
    else:
        print(f"[Render] Finished in {seconds * 1000:.1f} ms "
              f"({W * H * args.spp * rate:.2f} Mpaths/s, {done} iters)")

    if args.checkpoint:
        film.save_checkpoint(args.checkpoint, state, meta)
        print(f"[Checkpoint] saved {args.checkpoint}")
    linear = host_mean(state)
    print(f"[Save] Writing to {args.output}...")
    film.save_image(args.output, linear, W, H)
    print("[Success] Image saved!")
    photons = scene.num_lights * args.spl * done if mode == "ppm" else 0
    return dict(image=linear, width=W, height=H, spp=args.spp, iters=done,
                seconds=seconds, device=name, tier=tier, photons=photons)


def main(argv=None) -> int:
    try:
        run(argv)
    except CliError as e:
        print(f"[Error] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
