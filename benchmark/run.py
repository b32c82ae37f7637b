"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds or loads the port's kernels, writes the cell's scene file
if it is not cached, parses and packs it and renders one iteration.  The
window then runs the render loop for ``--seconds``, each iteration
ended by a synchronise and timed on the host clock.  After the window
the plain reference judges what the window produced (``check.py``) and
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics read from a profiled stretch of
the window), ``device`` and, with ``--trace 1``, ``breakdown``, and
last ``compared``: each compared number beside its limit, which the last
lines of standard error repeat.  Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

from . import check
from .cells import HERE, load_cell, metric_reader
from .scenes import scene_file

FORBIDDEN = ("jax", "jaxlib", "flax", "path_tracing_tpu")
TRACE_DIR = HERE / "cache" / "trace"


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), or since this
    module was imported elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control=None) -> dict:
    """One run of ``cell``: the result object the last line prints.
    ``control``: a dtype; the window's frames are then the reference's at
    that precision in the program's place (only the control calls it)."""
    import torch

    from .program import Program

    traffic = cell.traffic
    path = scene_file(cell.config_name, cell.config, cell.root)
    prog = Program(traffic, path, seed, device)
    start, n, step = check.subset(traffic, prog.num_prims, seed)
    sl = check.pixel_slice(start, n, step)
    render = prog.frame
    if control is not None:
        ctl = check.Reference(traffic, path, seed, device)
        render = _control_frames(ctl, prog, start, n, step, control)

    # warm-up: the first iteration's work, which every later one repeats;
    # a traced run starts the profiler once here, whose first start on the
    # card takes seconds
    with (_profiler(torch, prog.device) if trace
          else contextlib.nullcontext()):
        state = prog.zeros().add(render(0))
        prog.sync()
    del state
    setup_s = process_age()
    log(f"set-up {setup_s:.3f} s (scene {prog.scene_setup_s:.3f} s, "
        f"tier {prog.tier}, {n} pixels from {start} a {step} apart)")

    k = int(traffic["check_frames"])
    pick = random.Random(seed ^ 0xC0DE)
    kept: list = []
    state = prog.zeros()
    shadow = torch.zeros((n, 3), device=prog.device)
    iter_s: list = []
    prof, marks, traced = None, contextlib.ExitStack(), 0
    t_end = None
    t0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == 1:
            prof = _profiler(torch, prog.device)
            prof.__enter__()
            marks.enter_context(torch.profiler.record_function(
                "bench.window"))
            t_trace = time.perf_counter()
        ts = time.perf_counter()
        with _mark(prof, "bench.frame"):
            f = render(i)
        with _mark(prof, "bench.accumulate"):
            state = state.add(f)
            shadow += f[sl]
        with _mark(prof, "bench.sync"):
            prog.sync()
        te = time.perf_counter()
        iter_s.append(te - ts)
        # a reservoir: iteration i is kept with chance k / (i + 1), so
        # the kept frames are drawn evenly from all the window ran
        if len(kept) < k:
            kept.append((i, f[sl].clone()))
        elif (j := pick.randrange(i + 1)) < k:
            kept[j] = (i, f[sl].clone())
        del f
        i += 1
        if prof is not None and traced == 0 and (
                te - t_trace >= traffic["trace_seconds"]
                and i - 1 >= traffic["trace_min_iters"]):
            marks.close()
            prof.__exit__(None, None, None)
            traced = i - 1
        if te - t0 >= seconds and (traced or not trace):
            t_end = te
            break
    window_s = t_end - t0
    prog.sync()
    dev = prog.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    accum_block = state.radiance_sum[sl].clone()
    n_iters = state.n_iters
    stretch = None
    if prof is not None:
        stretch = _read_trace(prof, traced)
        device_info["busy_s"] = stretch.busy_s
        device_info["window_s"] = stretch.window_s
    scene_setup_s, kernel_names = prog.scene_setup_s, prog.kernel_names
    num_lights, num_prims, iters = prog.num_lights, prog.num_prims, i
    del state, prog, prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: loaded {found} (JAX or the JAX "
                         "package); refusing to report")

    q = sorted(iter_s)
    log(f"window {window_s:.3f} s, {iters} iterations; ms an iteration: "
        f"min {q[0] * 1e3:.2f}, median {q[len(q) // 2] * 1e3:.2f}, "
        f"max {q[-1] * 1e3:.2f}")
    t_ref = time.perf_counter()
    ref = check.Reference(traffic, path, seed, dev)
    kept.sort()
    gaps = [check.rel_l1(block, ref.frame(it, start, n, step))
            for it, block in kept]
    work = None
    if trace:
        # the main kernel's work in the first kept iteration, counted by
        # the reference on ``count_pixels`` pixels, for the rooflines
        c = ref.work_counts()
        cstart, cn, cstep = check.subset(traffic, num_prims, seed,
                                         "count_pixels")
        ref.frame(kept[0][0], cstart, cn, cstep, counts=c)
        work = dict(c, scale=traffic["width"] * traffic["height"] / cn)
    log(f"reference {time.perf_counter() - t_ref:.3f} s for "
        f"{len(kept)} frames")
    mism = check.accum_mismatch(accum_block, shadow)
    if n_iters != iters:
        mism += 1 + abs(n_iters - iters)
    lim = cell.limits
    compared = {
        "frame_rel_l1": [max(gaps), lim["frame_rel_l1"]],
        "accum_mismatch": [mism, lim["accum_mismatch"]],
    }
    failed = (sum(g > lim["frame_rel_l1"] for g in gaps)
              + int(mism > lim["accum_mismatch"]))
    correct = failed == 0 and bool(gaps)

    pixels = traffic["width"] * traffic["height"]
    ctx = SimpleNamespace(
        cell=cell, traffic=traffic, mode=traffic["mode"], pixels=pixels,
        paths_per_iter=pixels * traffic.get("spp", 1),
        photons_per_iter=num_lights * traffic.get("spl", 0),
        setup_s=setup_s, scene_setup_s=scene_setup_s, window_s=window_s,
        iter_s=iter_s, iters=iters, trace=stretch, work=work,
        kernel_names=kernel_names)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"], cell.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": iters, "failed": failed,
           "metrics": metrics, "device": device_info}
    if stretch is not None:
        out["breakdown"] = {"device_ops": stretch.top_ops(),
                            "idle_gaps": stretch.idle_gaps()}
    out["frames_compared"] = [it for it, _ in kept]
    out["pixels_compared"] = [start, n, step]
    # last: each compared number beside its limit
    out["compared"] = {k: {"value": v, "limit": l}
                       for k, (v, l) in compared.items()}
    return out


def _control_frames(ref, prog, start: int, n: int, step: int, dtype):
    """The control's frames: zeros but for the compared pixels, which the
    reference renders at ``dtype``."""
    import torch

    sl = check.pixel_slice(start, n, step)

    def render(i):
        f = torch.zeros((prog.W * prog.H, 3), device=prog.device)
        f[sl] = ref.frame(i, start, n, step, round_to=dtype)
        return f
    return render


def _profiler(torch, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _mark(prof, name: str):
    if prof is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def _read_trace(prof, iters: int):
    from . import trace

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "window.json"
    prof.export_chrome_trace(str(path))
    try:
        return trace.load(path, iters)
    finally:
        path.unlink(missing_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    out["device"]["power_limit"] = power_limit()
    # last, once the reference and every metric reader have run: nothing
    # after the window may have loaded JAX or the JAX package either
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found} (JAX or the JAX package); "
              "refusing to report", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
