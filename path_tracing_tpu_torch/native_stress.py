"""Load the native scene runtime over and over in fresh processes, the way a
render's first scene load does, and report any process that dies:

    python -m path_tracing_tpu_torch.native_stress [--rounds R] [--procs P]
        [--device cuda|cpu]

It writes the 81,920- and 327,680-triangle textured icosphere OBJs (with
their MTL and PNG) once, then starts ``R`` rounds of ``P`` processes side by
side.  Each process, with ``faulthandler`` on and unbuffered output:
renders ``scenes/cornell.txt`` at 64x48 through the CLI on ``--device``
(with the Python parser and the numpy builder, so that the card and its
kernel libraries are in use before the runtime loads); builds
``csrc/pt_runtime.cc`` into a directory of its own, so that every process
compiles and loads a fresh library; then three times over, loads each OBJ
through ``load_any_scene`` (the native parse and the texture decode),
holds its triangle tables equal to the Python parser's (at the native
parser's float32) and moves it to the device (``build_clusters``,
native).  The last line is one JSON object
with the processes started, those that exited 0, and each failure's exit
code and the end of its error output.  Exits 1 if any process failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = Path(__file__).resolve().parent / "build" / "native_stress"
SIZES = (81920, 327680)


def worker(device: str, build_dir: str, objs: list) -> None:
    """One process: a CLI render on ``device``, a fresh build of the
    runtime in ``build_dir``, then each OBJ loaded three times."""
    import numpy as np

    from path_tracing_tpu_torch import cli
    from path_tracing_tpu_torch.runtime import native
    from path_tracing_tpu_torch.scene.obj_loader import load_any_scene, \
        load_obj

    native._tried = True      # no runtime yet: the Python parser, numpy
    cli.run(["--input", str(ROOT / "scenes" / "cornell.txt"), "--mode", "pt",
             "--spp", "1", "--width", "64", "--height", "48", "--device",
             device, "--output", os.path.join(build_dir, "cornell.png")])
    native._tried, native.BUILD_DIR = False, Path(build_dir)
    assert native.native_available(), native.build_info
    print(f"built {native.build_info}", flush=True)
    for obj in objs:
        ref = load_obj(obj)
        for i in range(3):
            p = load_any_scene(obj)
            for f in ("tri_verts", "tri_mtl", "tri_uv", "tri_tex"):
                a, b = np.asarray(getattr(p, f)), np.asarray(getattr(ref, f))
                np.testing.assert_array_equal(a, b.astype(a.dtype))
            scene = p.to_device(device)
            print(f"{Path(obj).name} load {i}: {scene.num_triangles} "
                  "triangles on the device", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from path_tracing_tpu_torch.scene import synth

    OUT.mkdir(parents=True, exist_ok=True)
    objs = [synth.write_obj(synth.icosphere_scene(n, textured=True),
                            str(OUT / f"icosphere_{n}.obj")) for n in SIZES]
    started, ok, failed = 0, 0, []
    t0 = time.perf_counter()
    for r in range(args.rounds):
        procs = []
        for _ in range(args.procs):
            d = tempfile.mkdtemp(prefix="native_", dir=OUT)
            code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                    "from path_tracing_tpu_torch.native_stress import worker; "
                    f"worker({args.device!r}, {d!r}, {objs!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler", "-u", "-c", code],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for p in procs:
            out, err = p.communicate(timeout=900)
            started += 1
            if p.returncode == 0:
                ok += 1
            else:
                failed.append(dict(round=r, rc=p.returncode,
                                   stdout=out[-2000:], stderr=err[-4000:]))
                print(f"round {r}: exit {p.returncode}\n{out[-2000:]}\n"
                      f"{err[-4000:]}", flush=True)
        print(f"round {r}: {ok} of {started} processes exited 0 "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(dict(started=started, ok=ok, failed=failed)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
