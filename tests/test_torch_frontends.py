"""The port's front-ends against the JAX package's: checkpoints (each
package loads the other's file), the terminal preview and the comparator's
RMS (equal), the live HTTP view, the render supervisor
(``tests/test_resilience.py``'s cases), the CLI's options on the CPU
(``tests/test_film_cli.py``'s and ``tests/test_signals.py``'s cases:
checkpoint resume bit-equal to an uninterrupted render, ``--live``,
``--live-term``, ``--live-http``, ``--profile``, ``--debug-nan``,
``--retries`` without double counting, SIGUSR1/SIGUSR2, ``--device
oracle``) and a ``compare.py`` run.  Bars: equality throughout (the same
arithmetic on the same bytes); the CLI's images bit for bit, since every
frame is a function of (seed, iteration) alone.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracing_tpu import compare as jcompare
from path_tracing_tpu import film as jfilm
from path_tracing_tpu_torch import cli, compare, film
from path_tracing_tpu_torch.profiling import TRACE_FILE, Telemetry
from path_tracing_tpu_torch.runtime import live_http as lh
from path_tracing_tpu_torch.runtime.resilience import (RenderSupervisor,
                                                       StopRender,
                                                       probe_device)

from test_torch_scene import CORNELL, REPO

W, H = 16, 12


def _argv(tmp_path, *extra, out="out.png"):
    return ["--input", str(CORNELL), "--mode", "pt", "--spp", "1",
            "--width", str(W), "--height", str(H), "--eye-depth", "2",
            "--device", "cpu", "--seed", "1",
            "--output", str(tmp_path / out), *extra]


# ---- film: checkpoints and the terminal preview ----

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(writer, tmp_path):
    rs = np.random.default_rng(3)
    rad = rs.uniform(0, 4, (W * H, 3)).astype(np.float32)
    meta = {"mode": "bdpt", "width": W, "height": H}
    p = str(tmp_path / "ck.npz")
    if writer == "jax":
        jfilm.save_checkpoint(p, jfilm.AccumState(
            radiance_sum=jnp.asarray(rad), n_iters=jnp.int32(5)), meta)
        st, got = film.load_checkpoint(p)
        assert st.n_iters == 5 and st.radiance_sum.dtype == torch.float32
        np.testing.assert_array_equal(st.radiance_sum.numpy(), rad)
    else:
        film.save_checkpoint(p, film.AccumState(torch.from_numpy(rad), 5),
                             meta)
        st, got = jfilm.load_checkpoint(p)
        assert int(st.n_iters) == 5
        np.testing.assert_array_equal(np.asarray(st.radiance_sum), rad)
    assert {k: str(v) for k, v in got.items()} == \
        {k: str(v) for k, v in meta.items()}
    z = np.load(p)
    assert sorted(z.files) == ["meta_height", "meta_mode", "meta_width",
                               "n_iters", "radiance_sum"]


@pytest.mark.parametrize("shape,cols", [((64, 64), 16), ((12, 16), 80),
                                        ((37, 91), 23), ((5, 3), 2)])
def test_ansi_preview_equals_jax(shape, cols):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    assert film.ansi_preview(img, max_cols=cols) == \
        jfilm.ansi_preview(img, max_cols=cols)


def test_rms_8bit_equals_jax():
    rs = np.random.default_rng(0)
    a, b = (rs.integers(0, 256, (24, 40, 3), dtype=np.uint8)
            for _ in range(2))
    assert compare.rms_8bit(a, b) == jcompare.rms_8bit(a, b)
    assert compare.rms_8bit(a, a) == 0.0


# ---- runtime: the live view, the probe, the supervisor ----

def test_live_server_serves_page_and_frame():
    srv = lh.LiveServer(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"frame.png" in page
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/frame.png", timeout=10)
        png = film.encode_png(np.zeros((4, 4, 3), np.uint8))
        srv.update(png, 3, stats={"rms": float("nan")})
        got = urllib.request.urlopen(base + "/frame.png", timeout=10).read()
        assert got == png and got[:8] == b"\x89PNG\r\n\x1a\n"
        meta = json.loads(urllib.request.urlopen(base + "/meta.json",
                                                 timeout=10).read())
        assert meta == {"iter": 3, "history": [{"iter": 3, "rms": None}]}
    finally:
        srv.close()


def test_probe_device(monkeypatch):
    assert probe_device(timeout_s=60.0, device="cpu")
    # a device that does not answer in time reports unhealthy, no hang

    def hung(*a, **kw):
        time.sleep(2.0)
        return real(*a, **kw)

    real = torch.full
    monkeypatch.setattr(torch, "full", hung)
    t0 = time.perf_counter()
    assert probe_device(timeout_s=0.1, device="cpu") is False
    assert time.perf_counter() - t0 < 1.5


def test_supervisor_retries_transient_fault():
    calls = {"n": 0}
    acc, ckpts = [], []

    def frame(i):
        calls["n"] += 1
        if i == 1 and calls["n"] == 2:
            raise RuntimeError("transient fault")
        return torch.tensor(float(i))

    sup = RenderSupervisor(max_retries=1, backoff_s=0.0,
                           checkpoint=lambda: ckpts.append(len(acc)),
                           log=lambda m: None)
    sup.run(frame, 0, 3, lambda i, v: acc.append((i, float(v))))
    assert acc == [(0, 0.0), (1, 1.0), (2, 2.0)]
    assert sup.failures == 1 and ckpts == [1]


def test_supervisor_exhausts_retries_and_raises():
    ckpts = []
    sup = RenderSupervisor(max_retries=2, backoff_s=0.0,
                           checkpoint=lambda: ckpts.append(1),
                           log=lambda m: None)
    with pytest.raises(RuntimeError, match="hard fault"):
        sup.run(lambda i: (_ for _ in ()).throw(RuntimeError("hard fault")),
                0, 1, lambda i, v: None)
    assert sup.failures == 3 and ckpts == [1, 1, 1]


def test_supervisor_zero_retries_fails_fast():
    sup = RenderSupervisor(max_retries=0, backoff_s=0.0, log=lambda m: None)
    with pytest.raises(ValueError):
        sup.run(lambda i: (_ for _ in ()).throw(ValueError("x")),
                0, 1, lambda i, v: None)
    assert sup.failures == 1


def test_supervisor_retries_on_frame_and_passes_stop_through():
    state = {"fail": True, "acc": 0.0}

    def on_frame(i, v):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("transfer error")
        state["acc"] += float(v)

    sup = RenderSupervisor(max_retries=1, backoff_s=0.0, log=lambda m: None)
    sup.run(lambda i: torch.tensor(2.0), 0, 1, on_frame)
    assert state["acc"] == 2.0 and sup.failures == 1

    def stop(i, v):
        raise StopRender

    with pytest.raises(StopRender):
        sup.run(lambda i: torch.tensor(1.0), 0, 3, stop)
    assert sup.failures == 1


def test_telemetry_rows(tmp_path):
    tel = Telemetry(str(tmp_path / "t.jsonl"), device="cpu")
    with tel.phase("pt", paths=1000, iter=0):
        time.sleep(0.001)
    tel.emit(iter=0, rms_pt=1.5)
    rows = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert rows[0]["phase"] == "pt" and rows[0]["iter"] == 0
    assert "ms" in rows[0] and "mpaths_per_s" in rows[0]
    assert rows[1]["rms_pt"] == 1.5 and len(tel.rows) == 2


# ---- the CLI on the CPU ----

def test_cli_checkpoint_resume_equals_uninterrupted(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    full = cli.run(_argv(tmp_path, "--iters", "3", out="full.png"))
    first = cli.run(_argv(tmp_path, "--iters", "2", "--checkpoint", ck,
                          out="a.png"))
    assert first["iters"] == 2
    st, meta = film.load_checkpoint(ck)
    assert st.n_iters == 2 and str(meta["mode"]) == "pt"
    resumed = cli.run(_argv(tmp_path, "--iters", "1", "--checkpoint", ck,
                            out="b.png"))
    assert "[Resume]" in capsys.readouterr().out
    assert resumed["iters"] == 1
    np.testing.assert_array_equal(resumed["image"], full["image"])
    assert film.load_checkpoint(ck)[0].n_iters == 3
    assert film.read_png(str(tmp_path / "b.png")).tolist() == \
        film.read_png(str(tmp_path / "full.png")).tolist()
    # a checkpoint of another size or mode is refused
    rc = cli.main(_argv(tmp_path, "--width", "8", "--checkpoint", ck))
    assert rc == 1 and "checkpoint" in capsys.readouterr().err
    rc = cli.main(_argv(tmp_path, "--mode", "bdpt", "--checkpoint", ck))
    assert rc == 1


def test_cli_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its CLI's meta) resumes here."""
    ck = str(tmp_path / "ck.npz")
    one = cli.run(_argv(tmp_path, "--iters", "1", out="one.png"))
    rad = one["image"].astype(np.float32)
    jfilm.save_checkpoint(ck, jfilm.AccumState(
        radiance_sum=jnp.asarray(rad), n_iters=jnp.int32(1)),
        {"mode": "pt", "width": W, "height": H})
    two = cli.run(_argv(tmp_path, "--iters", "1", "--checkpoint", ck))
    full = cli.run(_argv(tmp_path, "--iters", "2", out="full.png"))
    np.testing.assert_array_equal(two["image"], full["image"])


def test_cli_live_file_and_term(tmp_path, capsys):
    live = str(tmp_path / "live_{i}.png")
    cli.run(_argv(tmp_path, "--iters", "2", "--live", live,
                  "--live-term", "8"))
    for i in (1, 2):
        assert film.read_png(str(tmp_path / f"live_{i}.png")).shape == \
            (H, W, 3)
    out = capsys.readouterr().out
    assert "\x1b[38;2;" in out and "▀" in out
    # the second frame climbs past the previous 3-row preview, its status
    # line, this iteration's '[Render] iter' and '[Live] wrote' lines
    assert "\x1b[6A" in out
    with pytest.raises(SystemExit):
        cli.run(_argv(tmp_path, "--live-term", "1"))


def test_cli_live_http(tmp_path, monkeypatch):
    captured = {}
    orig = lh.LiveServer.update

    def spy(self, png, iteration, stats=None):
        captured.update(png=png, iter=iteration)
        if stats is not None:
            captured["stats"] = stats
        orig(self, png, iteration, stats)
        captured["served"] = urllib.request.urlopen(
            f"http://127.0.0.1:{self.port}/frame.png", timeout=10).read()

    monkeypatch.setattr(lh.LiveServer, "update", spy)
    cli.run(_argv(tmp_path, "--iters", "2", "--live-http", "0"))
    assert captured["iter"] == 2
    assert captured["served"] == captured["png"]
    assert captured["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert captured["stats"]["rms"] >= 0.0


def test_cli_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "trace"
    res = cli.run(_argv(tmp_path, "--profile", str(prof)))
    assert res["iters"] == 1
    trace = prof / TRACE_FILE
    assert trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())


def test_cli_debug_nan(tmp_path, monkeypatch):
    from path_tracing_tpu_torch.integrators import pt

    clean = cli.run(_argv(tmp_path, "--debug-nan", "--iters", "2"))
    assert np.isfinite(clean["image"]).all()
    real, calls = pt.render_pt, []

    def nan_on_second(*a, **kw):
        img = real(*a, **kw)
        calls.append(1)
        if len(calls) % 2 == 0:
            img[3, 1] = float("nan")
        return img

    monkeypatch.setattr(pt, "render_pt", nan_on_second)
    with pytest.raises(FloatingPointError, match="pt iteration 2"):
        cli.run(_argv(tmp_path, "--debug-nan", "--iters", "2",
                      "--retries", "0"))
    # without the flag the frame is accumulated as it is
    res = cli.run(_argv(tmp_path, "--iters", "2"))
    assert np.isnan(res["image"]).any()


def test_cli_retry_does_not_double_count(tmp_path, monkeypatch, capsys):
    """A retry after a failing --live write re-runs the iteration once:
    the accumulation is committed after the fallible outputs."""
    real_save = film.save_image
    fails = {"n": 0}

    def flaky_save(path, *a, **kw):
        if "live" in os.path.basename(path) and fails["n"] == 0:
            fails["n"] += 1
            raise OSError("transient live-write failure")
        return real_save(path, *a, **kw)

    monkeypatch.setattr(film, "save_image", flaky_save)
    ck = str(tmp_path / "ck.npz")
    res = cli.run(_argv(tmp_path, "--iters", "2", "--live",
                        str(tmp_path / "live.png"), "--retries", "1",
                        "--checkpoint", ck))
    assert fails["n"] == 1 and "[Recover] iter" in capsys.readouterr().err
    st, _ = film.load_checkpoint(ck)
    assert st.n_iters == 2 and res["iters"] == 2
    monkeypatch.setattr(film, "save_image", real_save)
    full = cli.run(_argv(tmp_path, "--iters", "2", out="full.png"))
    np.testing.assert_array_equal(res["image"], full["image"])


def test_cli_signal_install_failure_restores_handlers(tmp_path, monkeypatch):
    """Installing SIGUSR2 fails after SIGUSR1 went in: SIGUSR1's previous
    handler is back before the render, and the render goes on."""
    real = signal.signal
    installed = []

    def failing(sig, handler):
        if sig == signal.SIGUSR2 and handler not in (signal.SIG_DFL,
                                                     signal.SIG_IGN):
            raise ValueError("no SIGUSR2 here")
        installed.append(sig)
        return real(sig, handler)

    before = signal.getsignal(signal.SIGUSR1)
    monkeypatch.setattr(signal, "signal", failing)
    res = cli.run(_argv(tmp_path))
    assert res["iters"] == 1
    assert installed == [signal.SIGUSR1, signal.SIGUSR1]
    assert signal.getsignal(signal.SIGUSR1) is before


@pytest.mark.skipif(not hasattr(signal, "SIGUSR1"),
                    reason="platform without SIGUSR1")
def test_cli_sigusr1_snapshot_and_sigusr2_stop(tmp_path):
    out = str(tmp_path / "img.png")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "path_tracing_tpu_torch.cli",
         *_argv(tmp_path, "--iters", "500", out="img.png")],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, text=True)
    finished = None
    try:
        deadline = time.time() + 300
        snapped = False
        for line in p.stdout:
            if time.time() > deadline:
                pytest.fail("timed out waiting for render output")
            if "[Render] iter 2:" in line and not snapped:
                snapped = True
                p.send_signal(signal.SIGUSR1)
            elif "[Signal] SIGUSR1" in line:
                p.send_signal(signal.SIGUSR2)
            elif "[Render] Finished" in line:
                finished = line
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert rc == 0
    snaps = [f for f in os.listdir(tmp_path) if ".snap" in f]
    assert snaps, "SIGUSR1 produced no snapshot"
    assert film.read_png(str(tmp_path / snaps[0])).shape == (H, W, 3)
    assert film.read_png(out).shape == (H, W, 3)
    # the rate counts the iterations completed (the stop comes after the
    # snapshot's iteration at the earliest), not --iters
    done = int(finished.rsplit("(", 1)[1].split()[-2])
    assert 2 <= done < 500, finished


def test_cli_oracle_needs_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(_argv(tmp_path, "--device", "oracle"))
    assert rc == 1 and "--device oracle" in capsys.readouterr().err
    assert not (tmp_path / "out.png").exists()


# ---- the comparator ----

def test_compare_smoke_with_live_http(tmp_path, monkeypatch):
    captured = {}
    orig = lh.LiveServer.update

    def spy(self, png, iteration, stats=None):
        captured.update(png=png, iter=iteration, stats=stats)
        return orig(self, png, iteration, stats)

    monkeypatch.setattr(lh.LiveServer, "update", spy)
    out = tmp_path / "cmp"
    rc = compare.main(["--input", str(CORNELL), "--iters", "2", "--spp", "1",
                       "--spl", "2", "--ppm-photons", "256", "--width", "16",
                       "--height", "16", "--eye-depth", "2", "--device",
                       "cpu", "--out-dir", str(out), "--live-http", "0"])
    assert rc == 0
    assert film.read_png(str(out / "combined.png")).shape == (16, 48, 3)
    for n in ("ppm", "bdpt", "pt"):
        assert film.read_png(str(out / f"{n}.png")).shape == (16, 16, 3)
    csv = (out / "convergence.csv").read_text().splitlines()
    assert csv[0] == "iter,rms_ppm,rms_bdpt,rms_pt,diff_rms" and len(csv) == 3
    rows = [json.loads(x) for x in open(out / "telemetry.jsonl")]
    assert [r["phase"] for r in rows if "phase" in r] == \
        ["ppm", "bdpt", "pt"] * 2
    assert captured["iter"] == 2
    assert captured["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert set(captured["stats"]) == {"rms_ppm", "rms_bdpt", "rms_pt",
                                      "diff_rms"}


def test_compare_needs_a_card_on_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = compare.main(["--input", str(CORNELL), "--out-dir",
                       str(tmp_path / "c")])
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err
