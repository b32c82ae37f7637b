"""In-browser live progressive view (``path_tracing_tpu.runtime.live_http``,
a copy: it is standard library only).

:class:`LiveServer` is a zero-dependency ``http.server`` thread that
serves

- ``/``          — a dark page with the frame ``<img>`` refreshed ~1/s
                   plus a canvas sparkline of every streamed RMS series
                   (the reference GUI's gnuplot window)
- ``/frame.png`` — the latest tonemapped accumulation (encoded by the
                   render loop with ``film.encode_png``)
- ``/meta.json`` — ``{"iter": N, "history": [...]}`` — the iteration count
                   and the stats history (RMS rows from the render loop)

The render loop calls :meth:`LiveServer.update` with fresh PNG bytes (and
optionally a ``stats`` dict of convergence numbers) after every iteration;
requests never touch the render's tensors (bytes are swapped under a
lock), so a slow or absent viewer cannot stall the render.  The CLI's
``--live-http PORT`` and ``compare.py --live-http`` start one.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>path_tracing_tpu live</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; max-width:95vw; max-height:70vh;
      border:1px solid #333; margin-top:1em }
canvas { border:1px solid #333; margin-top:0.5em; background:#181818 }
#leg span { margin:0 0.6em }
</style></head><body>
<div id="s">waiting for first frame...</div>
<img id="f" src="/frame.png">
<div><canvas id="c" width="640" height="130"></canvas></div>
<div id="leg"></div>
<script>
const COLORS = ['#7ac7ff','#ffb870','#8ef08e','#ff8d8d','#caa0ff','#fff176'];
function num(v) { return typeof v === 'number' && isFinite(v); }
setInterval(async () => {
  const m = await (await fetch('/meta.json')).json();
  document.getElementById('s').textContent = 'iteration ' + m.iter;
  document.getElementById('f').src = '/frame.png?i=' + m.iter;
  const h = m.history || [];
  if (!h.length) return;
  const keys = Object.keys(h[h.length-1]).filter(k => k !== 'iter');
  const cv = document.getElementById('c'), ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  let vmax = 0;
  for (const k of keys) for (const r of h)
    if (num(r[k])) vmax = Math.max(vmax, r[k]);
  if (vmax <= 0) vmax = 1;
  keys.forEach((k, ki) => {
    ctx.strokeStyle = COLORS[ki % COLORS.length];
    ctx.lineWidth = 1.5;
    ctx.beginPath();
    let started = false;
    h.forEach((r, i) => {
      const v = r[k];
      if (!num(v)) return;
      const x = h.length > 1 ? i / (h.length - 1) * (cv.width - 8) + 4 : 4;
      const y = cv.height - 6 - (v / vmax) * (cv.height - 12);
      started ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      started = true;
    });
    ctx.stroke();
  });
  document.getElementById('leg').innerHTML = keys.map((k, ki) => {
    const v = h[h.length-1][k];
    const txt = num(v) ? (+v).toFixed(3) : '-';
    return '<span style="color:' + COLORS[ki % COLORS.length] + '">'
           + k + '=' + txt + '</span>';
  }).join('');
}, 1000);
</script></body></html>
"""


def _finite(v):
    """JSON-safe: browsers reject bare NaN/Infinity tokens."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class LiveServer:
    """Background HTTP server publishing the latest rendered frame and the
    convergence history."""

    # bound the in-memory history (and the meta.json payload) — at 1 row
    # per iteration this is hours of render
    MAX_HISTORY = 2048

    def __init__(self, port: int, host: str | None = None):
        if host is None:
            # default loopback: the frames are unauthenticated, so binding
            # all interfaces must be an explicit opt-in (for viewing from
            # another machine set PT_TPU_HTTP_HOST=0.0.0.0 or ssh -L)
            import os

            host = os.environ.get("PT_TPU_HTTP_HOST", "127.0.0.1")
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._iter = 0
        self._history: list[dict] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/frame.png":
                    with outer._lock:
                        body = outer._png
                    if not body:
                        self.send_error(404, "no frame yet")
                        return
                    ctype = "image/png"
                elif path == "/meta.json":
                    with outer._lock:
                        body = json.dumps(
                            {"iter": outer._iter,
                             "history": outer._history}).encode()
                    ctype = "application/json"
                elif path == "/":
                    body, ctype = _PAGE, "text/html"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def update(self, png_bytes: bytes, iteration: int,
               stats: dict | None = None) -> None:
        """Publish a new frame; ``stats`` (e.g. the per-integrator RMS row)
        appends to the history the page plots as sparklines."""
        with self._lock:
            self._png = png_bytes
            self._iter = iteration
            if stats:
                self._history.append(
                    {"iter": iteration,
                     **{k: _finite(v) for k, v in stats.items()}})
                if len(self._history) > self.MAX_HISTORY:
                    del self._history[:-self.MAX_HISTORY]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
