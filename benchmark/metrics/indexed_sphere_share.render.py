"""The share of the scene's spheres and light balls that rays reach through
the sphere index, in %: ``scene.spheres_indexed`` over it plus
``scene.spheres_scanned`` (the spheres and light balls each ray tests in
turn), the counters the program keeps where it packs a frame's scene
tables while a profiler runs (``path_tracing_tpu_torch.profiling``, read
in this process; both sum over the same packed frames).  A property of the
packed scene, not of the walk: it says that the index is on, and which
share of the spheres it holds (the light balls stay in the linear loop),
not how many spheres a walk tests; the counting builds measure that
(``chip_smoke.py``'s sphereflake phase).  None where the program keeps no
such counters or packed no scene with a sphere index (every ray then
tests every sphere)."""
import sys


def read(ctx):
    prof = sys.modules.get("path_tracing_tpu_torch.profiling")
    counters = getattr(prof, "counters", None) or {}
    indexed = counters.get("scene.spheres_indexed", 0)
    if not indexed:
        return None
    return 100.0 * indexed / (indexed
                              + counters.get("scene.spheres_scanned", 0))
