"""The frozen work model: peaks, operations per unit of counted work and
the bound of a kernel (frozen from ``chip_smoke.py``'s ``OPS``, ``bound``,
``sweep_ops``, ``eye_ops``, ``walk_ops``, ``mega_ops`` and ``photon_ops``
when the benchmark was defined).  The counts come from the reference's own
plain versions on its own numpy cluster layout (``reference/``), so a
roofline share reads the same work whatever layout or kernel the program
uses: a program with a better layout than the frozen one reads higher."""
from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM part, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per unit of work: one ray's test of a sphere or light ball, of a box and
# of a triangle; one BSDF sample, evaluation and pdf; one Threefry draw
# (integer operations, counted at the float32 rate); one hitpoint-event
# distance test; the geometry of one BDPT connection row
OPS = dict(sphere=20, box=24, tri=50, sample=150, eval=110, pdf=60, draw=120,
           pair=8, connect=40)


def bound_s(nbytes: float, ops: float) -> float:
    """A kernel's least time on the card in seconds: the larger of its
    bytes over the memory bandwidth and its operations over the float32
    rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def sweep_ops(c: dict) -> int:
    """A connection sweep's counted work: every row's geometry, the BSDF
    evaluations and pdfs that ran, and every shadow walk's tests."""
    return (c["rows"] * OPS["connect"] + c["evals"] * OPS["eval"]
            + c["pdfs"] * OPS["pdf"] + c["shadow_spheres"] * OPS["sphere"]
            + c["shadow_boxes"] * OPS["box"] + c["shadow_tris"] * OPS["tri"])


def eye_ops(c: dict) -> int:
    """#9 ``bdpt_eye``: its sweeps, its nearest-hit casts, a BSDF sample and
    three draws a vertex, two jitter draws a sample."""
    return (sweep_ops(c) + c["hit_spheres"] * OPS["sphere"]
            + c["hit_boxes"] * OPS["box"] + c["hit_tris"] * OPS["tri"]
            + c["vertices"] * (OPS["sample"] + 3 * OPS["draw"])
            + c["samples"] * 2 * OPS["draw"])


def walk_ops(c: dict) -> int:
    """The counted nearest-hit and shadow walks' tests."""
    return ((c["hit_spheres"] + c["shadow_spheres"]) * OPS["sphere"]
            + (c["hit_boxes"] + c["shadow_boxes"]) * OPS["box"]
            + (c["hit_tris"] + c["shadow_tris"]) * OPS["tri"])


def mega_ops(c: dict) -> int:
    """#5 ``render_wavefront``: its walks, BSDF samples, NEE evaluations and
    pdfs and Threefry draws, the fold_in of an iteration once per iteration
    of the frame (its key is every pixel's)."""
    draws = c["draws"] - c["iterations"] + c["iteration_keys"]
    return (walk_ops(c) + c["bsdf_samples"] * OPS["sample"]
            + c["evals"] * OPS["eval"] + c["pdfs"] * OPS["pdf"]
            + draws * OPS["draw"])


def gather_ops(c: dict) -> int:
    """#11 ``gather_flux``: a distance test a candidate pair, an evaluation
    an accepted one."""
    return c["pairs"] * OPS["pair"] + c["accepted"] * OPS["eval"]
