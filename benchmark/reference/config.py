"""Typed render configuration (same fields, defaults and properties as
``path_tracing_tpu.config``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    # workload
    width: int = 200
    height: int = 200
    spp: int = 8
    spl: int = 8
    eye_depth: int = 4
    light_depth: int = 4
    # extra loop iterations for delta bounces, which do not consume depth:
    # max iterations = depth + delta_budget
    delta_budget: int = 8

    # integrator constants
    clamp: float = 15.0
    ppm_radius: float = 0.05
    ppm_hash_size: int = 1000003
    ppm_max_per_cell: int = 64
    ppm_cell_samples: int = 0
    ppm_max_cells: int = 16384
    ppm_event_cap_frac: float = 1.0
    bdpt_connection_samples: int = 0
    bdpt_resample_vertices: int = 0
    ppm_alpha: float = 0.0

    # determinism
    seed: int = 0

    # parity switches
    # True reproduces the reference PT's stubbed MIS "strategy A": a BSDF ray
    # hitting a light from a non-delta vertex contributes nothing.
    pt_stub_mis_strategy_a: bool = True
    # GPU shadow rays block on any occluder; the CPU oracle lets
    # dielectrics pass.
    shadow_dielectrics_block: bool = True
    # None honours the scene file's fov.
    force_fov: float | None = None

    @property
    def max_eye_iters(self) -> int:
        return self.eye_depth + self.delta_budget

    @property
    def max_light_iters(self) -> int:
        return self.light_depth + self.delta_budget


