"""The system under test: the port's render loop as ``cli.run`` drives it.

Iteration ``i`` renders from ``fold_in(PRNGKey(seed), i)`` through
``pt.render_pt``, ``bdpt.render_bdpt`` or ``ppm.render_ppm_with_stats`` in
the cell's tier, as ``cli.run``'s ``frame`` does, and the caller adds the
frame into ``film.AccumState``.  The benchmark takes only this loop, the
scene loader and the kernel names from the program."""
from __future__ import annotations

import time


def render_config(cls, traffic: dict, seed: int):
    """A ``RenderConfig`` (``cls``: the program's or the reference's) of a
    traffic mix, with ``cli.run``'s defaults for the rest."""
    return cls(width=traffic["width"], height=traffic["height"],
               spp=traffic.get("spp", 8), spl=traffic.get("spl", 8),
               eye_depth=traffic.get("eye_depth", 4),
               light_depth=traffic.get("light_depth", 4), seed=seed,
               ppm_alpha=traffic.get("ppm_alpha", 0.0),
               bdpt_resample_vertices=traffic.get("resample", 0))


class Program:
    """The port set up for one cell: kernels built, scene parsed and packed
    on ``device``, camera and config made; ``frame(i)`` renders iteration
    ``i``."""

    def __init__(self, traffic: dict, scene_path, seed: int, device: str):
        import torch

        from path_tracing_tpu_torch import film
        from path_tracing_tpu_torch.config import RenderConfig
        from path_tracing_tpu_torch.integrators import bdpt, ppm, pt
        from path_tracing_tpu_torch.ops import _kernels, rng
        from path_tracing_tpu_torch.scene.camera import make_camera
        from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

        self.torch, self.film, self.rng = torch, film, rng
        self.pt, self.bdpt, self.ppm = pt, bdpt, ppm
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _kernels.library()          # built once per checkout, then loaded
        self.kernel_names = tuple(_kernels.KERNELS)
        self.mode = traffic["mode"]
        self.W, self.H = traffic["width"], traffic["height"]
        self.spp, self.spl = traffic.get("spp", 8), traffic.get("spl", 8)
        t0 = time.perf_counter()
        parsed = load_any_scene(str(scene_path))
        self.scene = parsed.to_device(self.device)
        self.sync()
        self.scene_setup_s = time.perf_counter() - t0
        self.cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up,
                               parsed.fov, self.W, self.H,
                               device=self.device)
        self.cfg = render_config(RenderConfig, traffic, seed)
        tier = traffic.get("tier", "auto")
        self.tier = {"pt": lambda: pt.resolve_tier(self.scene, tier),
                     "bdpt": lambda: bdpt.resolve_tier(self.scene, tier,
                                                       self.cfg),
                     "ppm": lambda: ppm.resolve_tier(self.scene, tier)
                     }[self.mode]()
        self.key = rng.prng_key(seed)
        self.num_lights = self.scene.num_lights
        self.num_prims = (self.scene.num_triangles + self.scene.num_spheres
                          + self.scene.num_lights)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def frame(self, i: int):
        """Iteration ``i``'s image, (H*W, 3)."""
        k = self.rng.fold_in(self.key, i)
        if self.mode == "pt":
            return self.pt.render_pt(self.scene, self.cam, self.W, self.H,
                                     self.spp, self.cfg, k, tier=self.tier)
        if self.mode == "bdpt":
            return self.bdpt.render_bdpt(self.scene, self.cam, self.W,
                                         self.H, self.spp, self.spl,
                                         self.cfg, k, tier=self.tier)
        img, _, _ = self.ppm.render_ppm_with_stats(
            self.scene, self.cam, self.W, self.H, self.spl, self.cfg, k,
            self.ppm.ppm_radius_scale(i, self.cfg.ppm_alpha), self.tier)
        return img

    def zeros(self):
        return self.film.AccumState.zeros(self.W, self.H, self.device)
