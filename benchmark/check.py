"""The comparison that decides ``correct``.

The window keeps, for ``n`` pixels drawn from the seed (``subset``: a
block of consecutive pixels, or pixels spread evenly over the frame where
the block would be short), the rows of a few frames drawn from the seed among all
the iterations it completed (a reservoir), and a running sum of that
block of every frame, added in the order the program accumulates.  After
the window the plain reference (``reference/``, run on the same device
with no kernel) parses the scene file again and renders the same block of
each kept iteration from the same key.  Two numbers are compared, each
with the cell's limit (``limits/<cell>.json``):

- ``frame_rel_l1``: the largest, over the kept frames, of the sum of
  absolute differences over the sum of the reference's absolute values;
- ``accum_mismatch``: the values of the block where the program's
  accumulated image is not bit for bit the sum of its frames (limit 0).

A BDPT block lies inside one of the tile-local RIS tables' tiles
(``TILE_LANES`` pixels), so the reference builds every tile's table and
uses that tile's.  Uniforms are pure functions of (key, row, lane), so a
block of lanes draws the numbers the whole frame gives them."""
from __future__ import annotations

import contextlib
import dataclasses
import random

TILE_LANES = 128 * 128


def subset(traffic: dict, num_prims: int, seed: int,
           want: str = "check_pixels") -> tuple:
    """(start, n, step): the pixels ``start + step * k`` for ``k < n``.  At
    most ``traffic[want]`` pixels and ``check_prim_tests`` over the
    scene's primitives (the plain nearest hit tests every primitive of
    every lane), and for BDPT at most one tile.  A whole block is
    consecutive (``step`` 1) from a tile's first pixel drawn from the
    seed.  Where the primitive budget cuts PT's block below
    ``traffic[want]``, so that a block would span less than a row or two
    of the image, the ``n`` pixels are spread evenly over the whole frame
    instead, from an offset drawn from the seed, so that they cross
    whatever the image shows."""
    B = traffic["width"] * traffic["height"]
    n = min(traffic[want], B,
            max(traffic["check_prim_tests"] // max(num_prims, 1), 256))
    if traffic["mode"] == "bdpt":
        n = min(n, TILE_LANES)
    pick = random.Random(seed ^ 0x5EB5)
    if traffic["mode"] == "pt" and n < min(traffic[want], B):
        step = B // n
        return pick.randrange(step), n, step
    tiles = max((B - n) // TILE_LANES + 1, 1)
    return TILE_LANES * pick.randrange(tiles), n, 1


def pixel_slice(start: int, n: int, step: int) -> slice:
    """The rows of a frame (H*W, 3) that ``subset``'s pixels are."""
    return slice(start, start + step * (n - 1) + 1, step)


class Reference:
    """The plain reference for one cell, on ``device``."""

    def __init__(self, traffic: dict, scene_path, seed: int, device):
        import torch

        from .program import render_config
        from .reference.config import RenderConfig
        from .reference.ops import rng
        from .reference.scene.camera import make_camera
        from .reference.scene.obj import load_any_scene

        self.torch, self.rng = torch, rng
        self.traffic, self.seed = traffic, seed
        self.W, self.H = traffic["width"], traffic["height"]
        self.mode = traffic["mode"]
        parsed = load_any_scene(str(scene_path))
        self.scene = parsed.to_device(device)
        self.cam = make_camera(parsed.eye, parsed.look_at, parsed.view_up,
                               parsed.fov, self.W, self.H, device=device)
        self.cfg = render_config(RenderConfig, traffic, seed)
        self.device = torch.device(device)

    def frame(self, i: int, start: int, n: int, step: int = 1,
              counts: dict | None = None, round_to=None):
        """Pixels ``start + step * k``, ``k < n``, of iteration ``i``'s
        frame, (n, 3).  ``counts``: a dict that gains the main kernel's
        counted work (``work_counts`` makes it).  ``round_to``: a dtype
        that the scene's tables, the camera and every uniform are rounded
        to first (the control)."""
        torch, W = self.torch, self.W
        key = self.rng.fold_in(self.rng.prng_key(self.seed), i)
        idx = start + step * torch.arange(n, dtype=torch.int32,
                                          device=self.device)
        px, py = idx % W, idx // W
        total = W * self.H
        if step != 1:
            if self.mode != "pt":
                raise ValueError("only PT compares pixels that are not "
                                 "consecutive")
            start = idx.long()      # each lane's column of the draws
        with _rounded(self, round_to) as (scene, cam):
            return getattr(self, f"_{self.mode}")(scene, cam, key, i, px, py,
                                                  start, total, counts)

    def _pt(self, scene, cam, key, i, px, py, start, total, counts):
        from .reference.integrators.pt import _light_table, wavefront_loop
        from .reference.ops.cuda_intersect import pack_scene
        from .reference.ops.cuda_shade import shade_step_tex_plain
        from .reference.ops.cuda_wavefront import render_wavefront_plain

        spp = self.cfg.spp
        if scene.has_textures:
            # the per-bounce loop with the textured bounce, which draws the
            # numbers the megakernel draws
            return wavefront_loop(
                pack_scene(scene), _light_table(scene), cam, self.cfg, px,
                py, spp, key, start, total, shade_step_tex_plain,
                self.rng.uniform_rows_plain, counts) / spp
        return render_wavefront_plain(
            pack_scene(scene), _light_table(scene), cam, px, py, spp,
            self.cfg, key, start, total, counts) / spp

    def _bdpt(self, scene, cam, key, i, px, py, start, total, counts):
        from .reference.integrators import bdpt
        from .reference.ops.cuda_intersect import pack_scene

        cfg, spp, W = self.cfg, self.cfg.spp, self.W
        scene_used, lv, lhs = bdpt.light_side(scene, cfg, self.cfg.spl, key)
        full = self.torch.arange(total, dtype=self.torch.int32,
                                 device=self.device)
        tab, n_valid = bdpt.light_table(scene_used, lv, cam, cfg, full % W,
                                        full // W, key)
        if counts is not None:
            counts["table_bytes"] = tab.numel() * 4
        if tab.dim() == 3:
            t = start // TILE_LANES
            tab = tab[t:t + 1]
        return bdpt.bdpt_eye_plain_loop(
            pack_scene(scene_used), tab, n_valid, cam, px, py, spp, cfg,
            key, lhs, start, total, counts) / spp

    def _ppm(self, scene, cam, key, i, px, py, start, total, counts):
        from .reference.integrators import ppm
        from .reference.ops.cuda_ppm_gather import join_plain, prepare

        cfg, spl = self.cfg, self.cfg.spl
        r2 = ppm.ppm_radius_scale(i, cfg.ppm_alpha)
        direct, hp = ppm.ppm_eye_trace(scene, cam, cfg, px, py,
                                       self.rng.fold_in(key, 1), start,
                                       total)
        events = ppm.ppm_photon_trace(scene, cfg, scene.num_lights * spl,
                                      spl, self.rng.fold_in(key, 2))
        t = prepare(scene, cfg, hp, events, r2)
        flux, _ = join_plain(t, counts)
        if counts is not None:
            counts["gathered"] = int((t.hp_cell >= 0).sum())
            counts["cells"] = int(t.win.shape[0])
            counts["events"] = int(t.ev.shape[0])
        return ppm.resolve_image(cfg, direct, hp, flux, r2)

    def work_counts(self) -> dict:
        """A fresh dict of the counters the mode's main kernel's plain
        version fills."""
        from .reference.ops import cuda_connect, cuda_ppm_gather
        from .reference.ops import cuda_wavefront

        return {"pt": cuda_wavefront.new_counts,
                "bdpt": cuda_connect.new_counts,
                "ppm": cuda_ppm_gather.new_counts}[self.mode]()


@contextlib.contextmanager
def _rounded(ref: Reference, dtype):
    """The reference's scene and camera, or copies with every float table
    rounded to ``dtype`` and the reference's Threefry uniforms rounded to
    it while the block runs."""
    if dtype is None:
        yield ref.scene, ref.cam
        return
    torch, rng = ref.torch, ref.rng

    def rnd(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype).to(x.dtype)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: rnd(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    plain = rng._bits_to_unit
    rng._bits_to_unit = lambda bits: rnd(plain(bits))
    try:
        yield rnd(ref.scene), rnd(ref.cam)
    finally:
        rng._bits_to_unit = plain


def rel_l1(prog, ref) -> float:
    """Sum of absolute differences over the sum of the reference's absolute
    values (a difference where the reference is all zero reads inf)."""
    num = float((prog.double() - ref.double()).abs().sum())
    den = float(ref.double().abs().sum())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def accum_mismatch(accum_block, shadow) -> int:
    """Values of the block where the accumulated image is not bit for bit
    the running sum of the frames."""
    import torch

    a = accum_block.contiguous().view(torch.int32)
    b = shadow.contiguous().view(torch.int32)
    return int((a != b).sum())
