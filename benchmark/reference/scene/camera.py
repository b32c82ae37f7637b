"""Pinhole camera basis and primary rays (``path_tracing_tpu.scene.camera``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.math3 import dot
from .types import Camera


def make_camera(eye, look_at, view_up, fov_deg: float, width: int,
                height: int, *, device, force_fov: float | None = None
                ) -> Camera:
    eye = np.asarray(eye, np.float32)
    look_at = np.asarray(look_at, np.float32)
    view_up = np.asarray(view_up, np.float32)
    fov = float(force_fov) if force_fov is not None else float(fov_deg)

    aspect = width / height
    half_height = math.tan(fov * math.pi / 180.0 / 2.0)
    half_width = aspect * half_height

    w = eye - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(view_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    ul = eye - half_width * u + half_height * v - w
    dx = (2.0 * half_width * u) / width
    dy = (-2.0 * half_height * v) / height

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(eye=t(eye), ul=t(ul), dx=t(dx), dy=t(dy))


def primary_ray_dirs(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                     jx: torch.Tensor, jy: torch.Tensor) -> torch.Tensor:
    """Jittered primary ray directions (B, 3) for pixel indices px, py."""
    pixel = (cam.ul[None, :]
             + cam.dx[None, :] * (px.to(torch.float32) + jx)[:, None]
             + cam.dy[None, :] * (py.to(torch.float32) + jy)[:, None])
    d = pixel - cam.eye[None, :]
    return d / torch.sqrt(dot(d, d))[:, None]
