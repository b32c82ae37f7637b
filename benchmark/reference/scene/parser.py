"""Text scene-format parser (the ``E/V/F/R/M/K/S/T/G/L`` grammar of
``path_tracing_tpu.scene.parser``):

    E  x y z                                   camera eye
    V  lx ly lz  ux uy uz                      look_at + view_up
    F  fov_deg                                 field of view
    R  W H                                     resolution
    M  r g b  roughness metallic eta           current material (PBR)
    K  ksr ksg ksb refract                     legacy Ks/refract of it
    S  cx cy cz  radius                        sphere
    T  x0 y0 z0  x1 y1 z1  x2 y2 z2            triangle
    G  id                                      current group id
    L  px py pz  dx dy dz  ir ig ib  cutoff_deg  is_parallel  ball_r
    // ...                                     comment to end of line

Tokens that are not a record tag are skipped one at a time, as the
reference's stream loop does; a tag followed by non-numeric text is skipped
too.  ``cutoff`` is converted to radians at parse time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .types import Scene, scene_from_numpy

_TAGS = set("EVFRMKSTGL")


@dataclass
class ParsedScene:
    """Host-side parse result (numpy / lists); ``to_device`` builds a Scene."""

    eye: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    look_at: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    view_up: np.ndarray = field(
        default_factory=lambda: np.array([0, 1, 0], np.float32))
    fov: float = 50.0
    width: int = 0
    height: int = 0
    sph_center: List = field(default_factory=list)
    sph_radius: List = field(default_factory=list)
    sph_mtl: List = field(default_factory=list)    # [r,g,b,rough,metal,eta]
    sph_group: List = field(default_factory=list)
    tri_verts: List = field(default_factory=list)  # rows of 3 vertices
    tri_mtl: List = field(default_factory=list)
    tri_group: List = field(default_factory=list)
    lights: List = field(default_factory=list)
    # textures (OBJ map_Kd; empty for text scenes): per-triangle vertex UVs
    # [u0, v0, u1, v1, u2, v2], per-triangle texture index (-1 untextured)
    # and the decoded images (H, W, 3) float32 linear RGB
    tri_uv: List = field(default_factory=list)
    tri_tex: List = field(default_factory=list)
    textures: List = field(default_factory=list)
    # legacy shadow-transmittance rows [ksr, ksg, ksb, refract] per object
    sph_legacy: List = field(default_factory=list)
    tri_legacy: List = field(default_factory=list)

    def texture_atlas(self):
        """All textures in one (NT, TH+1, TW+1, 3) atlas with a one-texel
        wrapped border (row h = row 0, col w = col 0), so a bilinear fetch
        reads its whole 2x2 footprint from one slice, and their (NT, 2)
        sizes (h, w).  None, None without textures."""
        if not self.textures:
            return None, None
        th = max(t.shape[0] for t in self.textures) + 1
        tw = max(t.shape[1] for t in self.textures) + 1
        atlas = np.zeros((len(self.textures), th, tw, 3), np.float32)
        size = np.zeros((len(self.textures), 2), np.int32)
        for i, t in enumerate(self.textures):
            h, w = t.shape[0], t.shape[1]
            atlas[i, :h, :w] = t
            atlas[i, h, :w] = t[0]
            atlas[i, :h, w] = t[:, 0]
            atlas[i, h, w] = t[0, 0]
            size[i] = (h, w)
        return atlas, size

    def to_device(self, device, cluster_leaf_size: int | None = None
                  ) -> Scene:
        lights = np.asarray(self.lights, np.float32).reshape(-1, 12)
        tv = np.asarray(self.tri_verts, np.float32).reshape(-1, 3, 3)
        tex_atlas, tex_size = self.texture_atlas()
        return scene_from_numpy(
            sph_center=np.asarray(self.sph_center, np.float32).reshape(-1, 3),
            sph_radius=np.asarray(self.sph_radius, np.float32),
            sph_mtl=np.asarray(self.sph_mtl, np.float32).reshape(-1, 6),
            tri_v0=tv[:, 0], tri_v1=tv[:, 1], tri_v2=tv[:, 2],
            tri_mtl=np.asarray(self.tri_mtl, np.float32).reshape(-1, 6),
            light_pos=lights[:, 0:3], light_dir=lights[:, 3:6],
            light_illum=lights[:, 6:9], light_cutoff=lights[:, 9],
            light_is_parallel=lights[:, 10].astype(np.int32),
            light_ball_r=lights[:, 11],
            device=device, cluster_leaf_size=cluster_leaf_size,
            tri_uv=(np.asarray(self.tri_uv, np.float32).reshape(-1, 6)
                    if len(self.tri_uv) else None),
            tri_tex=(np.asarray(self.tri_tex, np.int32)
                     if len(self.tri_tex) else None),
            tex_atlas=tex_atlas, tex_size=tex_size,
            sph_legacy=(np.asarray(self.sph_legacy, np.float32)
                        if len(self.sph_legacy) else None),
            tri_legacy=(np.asarray(self.tri_legacy, np.float32)
                        if len(self.tri_legacy) else None),
        )


def _tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    for line in text.splitlines():
        cut = line.find("//")
        if cut >= 0:
            line = line[:cut]
        tokens.extend(line.split())
    return tokens


def parse_scene_text(text: str) -> ParsedScene:
    out = ParsedScene()
    toks = _tokenize(text)
    i = 0
    n = len(toks)
    mtl = [0.0] * 6
    legacy = [0.0] * 4
    group_id = 0

    def take(k: int) -> List[float]:
        nonlocal i
        vals = [float(toks[i + j]) for j in range(k)]
        i += k
        return vals

    while i < n:
        t = toks[i]
        i += 1
        if t not in _TAGS:
            continue
        try:
            if t == "E":
                out.eye = np.array(take(3), np.float32)
            elif t == "V":
                v = take(6)
                out.look_at = np.array(v[0:3], np.float32)
                out.view_up = np.array(v[3:6], np.float32)
            elif t == "F":
                out.fov = take(1)[0]
            elif t == "R":
                v = take(2)
                out.width, out.height = int(v[0]), int(v[1])
            elif t == "M":
                mtl = take(6)
                legacy = [0.0] * 4  # a new material has a clean legacy tail
            elif t == "K":
                legacy = take(4)
            elif t == "S":
                v = take(4)
                out.sph_center.append(v[0:3])
                out.sph_radius.append(v[3])
                out.sph_mtl.append(list(mtl))
                out.sph_legacy.append(list(legacy))
                out.sph_group.append(group_id)
            elif t == "T":
                v = take(9)
                out.tri_verts.append([v[0:3], v[3:6], v[6:9]])
                out.tri_mtl.append(list(mtl))
                out.tri_legacy.append(list(legacy))
                out.tri_group.append(group_id)
            elif t == "G":
                group_id = int(float(toks[i]))
                i += 1
            elif t == "L":
                v = take(12)
                v[9] = math.radians(v[9])
                out.lights.append(v)
        except (ValueError, IndexError):
            continue
    return out


def load_scene(path: str) -> ParsedScene:
    with open(path, "r") as f:
        return parse_scene_text(f.read())
