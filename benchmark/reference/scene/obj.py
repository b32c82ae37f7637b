"""Wavefront OBJ/MTL loading (``path_tracing_tpu.scene.obj_loader``'s
Python parser): ``v``, ``vt`` and ``f`` records (fan triangulation,
negative indices), ``o``/``g`` groups, ``mtllib``/``usemtl`` with ``Kd``,
``Ns``, ``Ni``, ``d``/``Tr``, ``illum``, ``Pm``/``Pr`` and ``map_Kd`` (an
RGB8 PNG, gamma 2.2 to linear).  An OBJ takes ``default_framing``'s
camera and light, as the benchmark writes no companion lights file."""
from __future__ import annotations

import math
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .parser import ParsedScene, load_scene


@dataclass
class MtlDef:
    kd: tuple = (0.8, 0.8, 0.8)
    ns: float = 10.0
    ni: float = 0.0
    d: float = 1.0
    illum: int = 2
    pm: float | None = None      # PBR metallic
    pr: float | None = None      # PBR roughness
    map_kd: str | None = None    # diffuse texture, relative to the MTL file

    def to_material_row(self) -> List[float]:
        """-> [r, g, b, roughness, metallic, eta]."""
        rough = self.pr if self.pr is not None else math.sqrt(
            2.0 / (self.ns + 2.0))
        if self.pm is not None:
            metal = self.pm
        elif self.illum in (3, 5):
            metal, rough = 1.0, min(rough, 0.05)
        else:
            metal = 0.0
        eta = self.ni if (self.d < 1.0 or self.illum in (4, 6, 7, 9)) else 0.0
        return [*self.kd, rough, metal, eta]


def _parse_mtl(path: str) -> Dict[str, MtlDef]:
    mtls: Dict[str, MtlDef] = {}
    cur: MtlDef | None = None
    if not os.path.exists(path):
        return mtls
    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0].lower()
            try:
                if key == "newmtl":
                    cur = MtlDef()
                    mtls[tok[1]] = cur
                elif cur is None:
                    continue
                elif key == "kd":
                    cur.kd = tuple(float(x) for x in tok[1:4])
                elif key == "ns":
                    cur.ns = float(tok[1])
                elif key == "ni":
                    cur.ni = float(tok[1])
                elif key == "d":
                    cur.d = float(tok[1])
                elif key == "tr":
                    cur.d = 1.0 - float(tok[1])
                elif key == "illum":
                    cur.illum = int(float(tok[1]))
                elif key == "pm":
                    cur.pm = float(tok[1])
                elif key == "pr":
                    cur.pr = float(tok[1])
                elif key == "map_kd":
                    cur.map_kd = tok[-1]
            except (ValueError, IndexError):
                continue
    return mtls


def read_png_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a non-interlaced RGB8 PNG whose rows are all
    unfiltered; anything else raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, idat = 8, None, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not a plain RGB8 PNG ({hdr})")
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _decode_texture(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear RGB in [0, 1]: the bytes are gamma
    encoded, decoded with the 2.2 power."""
    raw = np.asarray(read_png_rgb8(path), np.float32)
    return (raw / 255.0) ** 2.2


def load_obj(path: str) -> ParsedScene:
    """Parse an OBJ file into a ParsedScene (triangles only)."""
    out = ParsedScene()
    verts: List[List[float]] = []
    texcoords: List[List[float]] = []
    mtls: Dict[str, MtlDef] = {}
    cur_mtl = [0.8, 0.8, 0.8, 0.5, 0.0, 0.0]
    cur_tex = -1
    tex_ids: Dict[str, int] = {}
    group_id = next_group = 0
    base = os.path.dirname(os.path.abspath(path))

    def vidx(tok: str) -> int:
        i = int(tok.split("/")[0])
        return i - 1 if i > 0 else len(verts) + i

    def tidx(tok: str) -> int:
        parts = tok.split("/")
        if len(parts) < 2 or not parts[1]:
            return -1
        i = int(parts[1])
        return i - 1 if i > 0 else len(texcoords) + i

    def tex_of(m: MtlDef) -> int:
        if not m.map_kd:
            return -1
        p = os.path.normpath(os.path.join(base, m.map_kd))
        if p not in tex_ids:
            tex_ids[p] = len(out.textures)
            out.textures.append(_decode_texture(p))
        return tex_ids[p]

    with open(path) as f:
        for line in f:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0]
            try:
                if key == "v":
                    verts.append([float(tok[1]), float(tok[2]),
                                  float(tok[3])])
                elif key == "vt":
                    texcoords.append([float(tok[1]),
                                      float(tok[2]) if len(tok) > 2 else 0.0])
                elif key == "mtllib":
                    mtls.update(_parse_mtl(os.path.join(base, tok[1])))
                elif key == "usemtl":
                    if tok[1] in mtls:
                        cur_mtl = mtls[tok[1]].to_material_row()
                        cur_tex = tex_of(mtls[tok[1]])
                elif key in ("o", "g"):
                    next_group += 1
                    group_id = next_group
                elif key == "f":
                    idx = [vidx(t) for t in tok[1:]]
                    uvi = [tidx(t) for t in tok[1:]]
                    for k in range(1, len(idx) - 1):
                        out.tri_verts.append([verts[idx[0]], verts[idx[k]],
                                              verts[idx[k + 1]]])
                        out.tri_mtl.append(list(cur_mtl))
                        out.tri_group.append(group_id)
                        corners = (uvi[0], uvi[k], uvi[k + 1])
                        in_range = all(0 <= c < len(texcoords)
                                       for c in corners)
                        uv: List[float] = []
                        for c in corners:
                            uv.extend(texcoords[c] if in_range
                                      else [0.0, 0.0])
                        out.tri_uv.append(uv)
                        out.tri_tex.append(cur_tex if in_range else -1)
            except (ValueError, IndexError):
                continue
    return out


def default_framing(out: ParsedScene) -> ParsedScene:
    """The camera outside the bounding box along -z, looking at its centre,
    and one overhead spot light."""
    v = np.asarray([p for tri in out.tri_verts for p in tri], np.float32)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))
    out.eye = (center + np.array([0, 0.25 * diag, -1.2 * diag],
                                 np.float32)).astype(np.float32)
    out.look_at = center.astype(np.float32)
    out.view_up = np.array([0, 1, 0], np.float32)
    out.fov = 50.0
    out.width = out.width or 512
    out.height = out.height or 512
    out.lights = [[*(center + np.array([0, 0.9 * diag, 0])), 0, -1, 0,
                   20.0 * diag, 20.0 * diag, 20.0 * diag,
                   math.radians(180.0), 0, 0.05 * diag]]
    return out


def load_any_scene(path: str) -> ParsedScene:
    """A text scene, or an OBJ framed by ``default_framing``."""
    if not path.lower().endswith(".obj"):
        return load_scene(path)
    return default_framing(load_obj(path))
