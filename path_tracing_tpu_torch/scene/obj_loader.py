"""Wavefront OBJ/MTL loader, the tinyobj-compatible subset of
``path_tracing_tpu.scene.obj_loader`` (the Python parsers, the behaviour the
native C++ parser of ``runtime/native.py`` implements too).

- ``v`` positions, ``vt`` texcoords (``vn`` is skipped: shading uses
  geometric normals);
- ``f`` faces in the ``v``, ``v/vt``, ``v//vn`` and ``v/vt/vn`` forms,
  negative (relative) indices, fan triangulation;
- ``o``/``g`` start a new group id, as the text format's ``G`` records;
- ``mtllib``/``usemtl`` with MTL fields ``Kd``, ``Ns`` (roughness =
  sqrt(2 / (Ns + 2))), ``Ni``, ``d``/``Tr`` (d < 1 marks a dielectric),
  ``illum`` (3/5: mirror-like metal), ``Pm``/``Pr`` (PBR metallic and
  roughness, which take precedence) and ``map_Kd`` (diffuse texture,
  decoded with PIL when it is installed, else with ``film.read_png``, and
  modulated onto the base color at hit time).

``load_any_scene`` parses with the native C++ runtime when it is
available (``PT_TPU_NO_NATIVE=1`` forces the Python parsers), as the JAX
package does, and dispatches on the extension: a ``.obj`` takes its
camera and lights from a companion ``<name>.lights.txt`` text scene, or
from ``default_framing``.
"""
from __future__ import annotations

import math
import os
import sys
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
                    cur.map_kd = tok[-1]   # options (-o, -s ...) precede it
            except (ValueError, IndexError):
                continue                   # tolerant like the text parser
    return mtls


def _decode_texture(path: str) -> "np.ndarray | None":
    """Image file -> (H, W, 3) float32 linear RGB in [0, 1]: the bytes are
    gamma-encoded, decoded with the 2.2 power the film encodes with.  PIL
    when installed, else ``film.read_png``; None (the flat color, with a
    warning naming the file) when neither decodes it."""
    try:
        from PIL import Image

        raw = np.asarray(Image.open(path).convert("RGB"), np.float32)
    except Exception:
        try:
            from ..film import read_png

            raw = np.asarray(read_png(path), np.float32)
        except Exception as e:
            print(f"[warning] texture {path} could not be read ({e}); the "
                  "material keeps its flat Kd", file=sys.stderr)
            return None
    return (raw / 255.0) ** 2.2


def load_obj(path: str, default_mtl: List[float] | None = None
             ) -> ParsedScene:
    """Parse an OBJ file into a ParsedScene (triangles only; the camera and
    lights come from ``load_any_scene``)."""
    out = ParsedScene()
    verts: List[List[float]] = []
    texcoords: List[List[float]] = []
    mtls: Dict[str, MtlDef] = {}
    cur_mtl = list(default_mtl or [0.8, 0.8, 0.8, 0.5, 0.0, 0.0])
    cur_tex = -1
    tex_ids: Dict[str, int] = {}   # resolved path -> index into textures
    group_id = next_group = 0
    base = os.path.dirname(os.path.abspath(path))

    def vidx(tok: str) -> int:
        i = int(tok.split("/")[0])
        return i - 1 if i > 0 else len(verts) + i

    def tidx(tok: str) -> int:
        """vt index of a face token, or -1 without one (v, v//vn)."""
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
            img = _decode_texture(p)
            tex_ids[p] = -1 if img is None else len(out.textures)
            if img is not None:
                out.textures.append(img)
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
                    for k in range(1, len(idx) - 1):   # fan triangulation
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
    """Default camera and one overhead spot light for a scene without
    E/V/F/R/L records: look at the bounding-box center from outside along
    -z (bare OBJ loads and the synthetic scenes of ``scene/synth.py``)."""
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
    """A text scene, or an OBJ with the camera and lights of its companion
    ``<name>.lights.txt`` text scene when there is one, else of
    ``default_framing``.  The file is parsed by the native C++ runtime
    when it is available and ``PT_TPU_NO_NATIVE`` is not set, else by the
    Python parsers."""
    native_out = None
    if not os.environ.get("PT_TPU_NO_NATIVE"):
        from ..runtime.native import parse_scene_native

        native_out = parse_scene_native(path)
    if not path.lower().endswith(".obj"):
        return native_out if native_out is not None else load_scene(path)
    out = native_out if native_out is not None else load_obj(path)
    companion = os.path.splitext(path)[0] + ".lights.txt"
    if os.path.exists(companion):
        comp = load_scene(companion)
        out.eye, out.look_at, out.view_up = comp.eye, comp.look_at, \
            comp.view_up
        out.fov, out.width, out.height = comp.fov, comp.width, comp.height
        out.lights = comp.lights
        return out
    return default_framing(out)
