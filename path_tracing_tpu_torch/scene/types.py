"""Scene data model as structure-of-arrays torch tensors on one device
(``path_tracing_tpu.scene.types``).

``scene_from_numpy`` builds a Scene from host arrays: it reorders the
triangles, with their UVs and texture ids, into spatial clusters
(``ops/bvh.py``), and the spheres too from ``SPHERE_INDEX_MIN`` of them
on (the sphere index), and computes the scene bounds.
``scene_from_jax_arrays`` carries a Scene and Camera over from the JAX
package's arrays unchanged, so both packages can render the very same
tables.  Both pack the kernels' tables once (``ops/cuda_intersect.py::
pack_scene``), and the Scene carries them as ``packed``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from ..ops.cuda_intersect import PackedScene
    from ..ops.cuda_stream import StreamScene

MAX_RESIDENT_TRIS = 131072  # leaf-size rule threshold (TPU VMEM ceiling)


@dataclass
class Material:
    """PBR material: base color, GGX roughness, metallic, IOR.  Fields
    broadcast: ``base_color`` is ``(..., 3)``, the rest ``(...,)``."""

    base_color: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    eta: torch.Tensor

    @staticmethod
    def light_ball(illum: torch.Tensor) -> "Material":
        """Material seen when a ray hits a light ball: the CPU oracle's
        (eta 0, roughness 1, metallic 0) with base_color = flux."""
        shape = illum.shape[:-1]
        kw = dict(dtype=illum.dtype, device=illum.device)
        return Material(base_color=illum, roughness=torch.ones(shape, **kw),
                        metallic=torch.zeros(shape, **kw),
                        eta=torch.zeros(shape, **kw))


def _f32(x, device, shape=None):
    a = np.asarray(x, np.float32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _i32(x, device, shape=None):
    a = np.asarray(x, np.int32)
    if shape is not None:
        a = a.reshape(shape)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@dataclass
class Scene:
    """Spheres, triangles (cluster-contiguous), lights, the scene AABB and
    the triangle clusters (rows ``[min3, max3]`` and ``[start, count]``).
    The texture atlas and legacy Ks/refract tables are empty for text
    scenes.  ``packed`` holds the kernels' tables, the sphere index's among
    them (``ops/cuda_intersect.py::pack_scene``); ``stream`` the stream
    tier's, once a frame asked for them (``stream_tables``)."""

    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mtl: Material
    tri_v0: torch.Tensor
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_mtl: Material
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    light_illum: torch.Tensor
    light_cutoff: torch.Tensor
    light_is_parallel: torch.Tensor  # int32 (0/1)
    light_ball_r: torch.Tensor
    scene_min: torch.Tensor
    scene_max: torch.Tensor
    tri_cluster_aabb: torch.Tensor   # (M, 6)
    tri_cluster_range: torch.Tensor  # (M, 2) int32
    tri_uv: torch.Tensor = field(default_factory=lambda: torch.zeros(0, 6))
    tri_tex: torch.Tensor = field(
        default_factory=lambda: torch.zeros(0, dtype=torch.int32))
    tex_atlas: torch.Tensor = field(
        default_factory=lambda: torch.zeros(0, 1, 1, 3))
    tex_size: torch.Tensor = field(
        default_factory=lambda: torch.zeros(0, 2, dtype=torch.int32))
    sph_ks: torch.Tensor = field(default_factory=lambda: torch.zeros(0, 3))
    sph_refract: torch.Tensor = field(default_factory=lambda: torch.zeros(0))
    tri_ks: torch.Tensor = field(default_factory=lambda: torch.zeros(0, 3))
    tri_refract: torch.Tensor = field(default_factory=lambda: torch.zeros(0))
    packed: "PackedScene | None" = None
    stream: "StreamScene | None" = field(default=None, init=False,
                                         repr=False)

    @property
    def device(self) -> torch.device:
        return self.sph_center.device

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def has_textures(self) -> bool:
        return self.tex_atlas.shape[0] > 0 and self.tri_tex.shape[0] > 0

    @property
    def has_legacy_ks(self) -> bool:
        return self.sph_ks.shape[0] > 0 or self.tri_ks.shape[0] > 0

    def with_illum_scaled(self, scale: float) -> "Scene":
        """The scene with light flux scaled (BDPT divides it by the light
        sample count), its tables the scene's but for the flux columns."""
        illum = self.light_illum * scale
        return dataclasses.replace(self, light_illum=illum,
                                   packed=self.packed.with_illum(illum))

    def stream_tables(self) -> "StreamScene":
        """The stream tier's tables (``ops/cuda_stream.py``), built by the
        first call and held."""
        if self.stream is None:
            from ..ops.cuda_stream import pack_scene_stream

            self.stream = pack_scene_stream(self)
        return self.stream


@dataclass
class Camera:
    """Pinhole camera: ray through pixel (x, y) is
    ``normalize(ul + dx*(x+jx) + dy*(y+jy) - eye)``."""

    eye: torch.Tensor
    ul: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor


def default_leaf_size(nt: int) -> int:
    """Leaf 8 for small text scenes (a 36-triangle box becomes several
    slab-gated clusters), 64 for resident meshes, 256 beyond."""
    return 8 if nt <= 256 else (64 if nt <= MAX_RESIDENT_TRIS else 256)


def scene_from_numpy(
    sph_center, sph_radius, sph_mtl, tri_v0, tri_v1, tri_v2, tri_mtl,
    light_pos, light_dir, light_illum, light_cutoff, light_is_parallel,
    light_ball_r, *, device, cluster_leaf_size: int | None = None,
    tri_uv=None, tri_tex=None, tex_atlas=None, tex_size=None,
    sph_legacy=None, tri_legacy=None,
) -> Scene:
    """Build a Scene on ``device`` from host arrays.  ``sph_mtl`` and
    ``tri_mtl`` are ``(N, 6)`` rows ``[r, g, b, roughness, metallic, eta]``;
    ``tri_uv`` (N, 6), ``tri_tex`` (N,) and the atlas with its sizes come
    from ``ParsedScene.texture_atlas`` (default: no textures).

    Triangles are reordered into clusters (``ops/bvh.py::build_clusters``:
    the native builder when it is available), their UVs and texture ids
    with them; from ``SPHERE_INDEX_MIN`` spheres on the spheres are
    reordered into the clusters of ``build_sphere_clusters``, their
    materials and legacy rows with them (in a ``scene.sphere_index``
    span), and the tables are packed over those clusters; the scene AABB is
    the union of sphere bounds and triangle vertices (light balls
    excluded)."""
    from ..ops.bvh import (SPHERE_INDEX_MIN, SPHERE_LEAF, build_clusters,
                           build_sphere_clusters)
    from ..ops.cuda_intersect import pack_scene
    from ..profiling import span

    f32 = np.float32
    sph_center = np.asarray(sph_center, f32).reshape(-1, 3)
    sph_radius = np.asarray(sph_radius, f32).reshape(-1)
    tri_v0 = np.asarray(tri_v0, f32).reshape(-1, 3)
    tri_v1 = np.asarray(tri_v1, f32).reshape(-1, 3)
    tri_v2 = np.asarray(tri_v2, f32).reshape(-1, 3)
    sph_mtl = np.asarray(sph_mtl, f32).reshape(-1, 6)
    tri_mtl = np.asarray(tri_mtl, f32).reshape(-1, 6)

    nt = tri_v0.shape[0]
    leaf = (default_leaf_size(nt) if cluster_leaf_size is None
            else cluster_leaf_size)
    tri_uv = (np.asarray(tri_uv, f32).reshape(-1, 6) if tri_uv is not None
              else np.zeros((nt, 6), f32))
    tri_tex = (np.asarray(tri_tex, np.int32).reshape(-1)
               if tri_tex is not None else np.full((nt,), -1, np.int32))
    if tex_atlas is None or not np.size(tex_atlas):
        tex_atlas = np.zeros((0, 1, 1, 3), f32)
        tex_size = np.zeros((0, 2), np.int32)

    # legacy Ks/refract rows are kept only when some object refracts: the
    # all-zero tables are the reference's reachable state (binary blocking)
    sph_legacy = (np.asarray(sph_legacy, f32).reshape(-1, 4)
                  if sph_legacy is not None else np.zeros((0, 4), f32))
    tri_legacy = (np.asarray(tri_legacy, f32).reshape(-1, 4)
                  if tri_legacy is not None else np.zeros((0, 4), f32))
    if not (sph_legacy[:, 3] > 0).any() and not (tri_legacy[:, 3] > 0).any():
        sph_legacy = np.zeros((0, 4), f32)
        tri_legacy = np.zeros((0, 4), f32)
    elif (tri_legacy.shape[0] != nt
          or sph_legacy.shape[0] != sph_center.shape[0]):
        raise ValueError("legacy material rows must match object counts")

    if nt > leaf:
        tris9 = np.concatenate([tri_v0, tri_v1, tri_v2], axis=1)
        order, cl_aabb, cl_range = build_clusters(tris9, leaf)
        tri_v0, tri_v1, tri_v2 = tri_v0[order], tri_v1[order], tri_v2[order]
        tri_mtl = tri_mtl[order]
        tri_uv, tri_tex = tri_uv[order], tri_tex[order]
        if tri_legacy.shape[0]:
            tri_legacy = tri_legacy[order]
    else:
        if nt:
            verts = np.concatenate([tri_v0, tri_v1, tri_v2], axis=0)
            cl_aabb = np.concatenate([verts.min(axis=0),
                                      verts.max(axis=0)])[None, :]
        else:
            cl_aabb = np.array([[1e9, 1e9, 1e9, -1e9, -1e9, -1e9]], f32)
        cl_range = np.array([[0, nt]], np.int32)

    sph_clusters = None
    if sph_center.shape[0] >= SPHERE_INDEX_MIN:
        with span("scene.sphere_index"):
            order, sph_cl_aabb, sph_cl_range = build_sphere_clusters(
                sph_center, sph_radius, SPHERE_LEAF)
            sph_center, sph_radius = sph_center[order], sph_radius[order]
            sph_mtl = sph_mtl[order]
            if sph_legacy.shape[0]:
                sph_legacy = sph_legacy[order]
            sph_clusters = (_f32(sph_cl_aabb, device, (-1, 6)),
                            _i32(sph_cl_range, device, (-1, 2)))

    mins, maxs = [], []
    if sph_center.shape[0]:
        mins.append((sph_center - sph_radius[:, None]).min(axis=0))
        maxs.append((sph_center + sph_radius[:, None]).max(axis=0))
    if nt:
        verts = np.concatenate([tri_v0, tri_v1, tri_v2], axis=0)
        mins.append(verts.min(axis=0))
        maxs.append(verts.max(axis=0))
    if mins:
        scene_min = np.minimum.reduce(mins)
        scene_max = np.maximum.reduce(maxs)
    else:
        scene_min = np.full(3, 1e9, f32)
        scene_max = np.full(3, -1e9, f32)

    def mtl(rows):
        return Material(base_color=_f32(rows[:, 0:3], device),
                        roughness=_f32(rows[:, 3], device),
                        metallic=_f32(rows[:, 4], device),
                        eta=_f32(rows[:, 5], device))

    scene = Scene(
        sph_center=_f32(sph_center, device),
        sph_radius=_f32(sph_radius, device),
        sph_mtl=mtl(sph_mtl),
        tri_v0=_f32(tri_v0, device), tri_v1=_f32(tri_v1, device),
        tri_v2=_f32(tri_v2, device), tri_mtl=mtl(tri_mtl),
        light_pos=_f32(light_pos, device, (-1, 3)),
        light_dir=_f32(light_dir, device, (-1, 3)),
        light_illum=_f32(light_illum, device, (-1, 3)),
        light_cutoff=_f32(light_cutoff, device, (-1,)),
        light_is_parallel=_i32(light_is_parallel, device, (-1,)),
        light_ball_r=_f32(light_ball_r, device, (-1,)),
        scene_min=_f32(scene_min, device), scene_max=_f32(scene_max, device),
        tri_cluster_aabb=_f32(cl_aabb, device, (-1, 6)),
        tri_cluster_range=_i32(cl_range, device, (-1, 2)),
        tri_uv=_f32(tri_uv, device),
        tri_tex=_i32(tri_tex, device),
        tex_atlas=_f32(tex_atlas, device),
        tex_size=_i32(tex_size, device, (-1, 2)),
        sph_ks=_f32(sph_legacy[:, 0:3], device),
        sph_refract=_f32(sph_legacy[:, 3], device),
        tri_ks=_f32(tri_legacy[:, 0:3], device),
        tri_refract=_f32(tri_legacy[:, 3], device),
    )
    scene.packed = pack_scene(scene, sph_clusters)
    return scene


def scene_from_jax_arrays(d: dict, device):
    """Carry a JAX-package Scene (and Camera) across unchanged.

    ``d`` maps each Scene field name to a numpy array, with Material
    sub-fields flattened as ``"sph_mtl.base_color"`` and the Camera fields
    as ``"camera.eye"`` etc.  The spheres keep their order, without a
    sphere index.  Returns ``(scene, camera)``; ``camera`` is None when
    ``d`` has no camera fields."""
    from ..ops.cuda_intersect import pack_scene

    def t(a):
        a = np.array(a)   # a writable copy
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a, device=device)

    kw = {}
    for f in dataclasses.fields(Scene):
        if f.name in ("sph_mtl", "tri_mtl"):
            kw[f.name] = Material(**{
                m.name: t(d[f"{f.name}.{m.name}"])
                for m in dataclasses.fields(Material)})
        elif f.name in d:
            kw[f.name] = t(d[f.name])
    scene = Scene(**kw)
    scene.packed = pack_scene(scene)
    cam = None
    if "camera.eye" in d:
        cam = Camera(**{f.name: t(d[f"camera.{f.name}"])
                        for f in dataclasses.fields(Camera)})
    return scene, cam
