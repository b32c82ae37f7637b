"""Nearest-hit and any-blocker kernels on packed scene tables
(counterpart of ``path_tracing_tpu.ops.pallas_intersect``).

``pack_scene`` builds the tables every kernel reads, column for column the
same as the JAX package's ``pack_scene``, once, when the scene is built
(``scene/types.py``): the scene carries them as ``scene.packed`` and every
frame takes them from there (``PackedScene.take``):

- spheres then light balls, ``(Ms, 16)``: ``[cx, cy, cz, r, blocks_gpu,
  blocks_cpu, 0, 0, r, g, b, roughness, metallic, eta, is_light, 0]``;
  light balls carry the oracle light material (flux, 1, 0, 0) and zero
  block flags, so they never block a shadow ray;
- triangles, ``(Mt, 24)``: ``[v0, v1, v2, blocks_gpu, blocks_cpu, 0,
  normal3, 0, r, g, b, roughness, metallic, eta, 0, 0]``;
- clusters, ``(Mc, 8)``: ``[min3, max3, start, count]``; from
  ``SUPER_MIN_CLUSTERS`` clusters on, ``super_table``'s: the rows padded to
  a multiple of ``SUPER`` and grown to 16 columns by each octant's
  front-to-back child order, beside the ``(NS, 16)`` super table the
  kernels walk first, as the JAX package's resident kernels do;
- triangle UVs, ``(Mt, 8)``: ``[u0, v0, u1, v1, u2, v2, tex, 0]`` with
  ``tex = -1`` for an untextured triangle (the JAX package's columns 24-30
  of its ``with_uv`` triangle table, kept apart here so the untextured
  sweeps keep their 24-column stride);
- the legacy shadow rows, ``(ns + nt, 4)``: ``[ks_r, ks_g, ks_b,
  refract]`` of sphere ``i`` at row ``i`` and of packed triangle ``j`` at
  row ``ns + j`` (the scene's cluster order), or ``(0, 4)`` for a scene
  without legacy Ks (the RGB shadow's tables; light balls have none);
- the sphere index, over the clusters ``bvh.build_sphere_clusters`` gave
  a scene of ``bvh.SPHERE_INDEX_MIN`` spheres or more (which the scene
  keeps cluster-contiguous): cluster rows over the spheres' rows in
  ``cl``'s layout, its super table in ``sup``'s, then one row ``[min3,
  max3, r_min, 0]`` of the index's bounds and the spheres' least radius
  (at least 1e-30), which ``sphere_pad`` reads; without one ``(0, 8)``
  and ``(0, 16)``, and every ray tests every sphere in turn;
- the lights, ``(Nl, 12)``: ``[pos3, dir3 (raw), illum3, cutoff,
  is_parallel, ball_r]``, which the bounce kernels read;

each padded with zero rows to a multiple of 8 (the legacy rows, the
sphere index's bounds row and the lights aside), and the scene's texture
atlas and sizes as they are (empty for an untextured scene).

Each kernel has a wrapper and a plain version side by side.  The wrapper
takes the plain version only for CPU tensors; for CUDA tensors it launches
the kernel of ``csrc/pt_kernels.cu`` or raises.  The plain sweeps are brute
force over ``(rays, primitives)`` and run in chunks of rays, so a mesh at
full lane count stays within device memory.  ``_count_nearest_walk`` and
``_count_shadow_walk`` are plain models of the kernels' walk (the flat
cluster list, or the supers then their children; the sphere index's boxes
grown by the ray's ``sphere_pad``), which the counting builds are held
to.  Every function takes ``live``, the lanes whose
result is read: the kernels walk only those, and the others get the miss
record (``nearest_hit``) or ``False`` (``any_blocker``), in the plain
versions too.  ``nearest_hit_counts`` and ``any_blocker_counts`` launch the
counting builds.

``transmittance_rgb`` is the RGB shadow of legacy-Ks scenes (the JAX
package's ``ops/intersect.py::transmittance_rgb``, which no Pallas kernel
computes): its kernel walks the resident tables as ``any_blocker`` does
but visits every occluder in the segment's window, multiplying its legacy
Ks in (refract > 0) or zeroing the factor (refract <= 0), and stops once
all three components are 0.  ``transmittance_rgb_plain`` is the JAX
package's brute-force fold, chunked as it chunks it; given ``counts`` it
also counts the kernel's walk (``_count_rgb_walk``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from ..profiling import count, span
from ..scene.types import Scene
from . import _kernels
from .intersect import (INF, SHADOW_EPS, mt_core, sphere_t_pairs,
                        sphere_ts, triangle_ts)
from .math3 import EPSILON, cross, dot, length
from .texture import interpolate_uv

SUB = 8
SPH_COLS, TRI_COLS, UV_COLS, CL_COLS = 16, 24, 8, 8
SUPER = 16                # clusters per super
SUPER_MIN_CLUSTERS = 64   # below this the flat cluster walk is used
SUP_COLS = 16
SENTINEL = 1e30
HIT_FIELDS = ("t", "nx", "ny", "nz", "bcr", "bcg", "bcb", "rough", "metal",
              "eta")
UV_FIELDS = ("iu", "iv", "tex")
# elements of one (rays, primitives) intermediate of a plain sweep
_PLAIN_CHUNK = 1 << 25


@dataclass
class ClusterTables:
    cl: torch.Tensor   # (Mc, 8), or (Mc, 16) with the super walk
    sup: torch.Tensor  # (NS, 16) super rows
    n_super: int       # super rows the walk visits (0: the flat walk)


@dataclass
class PackedScene:
    sph: torch.Tensor  # (Ms, 16) spheres then light balls
    tri: torch.Tensor  # (Mt, 24)
    uv: torch.Tensor   # (Mt, 8)
    cl: torch.Tensor   # (Mc, 8), or (Mc, 16) with the super walk
    atlas: torch.Tensor     # (NT, TH+1, TW+1, 3)
    tex_size: torch.Tensor  # (NT, 2) int32: h, w
    ns: int
    nl: int
    nt: int
    sup: torch.Tensor  # (NS, 16) super rows; (8, 16) zeros for the flat walk
    n_super: int       # super rows the walk visits (0: the flat walk)
    legacy: torch.Tensor  # (ns + nt, 4) ks3 refract, or (0, 4): none
    # the sphere index (see above): nsc cluster rows over sph[:ns]
    # as ``cl`` over the triangles, then its bounds row ((0, 8) and nsc 0
    # without an index), and its supers as ``sup``
    scl: torch.Tensor
    nsc: int
    ssup: torch.Tensor
    n_ssuper: int
    light: torch.Tensor   # (Nl, 12)

    @property
    def device(self) -> torch.device:
        return self.sph.device

    def take(self) -> "PackedScene":
        """These tables as a frame takes them: under a profiler the sphere
        index's counters gain what each ray reaches through it
        (``scene.spheres_indexed``) and tests in turn, the light balls
        (``scene.spheres_scanned``)."""
        if self.nsc:
            count("scene.spheres_indexed", self.ns)
            count("scene.spheres_scanned", self.nl)
        return self

    def with_illum(self, illum: torch.Tensor) -> "PackedScene":
        """These tables with the light flux ``illum`` (Nl, 3) in the
        light-ball rows and the lights (``pack_scene`` of the scene with
        that flux, bit for bit), the other tables shared."""
        sph, light = self.sph.clone(), self.light.clone()
        sph[self.ns:self.ns + self.nl, 8:11] = illum
        light[:, 6:9] = illum
        return dataclasses.replace(self, sph=sph, light=light)

    @property
    def textured(self) -> bool:
        return self.atlas.shape[0] > 0

    @property
    def sphere_walk(self) -> "ClusterTables":
        """The sphere index as ``walk_clusters`` walks it."""
        return ClusterTables(self.scl[:self.nsc], self.ssup, self.n_ssuper)

    @property
    def has_legacy(self) -> bool:
        return self.legacy.shape[0] > 0


def _rowpad(x: torch.Tensor, rows: int) -> torch.Tensor:
    pad = torch.zeros((rows - x.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def _padded_rows(n: int) -> int:
    return max(SUB, ((n + SUB - 1) // SUB) * SUB)


def _mtl_cols(m, n: int, dev) -> torch.Tensor:
    return torch.cat([m.base_color, m.roughness[:, None], m.metallic[:, None],
                      m.eta[:, None], torch.zeros((n, 1), device=dev)], 1)


def _octant_orders(ctr: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Eight stable argsort columns of the centroids' projections on
    (+-1, +-1, +-1) (octant bit 0: x, 1: y, 2: z), dead rows last; as f32
    (..., 8)."""
    orders = []
    for o in range(8):
        d = [1.0 if o & (1 << k) else -1.0 for k in range(3)]
        proj = ctr[..., 0] * d[0] + ctr[..., 1] * d[1] + ctr[..., 2] * d[2]
        proj = torch.where(alive, proj, torch.full_like(proj, 3e30))
        orders.append(torch.argsort(proj, dim=-1, stable=True).float())
    return torch.stack(orders, dim=-1)


def super_table(cl: torch.Tensor):
    """(cl padded to a SUPER multiple with its child orders, sup (NS, 16),
    use_super), as ``path_tracing_tpu.ops.pallas_intersect.super_table``:
    super rows ``[union_min3, union_max3, 0, child_count, order_oct0..7]``
    over SUPER consecutive cluster rows (empty children add sentinel
    bounds); cluster columns 8-15 hold, at the k-th row of a super's run,
    the relative index of its k-th child in each octant's front-to-back
    order.  Below SUPER_MIN_CLUSTERS: (cl, zeros (8, 16), False)."""
    dev = cl.device
    if cl.shape[0] < SUPER_MIN_CLUSTERS:
        return cl, torch.zeros((SUB, SUP_COLS), device=dev), False
    cl = _rowpad(cl, cl.shape[0] + (-cl.shape[0]) % SUPER)
    g = cl.shape[0] // SUPER
    valid = cl[:, 7:8] > 0
    mins = torch.where(valid, cl[:, 0:3], torch.full_like(cl[:, 0:3],
                                                          SENTINEL))
    maxs = torch.where(valid, cl[:, 3:6], torch.full_like(cl[:, 3:6],
                                                          -SENTINEL))
    sup = torch.cat([mins.reshape(g, SUPER, 3).amin(dim=1),
                     maxs.reshape(g, SUPER, 3).amax(dim=1),
                     torch.zeros((g, 1), device=dev),
                     cl[:, 7].reshape(g, SUPER).sum(dim=1, keepdim=True)], 1)
    sup = _rowpad(sup, g + (-g) % SUB)
    sup = torch.cat([sup, _octant_orders((sup[:, 0:3] + sup[:, 3:6]) * 0.5,
                                         sup[:, 7] > 0)], 1)
    corder = _octant_orders(
        ((cl[:, 0:3] + cl[:, 3:6]) * 0.5).reshape(g, SUPER, 3),
        (cl[:, 7] > 0).reshape(g, SUPER))
    return torch.cat([cl, corder.reshape(-1, 8)], 1), sup, True


def pack_scene(scene: Scene, sphere_clusters=None) -> PackedScene:
    """The tables of ``scene`` on its device (see above), with the sphere
    index over ``sphere_clusters``: boxes (M, 6) and ranges (M, 2) of
    ``bvh.build_sphere_clusters`` over the scene's spheres in their order
    (None: no index)."""
    ns, nl, nt = scene.num_spheres, scene.num_lights, scene.num_triangles
    dev = scene.device

    def z(n, k):
        return torch.zeros((n, k), device=dev)

    def o(n, k):
        return torch.ones((n, k), device=dev)

    sph = torch.cat([
        torch.cat([scene.sph_center, scene.sph_radius[:, None], o(ns, 1),
                   (scene.sph_mtl.eta <= 0.0).float()[:, None], z(ns, 2),
                   _mtl_cols(scene.sph_mtl, ns, dev), z(ns, 1)], 1),
        torch.cat([scene.light_pos, scene.light_ball_r[:, None], z(nl, 4),
                   scene.light_illum, o(nl, 1), z(nl, 2), o(nl, 1),
                   z(nl, 1)], 1),
    ], 0)
    tn = cross(scene.tri_v1 - scene.tri_v0, scene.tri_v2 - scene.tri_v0)
    tn = tn / torch.clamp(length(tn), min=1e-20)[:, None]
    tri = torch.cat([
        scene.tri_v0, scene.tri_v1, scene.tri_v2, o(nt, 1),
        (scene.tri_mtl.eta <= 0.0).float()[:, None], z(nt, 1), tn, z(nt, 1),
        _mtl_cols(scene.tri_mtl, nt, dev), z(nt, 1)], 1)

    textured = scene.has_textures and scene.tri_uv.shape[0] == nt
    uv6 = scene.tri_uv if textured else z(nt, 6)
    tex = (scene.tri_tex.float()[:, None] if textured
           else torch.full((nt, 1), -1.0, device=dev))
    uv = torch.cat([uv6, tex, z(nt, 1)], 1)
    atlas = (scene.tex_atlas if textured
             else torch.zeros((0, 1, 1, 3), device=dev))
    tex_size = (scene.tex_size.to(torch.int32) if textured
                else torch.zeros((0, 2), dtype=torch.int32, device=dev))

    cl = torch.cat([scene.tri_cluster_aabb,
                    scene.tri_cluster_range.float()], 1)
    cl, sup, use_super = super_table(_rowpad(cl, _padded_rows(cl.shape[0])))
    scl, ssup, nsc, n_ssuper = z(0, CL_COLS), z(0, SUP_COLS), 0, 0
    if sphere_clusters is not None:
        aabb, ranges = sphere_clusters
        scl, ssup, use = super_table(_rowpad(
            torch.cat([aabb, ranges.float()], 1),
            _padded_rows(aabb.shape[0])))
        nsc, n_ssuper = scl.shape[0], scl.shape[0] // SUPER if use else 0
        scl = torch.cat([scl, z(1, scl.shape[1])], 0)
        scl[-1, 0:7] = torch.cat([
            aabb[:, 0:3].amin(dim=0), aabb[:, 3:6].amax(dim=0),
            scene.sph_radius.amin().clamp(min=1e-30)[None]])
    legacy = z(0, 4)
    if scene.has_legacy_ks:
        legacy = torch.cat([
            torch.cat([scene.sph_ks, scene.sph_refract[:, None]], 1),
            torch.cat([scene.tri_ks, scene.tri_refract[:, None]], 1)], 0)
    light = torch.cat([
        scene.light_pos, scene.light_dir, scene.light_illum,
        scene.light_cutoff[:, None],
        scene.light_is_parallel.to(torch.float32)[:, None],
        scene.light_ball_r[:, None]], dim=1)
    return PackedScene(
        sph=_rowpad(sph, _padded_rows(ns + nl)).contiguous(),
        tri=_rowpad(tri, _padded_rows(nt)).contiguous(),
        uv=_rowpad(uv, _padded_rows(nt)).contiguous(), cl=cl.contiguous(),
        atlas=atlas.contiguous(), tex_size=tex_size.contiguous(),
        ns=ns, nl=nl, nt=nt, sup=sup.contiguous(),
        n_super=cl.shape[0] // SUPER if use_super else 0,
        legacy=legacy.contiguous(), scl=scl.contiguous(), nsc=nsc,
        ssup=ssup.contiguous(), n_ssuper=n_ssuper, light=light.contiguous())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _chunks(n_rays: int, n_prims: int):
    """Ray ranges of a plain sweep, each within ``_PLAIN_CHUNK`` elements."""
    step = max(1, _PLAIN_CHUNK // max(n_prims, 1))
    return [(a, min(a + step, n_rays))
            for a in range(0, n_rays, step)] or [(0, 0)]


def _slab_hit(box, ro, inv, tlo: float, tlimit, pad=None):
    """``csrc/pt_device.cuh::slab_hit`` on every ray: the ray enters the
    box ``box`` (>= 6,), or each ray its own row of ``box`` (R, >= 6),
    past ``tlo`` and before ``tlimit``; given each ray's ``pad``
    (``sphere_pad``'s (pad, k)), ``slab_hit_pad``'s: the box grown by the
    pad, for a wide ray (k > 0) by no more than k times the distance to
    the box's farthest corner."""
    lo, hi = box[..., 0:3], box[..., 3:6]
    if pad is not None:
        p, k = pad
        q = torch.maximum((ro - lo).abs(), (ro - hi).abs())
        own = k * torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                             + q[:, 2] * q[:, 2])
        p = torch.where(k > 0.0, torch.minimum(p, own), p)
        lo, hi = lo - p[:, None], hi + p[:, None]
    t0 = (lo - ro) * inv
    t1 = (hi - ro) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                       torch.maximum(lo[:, 2], lo.new_tensor(tlo)))
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (tn <= tf) & (tn < tlimit)


def _safe_inv(rd):
    return 1.0 / torch.where(torch.abs(rd) < 1e-12,
                             torch.where(rd >= 0.0, 1e-12, -1e-12), rd)


PAD_EPS = 2.0 ** -19   # pt_device.cuh::kPadEps


def sphere_pad(packed: PackedScene, ro, rd) -> tuple:
    """``csrc/pt_device.cuh::sphere_pad`` on every ray: (pad, k), each
    (R,), how much the sphere index's boxes grow for the ray, so that they
    hold every hit the sphere test's rounding reports (k > 0: a wide ray,
    whose boxes grow by no more than k times the distance to their
    farthest corner); the same float32 operations in the same order."""
    m = packed.scl[packed.nsc]
    q = torch.maximum((ro - m[0:3]).abs(), (ro - m[3:6]).abs())
    q2 = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
    eta = (rd[:, 0] * rd[:, 0] + rd[:, 1] * rd[:, 1] + rd[:, 2] * rd[:, 2]
           - 1.0).abs()
    coef = PAD_EPS + 4.0 * eta * (1.0 + eta)
    e = coef * q2
    pad = (torch.minimum(torch.sqrt(e), e / (2.0 * m[6]))
           + PAD_EPS * torch.sqrt(q2))
    return pad, torch.where(pad > m[6], torch.sqrt(coef) + PAD_EPS,
                            torch.zeros_like(pad))


def _octant(rd):
    """Each ray's octant (bit 0: x >= 0, 1: y, 2: z): its orders'
    column."""
    return ((rd[:, 0] >= 0).long() + 2 * (rd[:, 1] >= 0).long()
            + 4 * (rd[:, 2] >= 0).long())


def walk_clusters(packed, rd, enter_super, cluster, lanes=None) -> None:
    """The kernels' cluster walk (``csrc/pt_device.cuh::cluster_walk``) on
    every given ray (or the rays ``lanes`` of them) at once, a lane set
    per step: without supers,
    ``cluster(c, lanes)`` for every cluster row in table order; else, per
    octant, ``enter_super(box, lanes)`` (the lanes that enter the super's
    box) for each non-empty super in the octant's order, and the entered
    lanes' ``cluster(c, lanes)`` for its 16 children in their order.
    ``packed`` is resident or streamed: both carry ``cl``, ``sup`` and
    ``n_super``."""
    every = (torch.arange(rd.shape[0], device=rd.device) if lanes is None
             else lanes)
    if not packed.n_super:
        for c in range(packed.cl.shape[0]):
            cluster(c, every)
        return
    sup = packed.sup[:, 7:16].tolist()    # child count, 8 super orders
    child = packed.cl[:, 8:16].tolist()   # 8 child orders
    octant = _octant(rd[every])
    for o in range(8):
        lanes = every[octant == o]
        if not lanes.numel():
            continue
        for si in range(packed.n_super):
            s = int(sup[si][1 + o])
            if sup[s][0] <= 0:
                continue
            ent = enter_super(packed.sup[s], lanes)
            for k in range(SUPER if ent.numel() else 0):
                cluster(s * SUPER + int(child[s * SUPER + k][o]), ent)


def _count_nearest_walk(packed: PackedScene, ro, rd, counts: dict,
                        winner: bool = False, warp: bool = False):
    """A plain model of the kernels' nearest-hit walk (``nearest_hit_dev``)
    on every given ray.  Adds to ``counts`` every sphere and light ball
    tested in turn (the light balls alone with a sphere index), then, with
    an index, each of its boxes tested and every sphere of a box the ray
    enters before its running nearest t, then each triangle box tested
    (the supers', then the children's of an entered super; every non-empty
    cluster's without supers) and every triangle of a box the ray enters
    before its running nearest t.  Returns that t (INF on a miss): the
    brute force's, since culling never drops a closer hit; with
    ``winner`` also the row that won, strictly closer in the walk's order
    (a sphere's or light ball's row of ``sph``, or ``ns + nl`` plus a
    triangle's of ``tri``, as ``_nearest_rows`` numbers them; -1 on a
    miss).  With ``warp``, the index walks of the wide rays (``sphere_pad``'s
    k > 0) are #5's indexed instance's, each by its whole warp
    (``_warp_sphere_walk``), which also counts ``wide_walks`` and
    ``wide_steps``; the same t and row."""
    R, dev = ro.shape[0], ro.device
    a0 = packed.ns if packed.nsc else 0
    n_s = packed.ns + packed.nl - a0
    counts["hit_spheres"] += R * n_s
    t = torch.full((R,), INF, device=dev)
    row = torch.full((R,), -1, dtype=torch.long, device=dev)
    inv = _safe_inv(rd)
    pad = sphere_pad(packed, ro, rd) if packed.nsc else None

    def closer(lanes, ts, base):
        """The first of each lane's nearest tests, where strictly closer
        than the lane's running t."""
        tt, k = ts.min(dim=1)
        win = tt < t[lanes]
        t[lanes[win]] = tt[win]
        row[lanes[win]] = base + k[win]

    if n_s and R:
        lin = packed.sph[a0:a0 + n_s]
        closer(torch.arange(R, device=dev),
               sphere_ts(ro, rd, lin[:, 0:3], lin[:, 3], INF), a0)

    def enter(box, lanes, pad=None):
        counts["hit_boxes"] += lanes.numel()
        return lanes[_slab_hit(box, ro[lanes], inv[lanes], EPSILON, t[lanes],
                               None if pad is None
                               else (pad[0][lanes], pad[1][lanes]))]

    def visit(tab, test, base, pad=None):
        rows = tab[:, 6:8].tolist()

        def cluster(c, lanes):
            a, n = int(rows[c][0]), int(rows[c][1])
            if n <= 0 or not lanes.numel():
                return
            ent = enter(tab[c], lanes, pad)
            if ent.numel():
                closer(ent, test(ent, a, n), base + a)
        return cluster

    def spheres(ent, a, n):
        counts["hit_spheres"] += ent.numel() * n
        sph = packed.sph[a:a + n]
        return sphere_ts(ro[ent], rd[ent], sph[:, 0:3], sph[:, 3], INF)

    def triangles(ent, a, n):
        counts["hit_tris"] += ent.numel() * n
        tri = packed.tri[a:a + n]
        return triangle_ts(ro[ent], rd[ent], tri[:, 0:3], tri[:, 3:6],
                           tri[:, 6:9], INF)

    if packed.nsc:
        wide = (pad[1] > 0.0) if warp else torch.zeros_like(t, dtype=bool)
        walk_clusters(packed.sphere_walk, rd,
                      lambda box, lanes: enter(box, lanes, pad),
                      visit(packed.scl, spheres, 0, pad),
                      lanes=torch.nonzero(~wide)[:, 0])
        if warp:
            _warp_sphere_walk(packed, ro, rd, inv, pad, t, row,
                              torch.nonzero(wide)[:, 0], counts)
    walk_clusters(packed, rd, enter,
                  visit(packed.cl, triangles, packed.ns + packed.nl))
    return (t, row) if winner else t


def _warp_sphere_walk(packed: PackedScene, ro, rd, inv, pad, t, row, wide,
                      counts: dict) -> None:
    """A plain model of #5's warp walk of the sphere index
    (``csrc/pt_kernels.cu::warp_sphere_walk``) for the wide rays ``wide``,
    each walked as its warp walks it, all of them step by step at once:
    the octant's supers 32 a step, the entered supers' children two supers
    a step, the entered clusters' spheres two clusters a step, every box
    culled by the least t of the sphere steps before it.  Lowers ``t`` and
    sets ``row`` where a sphere is strictly closer (the least t, on a tie
    the first in walk order, as the lane walk finds it); adds each box and
    sphere tested to ``counts``, each ray to ``wide_walks`` and its steps
    to ``wide_steps``."""
    R, dev = wide.numel(), ro.device
    counts["wide_walks"] += R
    if not R:
        return
    ro, rd, inv, t0 = ro[wide], rd[wide], inv[wide], t[wide]
    pad = (pad[0][wide], pad[1][wide])
    lane = torch.arange(32, device=dev)
    low = lane < 16
    oct_ = _octant(rd)[:, None]
    scl = packed.scl
    run_t = t0.clone()                  # the warp's running t
    bt = t0[:, None].repeat(1, 32)      # each lane's least t
    brow = torch.full((R, 32), -1, dtype=torch.long, device=dev)
    bstep = torch.zeros((R, 32), dtype=torch.long, device=dev)
    step = torch.zeros(R, dtype=torch.long, device=dev)   # sphere steps

    def boxes(rays, tab, ids, valid):
        """One box step of ``rays``: lane l tests row ``ids[:, l]`` of
        ``tab`` where ``valid`` and the row is not empty; the entered."""
        valid = valid & (tab[ids.clamp(0, tab.shape[0] - 1), 7] > 0)
        counts["hit_boxes"] += int(valid.sum())
        counts["wide_steps"] += rays.numel()
        r, k = torch.nonzero(valid, as_tuple=True)
        g = rays[r]
        ent = torch.zeros_like(valid)
        ent[r, k] = _slab_hit(tab[ids[r, k]], ro[g], inv[g], EPSILON,
                              run_t[g], (pad[0][g], pad[1][g]))
        return ent

    def pairs(rays, ent, ids):
        """The entered items of each ray two at a time, in lane order:
        (the rays that have a j-th pair, their ids in lanes 0-15 and
        16-31, whether lanes 16-31 hold one) for each j."""
        n = ent.sum(dim=1)
        ids = torch.gather(ids, 1, torch.argsort((~ent).int(), dim=1,
                                                 stable=True))
        for j in range(0, int(n.max()) if n.numel() else 0, 2):
            sel = n > j
            two = n[sel] > j + 1
            a = ids[sel, j]
            b = torch.where(two, ids[sel, min(j + 1, 31)], a)
            yield rays[sel], torch.where(low, a[:, None], b[:, None]), \
                low | two[:, None]

    def spheres(rays, ent, cids):
        """The sphere steps of the entered clusters."""
        for rr, c, valid in pairs(rays, ent, cids):
            rows = scl[c]
            valid = valid & ((lane & 15) < rows[..., 7])
            i = torch.where(valid, rows[..., 6].long() + (lane & 15), 0)
            counts["hit_spheres"] += int(valid.sum())
            counts["wide_steps"] += rr.numel()
            s = packed.sph[i]
            ts = sphere_t_pairs(ro[rr][:, None], rd[rr][:, None], s[..., 0:3],
                                s[..., 3], INF)
            better = valid & (ts < bt[rr])
            bt[rr] = torch.where(better, ts, bt[rr])
            brow[rr] = torch.where(better, i, brow[rr])
            bstep[rr] = torch.where(better, step[rr][:, None], bstep[rr])
            step[rr] += 1
            run_t[rr] = bt[rr].amin(dim=1)

    every = torch.arange(R, device=dev)
    if packed.n_ssuper:
        for base in range(0, packed.n_ssuper, 32):
            si = base + lane
            valid = (si < packed.n_ssuper).expand(R, 32)
            s = torch.gather(packed.ssup[si.clamp(max=packed.n_ssuper - 1),
                                         8:16].long().expand(R, 32, 8), 2,
                             oct_[:, :, None].expand(R, 32, 1))[..., 0]
            for rr, sid, v in pairs(every, boxes(every, packed.ssup, s,
                                                 valid), s):
                first = sid * SUPER
                c = first + torch.gather(
                    scl[first + (lane & 15), 8:16].long(), 2,
                    oct_[rr][:, :, None].expand(-1, 32, 1))[..., 0]
                spheres(rr, boxes(rr, scl, c, v), c)
    else:
        for base in range(0, packed.nsc, 32):
            c = (base + lane).expand(R, 32)
            valid = c < packed.nsc
            spheres(every, boxes(every, scl, c, valid), c)
    tmin = bt.amin(dim=1)
    rank = torch.where((brow >= 0) & (bt == tmin[:, None]), bstep * 32 + lane,
                       torch.iinfo(torch.long).max)
    win = rank.argmin(dim=1)
    ok = brow[every, win] >= 0
    t[wide[ok]] = tmin[ok]
    row[wide[ok]] = brow[every, win][ok]


def _count_shadow_walk(packed: PackedScene, p1, rd, max_d, col: int,
                       counts: dict) -> torch.Tensor:
    """A plain model of the kernels' shadow walk (``shadow_blocked_dev``)
    on every given segment.  Adds to ``counts`` the blocking spheres in
    order up to the first that occludes (without a sphere index), or each
    box of the index the walk tests while the segment is unblocked and, in
    a box it enters, the blocking spheres in order up to the first that
    occludes; then, if none did, each triangle box the walk tests while
    the segment is unblocked and, in a cluster box it enters, the blocking
    triangles in order up to the first that occludes, which ends the walk.
    Returns the verdicts."""
    R, dev = p1.shape[0], p1.device
    blocked = torch.zeros(R, dtype=torch.bool, device=dev)

    def first(occ, cb):
        """The occluded lanes and the can-block tests up to the first."""
        hit = occ.any(dim=1)
        cbc = torch.cumsum(cb.long(), 0)
        return hit, int(torch.where(hit, cbc[torch.argmax(occ.int(), dim=1)],
                                    cbc[-1]).sum())

    if packed.ns and R and not packed.nsc:
        sph = packed.sph[:packed.ns]
        ts = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], max_d[:, None])
        cb = sph[:, col] > 0.0
        blocked, n = first((ts < INF) & (ts > SHADOW_EPS) & cb[None], cb)
        counts["shadow_spheres"] += n
    inv = _safe_inv(rd)
    pad = sphere_pad(packed, p1, rd) if packed.nsc else None

    def enter(box, lanes, pad=None):
        lanes = lanes[~blocked[lanes]]
        counts["shadow_boxes"] += lanes.numel()
        return lanes[_slab_hit(box, p1[lanes], inv[lanes], SHADOW_EPS,
                               max_d[lanes],
                               None if pad is None
                               else (pad[0][lanes], pad[1][lanes]))]

    def visit(tab, test, key, pad=None):
        rows = tab[:, 6:8].tolist()

        def cluster(c, lanes):
            a, n = int(rows[c][0]), int(rows[c][1])
            if n <= 0 or not lanes.numel():
                return
            ent = enter(tab[c], lanes, pad)
            if not ent.numel():
                return
            ts, cb = test(ent, a, n)
            hit, k = first((ts < INF) & (ts > SHADOW_EPS) & cb[None], cb)
            counts[key] += k
            blocked[ent[hit]] = True
        return cluster

    def spheres(ent, a, n):
        sph = packed.sph[a:a + n]
        return (sphere_ts(p1[ent], rd[ent], sph[:, 0:3], sph[:, 3],
                          max_d[ent][:, None]), sph[:, col] > 0.0)

    def triangles(ent, a, n):
        tri = packed.tri[a:a + n]
        return (triangle_ts(p1[ent], rd[ent], tri[:, 0:3], tri[:, 3:6],
                            tri[:, 6:9], max_d[ent][:, None]),
                tri[:, col + 5] > 0.0)

    if packed.nsc:
        walk_clusters(packed.sphere_walk, rd,
                      lambda box, lanes: enter(box, lanes, pad),
                      visit(packed.scl, spheres, "shadow_spheres", pad))
    walk_clusters(packed, rd, enter,
                  visit(packed.cl, triangles, "shadow_tris"))
    return blocked


def _miss_rows(B: int, with_uv: bool, device) -> dict:
    """B miss records: t = INF, normal, material and flag 0 (iu, iv 0 and
    tex -1 with ``with_uv``)."""
    zero = torch.zeros(B, device=device)
    out = {k: zero.clone() for k in HIT_FIELDS}
    out["t"] = torch.full((B,), INF, device=device)
    out["flag"] = torch.zeros(B, dtype=torch.int32, device=device)
    if with_uv:
        out.update(iu=zero.clone(), iv=zero.clone(), tex=zero - 1.0)
    return out


def _nearest_rows(packed: PackedScene, ro, rd, with_uv: bool) -> dict:
    n_s = packed.ns + packed.nl
    sph = packed.sph[:n_s]
    tri = packed.tri[:packed.nt]
    ts = [sphere_ts(ro, rd, sph[:, 0:3], sph[:, 3], INF)] if n_s else []
    if packed.nt:
        ts.append(triangle_ts(ro, rd, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                              INF))
    if not ts:
        return _miss_rows(ro.shape[0], with_uv, ro.device)
    all_t = torch.cat(ts, dim=1)
    idx = torch.argmin(all_t, dim=1)   # first minimum: the reference order
    best_t = torch.gather(all_t, 1, idx[:, None])[:, 0]
    hit = best_t < INF

    is_tri = idx >= n_s
    si = torch.clamp(idx, max=max(n_s - 1, 0))
    ti = torch.clamp(idx - n_s, min=0, max=max(packed.nt - 1, 0))
    srow = packed.sph[si]
    trow = packed.tri[ti]
    # sphere normal as the kernel forms it: (ro - c + rd t) / r
    inv_r = 1.0 / torch.clamp(srow[:, 3], min=1e-20)
    n_sph = ((ro - srow[:, 0:3]) + rd * best_t[:, None]) * inv_r[:, None]
    normal = torch.where(is_tri[:, None], trow[:, 12:15], n_sph)
    normal = torch.where((dot(normal, rd) > 0.0)[:, None], -normal, normal)
    mtl = torch.where(is_tri[:, None], trow[:, 16:22], srow[:, 8:14])
    flag = torch.where(is_tri | (srow[:, 14] <= 0.0),
                       torch.ones_like(idx), torch.full_like(idx, 2))
    flag = torch.where(hit, flag, torch.zeros_like(flag)).to(torch.int32)

    keep = hit[:, None]
    normal = torch.where(keep, normal, torch.zeros_like(normal))
    mtl = torch.where(keep, mtl, torch.zeros_like(mtl))
    out = {"t": torch.where(hit, best_t, torch.full_like(best_t, INF))}
    for i, k in enumerate(("nx", "ny", "nz")):
        out[k] = normal[:, i]
    for i, k in enumerate(("bcr", "bcg", "bcb", "rough", "metal", "eta")):
        out[k] = mtl[:, i]
    out["flag"] = flag
    if with_uv:
        # the winner's barycentrics, by the same Moller-Trumbore arithmetic
        # on its own row, interpolated as the kernel does
        def xyz(a):
            return tuple(a[:, k] for k in range(3))

        _, bu, bv, _ = mt_core(xyz(ro), xyz(rd), xyz(trow[:, 0:3]),
                               xyz(trow[:, 3:6]), xyz(trow[:, 6:9]))
        uvt = interpolate_uv(packed.uv[ti, 0:6], bu, bv)
        tri_hit = hit & is_tri
        zero = torch.zeros_like(best_t)
        out["iu"] = torch.where(tri_hit, uvt[:, 0], zero)
        out["iv"] = torch.where(tri_hit, uvt[:, 1], zero)
        out["tex"] = torch.where(tri_hit, packed.uv[ti, 6], zero - 1.0)
    return out


def nearest_hit_plain(packed: PackedScene, ro: torch.Tensor,
                      rd: torch.Tensor, with_uv: bool = False,
                      live=None, counts: dict | None = None,
                      warp_walk: bool = False) -> dict:
    """Brute-force nearest hit on the packed tables.  Returns (B,) fields
    t, normal (flipped toward the ray), material and flag (0 miss,
    1 surface, 2 light ball); misses report t = INF and zeros.
    ``with_uv`` adds the winning triangle's interpolated ``iu``, ``iv``
    and its texture id ``tex`` (float; 0, 0, -1 off triangles).  ``live``
    (B,) bool, the lanes whose result is read: the others get the miss
    record, as the kernel writes it (every lane without it).  ``counts``
    (from ``cuda_connect.new_counts``), if given, gains the primitive
    tests the kernels' walk makes for the live lanes; with ``warp_walk``
    (``cuda_wavefront.new_counts``) those of #5's indexed instance, which
    walks a wide ray's index by the warp (``_count_nearest_walk``)."""
    _kernels.plain_calls["nearest_hit"] += 1
    if live is None:
        return _nearest_all(packed, ro, rd, with_uv, counts, warp_walk)
    out = _miss_rows(ro.shape[0], with_uv, ro.device)
    for k, x in _nearest_all(packed, ro[live], rd[live], with_uv,
                             counts, warp_walk).items():
        out[k][live] = x
    return out


def _nearest_all(packed: PackedScene, ro, rd, with_uv: bool, counts,
                 warp_walk: bool = False):
    """``nearest_hit_plain`` on every given lane, in chunks of rays."""
    if counts is not None:
        _count_nearest_walk(packed, ro, rd, counts, warp=warp_walk)
    parts = [_nearest_rows(packed, ro[a:b], rd[a:b], with_uv)
             for a, b in _chunks(ro.shape[0], packed.ns + packed.nl
                                 + packed.nt)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _blocked_rows(packed: PackedScene, p1, rd, max_d, col: int):
    md = max_d[:, None]
    blocked = torch.zeros(p1.shape[0], dtype=torch.bool, device=p1.device)
    if packed.nt:
        tri = packed.tri[:packed.nt]
        t = triangle_ts(p1, rd, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], md)
        blocked |= torch.any((t < INF) & (t > SHADOW_EPS)
                             & (tri[:, col + 5] > 0.0)[None], dim=1)
    if packed.ns:
        sph = packed.sph[:packed.ns]
        t = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], md)
        blocked |= torch.any((t < INF) & (t > SHADOW_EPS)
                             & (sph[:, col] > 0.0)[None], dim=1)
    return blocked


def any_blocker_plain(packed: PackedScene, p1: torch.Tensor,
                      rd: torch.Tensor, max_d: torch.Tensor,
                      dielectrics_block: bool, live=None,
                      counts: dict | None = None) -> torch.Tensor:
    """Brute-force shadow any-hit: (B,) bool, True where a sphere or
    triangle whose can-block column is set lies at t in (1e-3, max_d).
    ``live`` (B,) bool: the other lanes are unblocked, as the kernel
    writes them.  ``counts``, if given, gains the primitive tests the
    kernels' walk makes for the live lanes (every lane without ``live``),
    and the verdicts come from that walk's model, which finds the brute
    force's (culling never changes a verdict)."""
    _kernels.plain_calls["any_blocker"] += 1
    col = 4 if dielectrics_block else 5
    if live is None:
        return _blocked_all(packed, p1, rd, max_d, col, counts)
    out = torch.zeros(p1.shape[0], dtype=torch.bool, device=p1.device)
    out[live] = _blocked_all(packed, p1[live], rd[live], max_d[live], col,
                             counts)
    return out


def _blocked_all(packed: PackedScene, p1, rd, max_d, col: int, counts):
    """``any_blocker_plain`` on every given lane: the walk model's
    verdicts given ``counts``, else the brute force in chunks of rays."""
    if counts is not None:
        return _count_shadow_walk(packed, p1, rd, max_d, col, counts)
    return torch.cat([
        _blocked_rows(packed, p1[a:b], rd[a:b], max_d[a:b], col)
        for a, b in _chunks(p1.shape[0], packed.ns + packed.nt)])


def _fold_factors(rows: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Per (ray, occluder) the RGB factor ``1 - occ (1 - ks)`` of legacy
    rows (N, 4) (``ks`` = Ks where refract > 0, else 0): (R, N, 3)."""
    ks = torch.where(rows[:, 3:4] > 0.0, rows[:, 0:3],
                     torch.zeros_like(rows[:, 0:3]))
    return 1.0 - occ.to(torch.float32)[..., None] * (1.0 - ks)[None]


def _rgb_rows(packed: PackedScene, p1, rd, max_d) -> torch.Tensor:
    """The JAX package's ``_transmittance_rgb_block`` on packed tables:
    the product over the triangles in table order, then the spheres."""
    md = max_d[:, None]
    trans = torch.ones((p1.shape[0], 3), device=p1.device)
    ns, nt = packed.ns, packed.nt
    if nt:
        tri = packed.tri[:nt]
        t = triangle_ts(p1, rd, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], md)
        trans = trans * torch.prod(_fold_factors(
            packed.legacy[ns:ns + nt], (t < INF) & (t > SHADOW_EPS)), dim=1)
    if ns:
        sph = packed.sph[:ns]
        t = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], md)
        trans = trans * torch.prod(_fold_factors(
            packed.legacy[:ns], (t < INF) & (t > SHADOW_EPS)), dim=1)
    return trans


def _count_rgb_walk(packed: PackedScene, p1, rd, max_d, counts: dict
                    ) -> None:
    """A plain model of the RGB shadow walk (``shadow_rgb_dev``) on every
    given segment.  Adds to ``counts`` every sphere; then each box the
    walk tests while some component of the segment's factor is not 0 and,
    in a cluster box it enters, the triangles in order up to the one after
    which every component is 0, which ends the walk.  A component is 0
    once an occluder's factor in it is 0 (an opaque occluder, or Ks 0)."""
    R = p1.shape[0]
    zero = torch.zeros((R, 3), dtype=torch.bool, device=p1.device)
    ns, nt = packed.ns, packed.nt
    if ns and R:
        counts["shadow_spheres"] += R * ns
        sph = packed.sph[:ns]
        ts = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], max_d[:, None])
        f = _fold_factors(packed.legacy[:ns], (ts < INF) & (ts > SHADOW_EPS))
        zero = (f == 0.0).any(dim=1)
    inv = _safe_inv(rd)
    rows = packed.cl[:, 6:8].tolist()

    def enter(box, lanes):
        lanes = lanes[~zero[lanes].all(dim=1)]
        counts["shadow_boxes"] += lanes.numel()
        return lanes[_slab_hit(box, p1[lanes], inv[lanes], SHADOW_EPS,
                               max_d[lanes])]

    def cluster(c, lanes):
        a, n = int(rows[c][0]), int(rows[c][1])
        if n <= 0 or not lanes.numel():
            return
        ent = enter(packed.cl[c], lanes)
        if not ent.numel():
            return
        tri = packed.tri[a:a + n]
        tt = triangle_ts(p1[ent], rd[ent], tri[:, 0:3], tri[:, 3:6],
                         tri[:, 6:9], max_d[ent][:, None])
        f = _fold_factors(packed.legacy[ns + a:ns + a + n],
                          (tt < INF) & (tt > SHADOW_EPS))
        z = torch.cummax(((f == 0.0) | zero[ent][:, None]).int(),
                         dim=1).values.bool()                    # (E, n, 3)
        done = z.all(dim=2)
        hit = done.any(dim=1)
        counts["shadow_tris"] += int(torch.where(
            hit, torch.argmax(done.int(), dim=1) + 1,
            torch.full_like(hit, n, dtype=torch.int64)).sum())
        zero[ent] = z[:, -1]

    walk_clusters(packed, rd, enter, cluster)


def transmittance_rgb_plain(packed: PackedScene, p1: torch.Tensor,
                            rd: torch.Tensor, max_d: torch.Tensor,
                            live=None, counts: dict | None = None
                            ) -> torch.Tensor:
    """Plain version of the ``transmittance_rgb`` kernel: the JAX package's
    brute-force fold (``_rgb_rows``) in ray chunks of ``max(8, min(65536,
    2**24 // (nt + ns)))``, as its ``transmittance_rgb`` chunks them.
    (B, 3); lanes that are not ``live`` get 1.  ``counts``, if given,
    gains the tests of the kernel's walk for the live lanes
    (``_count_rgb_walk``)."""
    _kernels.plain_calls["transmittance_rgb"] += 1
    if not packed.has_legacy:
        raise ValueError("transmittance_rgb: the scene has no legacy rows")
    out = torch.ones((p1.shape[0], 3), device=p1.device)
    sel = (torch.arange(p1.shape[0], device=p1.device) if live is None
           else torch.nonzero(live)[:, 0])
    q1, qd, qm = p1[sel], rd[sel], max_d[sel]
    if counts is not None:
        _count_rgb_walk(packed, q1, qd, qm, counts)
    chunk = max(8, min(65536, (1 << 24) // max(packed.nt + packed.ns, 1)))
    for a in range(0, sel.shape[0], chunk):
        out[sel[a:a + chunk]] = _rgb_rows(packed, q1[a:a + chunk],
                                          qd[a:a + chunk], qm[a:a + chunk])
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_tensor(name: str, x: torch.Tensor, shape, dtype=torch.float32):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_tables(packed: PackedScene, device):
    if packed.device != device:
        raise ValueError(f"scene tables on {packed.device}, rays on {device}")
    check_tensor("sph", packed.sph, (packed.sph.shape[0], SPH_COLS))
    check_tensor("tri", packed.tri, (packed.tri.shape[0], TRI_COLS))
    check_tensor("uv", packed.uv, (packed.tri.shape[0], UV_COLS))
    check_tensor("cl", packed.cl, (packed.cl.shape[0],
                                   2 * CL_COLS if packed.n_super else CL_COLS))
    check_tensor("sup", packed.sup, (max(packed.sup.shape[0],
                                         packed.n_super), SUP_COLS))
    check_tensor("scl", packed.scl, (packed.nsc + (packed.nsc > 0),
                                     2 * CL_COLS if packed.n_ssuper
                                     else CL_COLS))
    check_tensor("ssup", packed.ssup, (max(packed.ssup.shape[0],
                                           packed.n_ssuper), SUP_COLS))
    for nm, x in (("cl", packed.cl), ("sup", packed.sup),
                  ("scl", packed.scl), ("ssup", packed.ssup)):
        if x.data_ptr() % 16:   # the slab test reads a box as two float4
            raise ValueError(f"{nm}: rows must start 16-byte aligned")


def camera_table(cam, device) -> torch.Tensor:
    """The (12,) float32 table of the kernels that cast primary rays: eye,
    ul, dx, dy on ``device``.  A camera on the host makes it a blocking copy
    to the card (``sync.cam_tab``)."""
    tab = torch.cat([cam.eye, cam.ul, cam.dx, cam.dy])
    if tab.device == device:
        return tab.to(dtype=torch.float32).contiguous()
    with span("sync.cam_tab"):
        return tab.to(device=device, dtype=torch.float32).contiguous()


def table_args(packed: PackedScene):
    """ctypes arguments of the scene tables, as every kernel takes them."""
    return [ctypes.c_void_p(packed.sph.data_ptr()), packed.ns, packed.nl,
            ctypes.c_void_p(packed.tri.data_ptr()),
            ctypes.c_void_p(packed.uv.data_ptr()),
            ctypes.c_void_p(packed.cl.data_ptr()), packed.cl.shape[0],
            ctypes.c_void_p(packed.sup.data_ptr()), packed.n_super,
            ctypes.c_void_p(packed.scl.data_ptr()), packed.nsc,
            ctypes.c_void_p(packed.ssup.data_ptr()), packed.n_ssuper]


def _live_arg(live, B: int):
    """The ctypes argument of a lane mask: null (every lane) or a
    contiguous (B,) bool tensor's pointer."""
    if live is None:
        return ctypes.c_void_p(None)
    check_tensor("live", live, (B,), torch.bool)
    return ctypes.c_void_p(live.data_ptr())


def nearest_hit(packed: PackedScene, ro: torch.Tensor, rd: torch.Tensor,
                with_uv: bool = False, live=None) -> dict:
    """Nearest hit per ray; same fields as :func:`nearest_hit_plain`,
    lanes that are not ``live`` with the miss record."""
    if ro.device.type == "cpu" and rd.device.type == "cpu":
        return nearest_hit_plain(packed, ro, rd, with_uv, live)
    return _launch_hit("nearest_hit", packed, ro, rd, with_uv, live)


def nearest_hit_counts(packed: PackedScene, ro: torch.Tensor,
                       rd: torch.Tensor, with_uv: bool = False,
                       live=None) -> tuple:
    """``nearest_hit`` through the kernel's counting build: (the same
    fields, its counters as a dict keyed by ``cuda_connect.COUNT_NAMES``:
    the walk's sphere, box and triangle tests, as ``nearest_hit_plain``
    counts them given ``counts=``).  CUDA tensors only."""
    from .cuda_connect import counts_buffer, read_counts

    buf = counts_buffer(ro.device)
    out = _launch_hit("nearest_hit_counts", packed, ro, rd, with_uv, live,
                      buf)
    return out, read_counts(buf)


def _launch_hit(name: str, packed, ro, rd, with_uv: bool, live,
                counts=None) -> dict:
    B = ro.shape[0]
    check_tensor("ro", ro, (B, 3))
    check_tensor("rd", rd, (B, 3))
    check_tables(packed, ro.device)
    fields = HIT_FIELDS + (UV_FIELDS if with_uv else ())
    out = torch.empty((len(fields), B), device=ro.device)
    flag = torch.empty(B, dtype=torch.int32, device=ro.device)
    mask = _live_arg(live, B)
    if B:
        _kernels.launch(name, *table_args(packed), int(with_uv),
                        ctypes.c_void_p(ro.data_ptr()),
                        ctypes.c_void_p(rd.data_ptr()), mask, B,
                        ctypes.c_void_p(out.data_ptr()),
                        ctypes.c_void_p(flag.data_ptr()),
                        *_counts_arg(counts))
    res = {k: out[i] for i, k in enumerate(fields)}
    res["flag"] = flag
    return res


def any_blocker(packed: PackedScene, p1: torch.Tensor, rd: torch.Tensor,
                max_d: torch.Tensor, dielectrics_block: bool, live=None
                ) -> torch.Tensor:
    """Shadow any-hit per ray; (B,) bool like :func:`any_blocker_plain`,
    lanes that are not ``live`` unblocked."""
    if all(x.device.type == "cpu" for x in (p1, rd, max_d)):
        return any_blocker_plain(packed, p1, rd, max_d, dielectrics_block,
                                 live)
    return _launch_blocker("any_blocker", packed, p1, rd, max_d,
                           dielectrics_block, live)


def any_blocker_counts(packed: PackedScene, p1: torch.Tensor,
                       rd: torch.Tensor, max_d: torch.Tensor,
                       dielectrics_block: bool, live=None) -> tuple:
    """``any_blocker`` through the kernel's counting build: (the same
    verdicts, its counters as a dict keyed by ``cuda_connect.COUNT_NAMES``:
    the walk's sphere, box and triangle tests up to the first blocker, as
    ``any_blocker_plain`` counts them given ``counts=``).  CUDA tensors
    only."""
    from .cuda_connect import counts_buffer, read_counts

    buf = counts_buffer(p1.device)
    out = _launch_blocker("any_blocker_counts", packed, p1, rd, max_d,
                          dielectrics_block, live, buf)
    return out, read_counts(buf)


def _launch_blocker(name: str, packed, p1, rd, max_d,
                    dielectrics_block: bool, live, counts=None
                    ) -> torch.Tensor:
    B = p1.shape[0]
    check_tensor("p1", p1, (B, 3))
    check_tensor("rd", rd, (B, 3))
    check_tensor("max_d", max_d, (B,))
    check_tables(packed, p1.device)
    out = torch.empty(B, dtype=torch.bool, device=p1.device)
    mask = _live_arg(live, B)
    if B:
        _kernels.launch(name, *table_args(packed),
                        ctypes.c_void_p(p1.data_ptr()),
                        ctypes.c_void_p(rd.data_ptr()),
                        ctypes.c_void_p(max_d.data_ptr()), mask, B,
                        4 if dielectrics_block else 5,
                        ctypes.c_void_p(out.data_ptr()),
                        *_counts_arg(counts))
    return out


def transmittance_rgb(packed: PackedScene, p1: torch.Tensor,
                      rd: torch.Tensor, max_d: torch.Tensor, live=None
                      ) -> torch.Tensor:
    """RGB shadow transmittance per segment, (B, 3) like
    :func:`transmittance_rgb_plain`, lanes that are not ``live`` 1."""
    if all(x.device.type == "cpu" for x in (p1, rd, max_d)):
        return transmittance_rgb_plain(packed, p1, rd, max_d, live)
    B = p1.shape[0]
    check_tensor("p1", p1, (B, 3))
    check_tensor("rd", rd, (B, 3))
    check_tensor("max_d", max_d, (B,))
    check_tables(packed, p1.device)
    check_legacy(packed)
    out = torch.empty((B, 3), device=p1.device)
    mask = _live_arg(live, B)
    if B:
        _kernels.launch("transmittance_rgb", *table_args(packed),
                        ctypes.c_void_p(packed.legacy.data_ptr()),
                        ctypes.c_void_p(p1.data_ptr()),
                        ctypes.c_void_p(rd.data_ptr()),
                        ctypes.c_void_p(max_d.data_ptr()), mask, B,
                        ctypes.c_void_p(out.data_ptr()))
    return out


def check_legacy(packed: PackedScene) -> None:
    """The legacy rows a kernel's RGB shadow reads: (ns + nt, 4), 16-byte
    aligned (a row is read as one float4)."""
    if not packed.has_legacy:
        raise ValueError("the RGB shadow needs a scene with legacy Ks rows")
    check_tensor("legacy", packed.legacy, (packed.ns + packed.nt, 4))
    if packed.legacy.data_ptr() % 16:
        raise ValueError("legacy: rows must start 16-byte aligned")


def atlas_args(packed: PackedScene) -> list:
    """The texture atlas's ctypes arguments (atlas, sizes, NT, TH+1,
    TW+1), checked: the textured kernels' (#4, #10's textured instance)."""
    at = packed.atlas
    if not packed.textured or at.dim() != 4 or at.shape[3] != 3:
        raise ValueError(f"expected a (NT > 0, TH+1, TW+1, 3) texture "
                         f"atlas, got {tuple(at.shape)}")
    check_tensor("atlas", at, tuple(at.shape))
    check_tensor("tex_size", packed.tex_size, (at.shape[0], 2), torch.int32)
    return [ctypes.c_void_p(at.data_ptr()),
            ctypes.c_void_p(packed.tex_size.data_ptr()), at.shape[0],
            at.shape[1], at.shape[2]]


def _counts_arg(counts) -> list:
    return [] if counts is None else [ctypes.c_void_p(counts.data_ptr())]


def occupancy() -> dict:
    """Per build of #1 and #2 (their flat-walk instances): resident blocks
    and warps per SM, threads per block, registers and local (spill)
    bytes per thread, shared bytes."""
    names = ("nearest_hit", "nearest_hit_counts", "any_blocker",
             "any_blocker_counts")
    out = (ctypes.c_int * (5 * len(names)))()
    fn = _kernels.library().libs["pt_kernels"].pt_hit_occupancy
    fn.argtypes = [ctypes.c_void_p]
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"pt_hit_occupancy failed: cudaError {rc}")
    return _kernels.occupancy_rows(names, out)
