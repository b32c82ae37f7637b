"""Nearest-hit and any-blocker kernels on packed scene tables
(counterpart of ``path_tracing_tpu.ops.pallas_intersect``).

``pack_scene`` builds the tables every kernel reads, column for column the
same as the JAX package's ``pack_scene``:

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

each padded with zero rows to a multiple of 8, and the scene's texture
atlas and sizes as they are.

The plain versions of the nearest-hit and any-blocker kernels are brute
force over ``(rays, primitives)`` and run in chunks of rays, so a mesh at
full lane count stays within device memory.  ``_count_nearest_walk`` and
``_count_shadow_walk`` are plain models of the kernels' walk (the flat
cluster list, or the supers then their children), which count the work
the rooflines are bounded by.  Both take ``live``, the lanes whose result
is read: the others get the miss record (nearest hit) or ``False``
(any-blocker), as the kernels write them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene.types import Scene
from .intersect import INF, SHADOW_EPS, mt_core, sphere_ts, triangle_ts
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

    @property
    def textured(self) -> bool:
        return self.atlas.shape[0] > 0


def _rowpad(x: torch.Tensor, rows: int) -> torch.Tensor:
    pad = torch.zeros((rows - x.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def _padded_rows(n: int) -> int:
    return max(SUB, ((n + SUB - 1) // SUB) * SUB)


def _mtl_cols(m, n: int, dev) -> torch.Tensor:
    return torch.cat([m.base_color, m.roughness[:, None], m.metallic[:, None],
                      m.eta[:, None], torch.zeros((n, 1), device=dev)], 1)


def sphere_table(scene: Scene) -> torch.Tensor:
    """The ``(Ms, 16)`` table of spheres then light balls (see above)."""
    ns, nl, dev = scene.num_spheres, scene.num_lights, scene.device

    def z(n, k):
        return torch.zeros((n, k), device=dev)

    def o(n, k):
        return torch.ones((n, k), device=dev)

    sph_rows = torch.cat([
        torch.cat([scene.sph_center, scene.sph_radius[:, None], o(ns, 1),
                   (scene.sph_mtl.eta <= 0.0).float()[:, None], z(ns, 2),
                   _mtl_cols(scene.sph_mtl, ns, dev), z(ns, 1)], 1),
        torch.cat([scene.light_pos, scene.light_ball_r[:, None], z(nl, 4),
                   scene.light_illum, o(nl, 1), z(nl, 2), o(nl, 1),
                   z(nl, 1)], 1),
    ], 0)
    return _rowpad(sph_rows, _padded_rows(ns + nl)).contiguous()


def is_textured(scene: Scene) -> bool:
    return scene.has_textures and scene.tri_uv.shape[0] == scene.num_triangles


def texture_tables(scene: Scene):
    """The atlas and its (h, w) sizes, empty for an untextured scene."""
    dev = scene.device
    if not is_textured(scene):
        return (torch.zeros((0, 1, 1, 3), device=dev),
                torch.zeros((0, 2), dtype=torch.int32, device=dev))
    return (scene.tex_atlas.contiguous(),
            scene.tex_size.to(torch.int32).contiguous())


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


def pack_scene(scene: Scene) -> PackedScene:
    ns, nl, nt = scene.num_spheres, scene.num_lights, scene.num_triangles
    dev = scene.device

    def z(n, k):
        return torch.zeros((n, k), device=dev)

    def o(n, k):
        return torch.ones((n, k), device=dev)

    sph = sphere_table(scene)
    tn = cross(scene.tri_v1 - scene.tri_v0, scene.tri_v2 - scene.tri_v0)
    tn = tn / torch.clamp(length(tn), min=1e-20)[:, None]
    tri_rows = torch.cat([
        scene.tri_v0, scene.tri_v1, scene.tri_v2, o(nt, 1),
        (scene.tri_mtl.eta <= 0.0).float()[:, None], z(nt, 1), tn, z(nt, 1),
        _mtl_cols(scene.tri_mtl, nt, dev), z(nt, 1)], 1)
    tri = _rowpad(tri_rows, _padded_rows(nt))

    textured = is_textured(scene)
    uv6 = scene.tri_uv if textured else z(nt, 6)
    tex = (scene.tri_tex.float()[:, None] if textured
           else torch.full((nt, 1), -1.0, device=dev))
    uv = _rowpad(torch.cat([uv6, tex, z(nt, 1)], 1), _padded_rows(nt))

    cl = torch.cat([scene.tri_cluster_aabb,
                    scene.tri_cluster_range.float()], 1)
    cl, sup, use_super = super_table(_rowpad(cl, _padded_rows(cl.shape[0])))
    atlas, tex_size = texture_tables(scene)
    return PackedScene(sph=sph, tri=tri.contiguous(),
                       uv=uv.contiguous(), cl=cl.contiguous(),
                       atlas=atlas, tex_size=tex_size, ns=ns, nl=nl, nt=nt,
                       sup=sup.contiguous(),
                       n_super=cl.shape[0] // SUPER if use_super else 0)


def _chunks(n_rays: int, n_prims: int):
    """Ray ranges of a plain sweep, each within ``_PLAIN_CHUNK`` elements."""
    step = max(1, _PLAIN_CHUNK // max(n_prims, 1))
    return [(a, min(a + step, n_rays))
            for a in range(0, n_rays, step)] or [(0, 0)]


def _slab_hit(box, ro, inv, tlo: float, tlimit):
    """``csrc/pt_device.cuh::slab_hit`` on every ray: the ray enters the
    box ``box`` (>= 6,) past ``tlo`` and before ``tlimit``."""
    t0 = (box[0:3] - ro) * inv
    t1 = (box[3:6] - ro) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                       torch.maximum(lo[:, 2], lo.new_tensor(tlo)))
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (tn <= tf) & (tn < tlimit)


def _safe_inv(rd):
    return 1.0 / torch.where(torch.abs(rd) < 1e-12,
                             torch.where(rd >= 0.0, 1e-12, -1e-12), rd)


def walk_clusters(packed, rd, enter_super, cluster) -> None:
    """The kernels' cluster walk (``csrc/pt_device.cuh::cluster_walk``) on
    every given ray at once, a lane set per step: without supers,
    ``cluster(c, lanes)`` for every cluster row in table order; else, per
    octant, ``enter_super(box, lanes)`` (the lanes that enter the super's
    box) for each non-empty super in the octant's order, and the entered
    lanes' ``cluster(c, lanes)`` for its 16 children in their order.
    ``packed`` is resident or streamed: both carry ``cl``, ``sup`` and
    ``n_super``."""
    every = torch.arange(rd.shape[0], device=rd.device)
    if not packed.n_super:
        for c in range(packed.cl.shape[0]):
            cluster(c, every)
        return
    sup = packed.sup[:, 7:16].tolist()    # child count, 8 super orders
    child = packed.cl[:, 8:16].tolist()   # 8 child orders
    # each ray's octant (bit 0: x >= 0, 1: y, 2: z): its orders' column
    octant = ((rd[:, 0] >= 0).long() + 2 * (rd[:, 1] >= 0).long()
              + 4 * (rd[:, 2] >= 0).long())
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


def _count_nearest_walk(packed: PackedScene, ro, rd, counts: dict
                        ) -> torch.Tensor:
    """A plain model of the kernels' nearest-hit walk (``nearest_hit_dev``)
    on every given ray.  Adds to ``counts`` every sphere and light ball,
    each box tested (the supers', then the children's of an entered super;
    every non-empty cluster's without supers) and every triangle of a box
    the ray enters before its running nearest t.  Returns that t (INF on a
    miss): the brute force's, since culling never drops a closer hit."""
    R, dev = ro.shape[0], ro.device
    n_s = packed.ns + packed.nl
    counts["hit_spheres"] += R * n_s
    t = (sphere_ts(ro, rd, packed.sph[:n_s, 0:3], packed.sph[:n_s, 3],
                   INF).amin(dim=1) if n_s and R
         else torch.full((R,), INF, device=dev))
    inv = _safe_inv(rd)
    rows = packed.cl[:, 6:8].tolist()

    def enter(box, lanes):
        counts["hit_boxes"] += lanes.numel()
        return lanes[_slab_hit(box, ro[lanes], inv[lanes], EPSILON, t[lanes])]

    def cluster(c, lanes):
        a, n = int(rows[c][0]), int(rows[c][1])
        if n <= 0 or not lanes.numel():
            return
        ent = enter(packed.cl[c], lanes)
        if not ent.numel():
            return
        counts["hit_tris"] += ent.numel() * n
        tri = packed.tri[a:a + n]
        tt = triangle_ts(ro[ent], rd[ent], tri[:, 0:3], tri[:, 3:6],
                         tri[:, 6:9], INF).amin(dim=1)
        t[ent] = torch.minimum(t[ent], tt)

    walk_clusters(packed, rd, enter, cluster)
    return t


def _count_shadow_walk(packed: PackedScene, p1, rd, max_d, col: int,
                       counts: dict) -> torch.Tensor:
    """A plain model of the kernels' shadow walk (``shadow_blocked_dev``)
    on every given segment.  Adds to ``counts`` the blocking spheres in
    order up to the first that occludes; then, if none did, each box the
    walk tests while the segment is unblocked and, in a cluster box it
    enters, the blocking triangles in order up to the first that occludes,
    which ends the walk.  Returns the verdicts."""
    R, dev = p1.shape[0], p1.device
    blocked = torch.zeros(R, dtype=torch.bool, device=dev)
    if packed.ns and R:
        sph = packed.sph[:packed.ns]
        ts = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], max_d[:, None])
        occ = (ts < INF) & (ts > SHADOW_EPS) & (sph[:, col] > 0.0)[None]
        cb = torch.cumsum((sph[:, col] > 0.0).long(), 0)
        blocked = occ.any(dim=1)
        counts["shadow_spheres"] += int(torch.where(
            blocked, cb[torch.argmax(occ.int(), dim=1)], cb[-1]).sum())
    inv = _safe_inv(rd)
    rows = packed.cl[:, 6:8].tolist()

    def enter(box, lanes):
        lanes = lanes[~blocked[lanes]]
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
        cb = tri[:, col + 5] > 0.0
        tt = triangle_ts(p1[ent], rd[ent], tri[:, 0:3], tri[:, 3:6],
                         tri[:, 6:9], max_d[ent][:, None])
        occ = (tt < INF) & (tt > SHADOW_EPS) & cb[None]
        hit = occ.any(dim=1)
        cbc = torch.cumsum(cb.long(), 0)
        counts["shadow_tris"] += int(torch.where(
            hit, cbc[torch.argmax(occ.int(), dim=1)], cbc[-1]).sum())
        blocked[ent[hit]] = True

    walk_clusters(packed, rd, enter, cluster)
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
                      live=None, counts: dict | None = None) -> dict:
    """Brute-force nearest hit on the packed tables.  Returns (B,) fields
    t, normal (flipped toward the ray), material and flag (0 miss,
    1 surface, 2 light ball); misses report t = INF and zeros.
    ``with_uv`` adds the winning triangle's interpolated ``iu``, ``iv``
    and its texture id ``tex`` (float; 0, 0, -1 off triangles).  ``live``
    (B,) bool, the lanes whose result is read: the others get the miss
    record, as the kernel writes it (every lane without it).  ``counts``
    (from ``cuda_connect.new_counts``), if given, gains the primitive
    tests the kernels' walk makes for the live lanes."""
    if live is None:
        return _nearest_all(packed, ro, rd, with_uv, counts)
    out = _miss_rows(ro.shape[0], with_uv, ro.device)
    for k, x in _nearest_all(packed, ro[live], rd[live], with_uv,
                             counts).items():
        out[k][live] = x
    return out


def _nearest_all(packed: PackedScene, ro, rd, with_uv: bool, counts):
    """``nearest_hit_plain`` on every given lane, in chunks of rays."""
    if counts is not None:
        _count_nearest_walk(packed, ro, rd, counts)
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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

