"""Nearest hit and shadow any-hit on meshes above ``MAX_RESIDENT_TRIS``
(counterparts of ``path_tracing_tpu.ops.pallas_intersect``'s
``_nearest_hit_stream`` (#6) and ``_any_blocker_stream`` (#7)).

``pack_scene_stream`` builds the JAX package's streamed layout
(``_stream_layout``): every cluster's triangles re-scatter to a
``TB``-aligned padded start, so a cluster is a whole number of 32-triangle
blocks; ``idx`` of a hit is the PADDED triangle index.  Its tables:

- ``tri (Tp, 12)``: ``[v0, e1, e2, blocks_gpu, blocks_cpu, 0]`` per padded
  triangle, the edges subtracted once here in float32 as #1 subtracts them
  in-register, so t is #1's bit for bit; padding rows are zero (a zero
  determinant never hits).  The TPU's 8-slot x 16-lane rows and DMA
  windows are not kept: a thread reads its triangle's row;
- ``attr (Tp, 16)``: ``[n^3, base_color3, rough, metal, eta, uv6, tex]``,
  the winner's attributes, resolved outside the kernel;
- ``vert (Tp, 9)``: v0 v1 v2, for the ``with_uv`` barycentrics;
- ``blk (NB, 8)``: each 32-triangle block's AABB ``[min3, max3, 0, 0]``,
  empty blocks keeping the +-1e30 sentinels;
- ``cl (Mc, 16)``: ``[min3, max3, padded_start, count]`` and, from 64
  clusters on, the per-octant front-to-back child order within the
  cluster's super (``super_table``); ``sup (NS, 16)``: the supers' union
  AABB, child count and the 8 per-octant super orders.

#6 and #7 walk supers, then clusters, then blocks in the ray's octant
order, culling each box against the running best t (#7: the segment
length, and stopping once blocked), then run Moller-Trumbore on the
block's triangles; #6 walks them a warp at a time, each lane still
deciding for itself which boxes it enters.  ``_count_stream_walk`` and
``_count_stream_shadow_walk`` are plain models of #6's and #7's walks:
they count the tests each ray makes, which ``nearest_hit_stream_counts``
and ``any_blocker_stream_counts`` (the kernels' counting builds) are
held to.  The super table and the traversal order are the resident
walk's (``cuda_intersect.super_table``, ``walk_clusters``).
``stream_hit`` and ``stream_blocked`` coherence-sort the rays first
(``ops/intersect.py::sorted_call``), dead lanes last, and
``resolve_stream_attrs`` turns (t, idx, kind) into the hit fields with the
JAX package's own formulas, which round unlike #1's.

Each kernel has a wrapper and a plain version side by side: the wrapper
takes the plain version (a brute force over spheres and every real
triangle) only for CPU tensors; CUDA tensors launch the kernels of
``csrc/mesh_kernels.cu`` or raise.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..profiling import span
from ..scene.types import Scene
from . import _kernels
from .cuda_intersect import (SENTINEL, SUB, SUPER,
                             _chunks, _rowpad, _safe_inv, _slab_hit,
                             check_tensor, sphere_table, super_table,
                             texture_tables, walk_clusters)
from .intersect import INF, SHADOW_EPS, mt_from_edges, sorted_call, sphere_ts
from .math3 import EPSILON, cross, dot, length

TB = 32                   # triangles per block; clusters start on a block
TRI_COLS, ATTR_COLS, VERT_COLS, BLK_COLS, CL_COLS = 12, 16, 9, 8, 16
# The counting builds' counters: the live rays, their sphere tests, the
# super, cluster and block boxes they test, the triangles they test, and
# (#6 only) the lanes testing a staged block's triangles against 32 times
# the triangle-test steps issued (the test's SIMT efficiency).  The plain
# models (#6: ``_count_stream_walk``, #7: ``_count_stream_shadow_walk``)
# count ``PLAIN_COUNTS``.
COUNT_NAMES = ("rays", "spheres", "supers", "clusters", "blocks", "tris",
               "tri_lanes", "tri_slots")
PLAIN_COUNTS = COUNT_NAMES[:6]


@dataclass
class StreamScene:
    sph: torch.Tensor    # (Ms, 16) spheres then light balls (pack_scene's)
    tri: torch.Tensor    # (Tp, 12) v0 e1 e2 blocks_gpu blocks_cpu 0
    attr: torch.Tensor   # (Tp, 16)
    vert: torch.Tensor   # (Tp, 9)
    blk: torch.Tensor    # (NB, 8)
    cl: torch.Tensor     # (Mc, 16)
    sup: torch.Tensor    # (NS, 16)
    use_super: bool
    dest: torch.Tensor   # (nt,) int64: padded index of each triangle
    ns: int
    nl: int
    nt: int
    scene_min: torch.Tensor
    scene_max: torch.Tensor
    atlas: torch.Tensor     # the texture atlas and sizes, as pack_scene's
    tex_size: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.sph.device

    @property
    def bounds(self):
        return self.scene_min, self.scene_max

    @property
    def n_super(self) -> int:
        """Super rows the walk visits (0: the flat cluster walk)."""
        return self.cl.shape[0] // SUPER if self.use_super else 0


def stream_layout(scene: Scene) -> dict:
    """``_stream_layout`` without its sphere table: the padded index of
    every triangle (``dest``), ``Tp``, and the ``attr``, ``vert``, ``blk``
    and 8-column ``cl`` tables."""
    nt = scene.num_triangles
    dev = scene.device
    f32 = dict(device=dev, dtype=torch.float32)
    rng_ = scene.tri_cluster_range.to(torch.int64)
    starts, counts = rng_[:, 0].contiguous(), rng_[:, 1]
    mc0 = starts.shape[0]
    nblk_c = (counts + TB - 1) // TB
    padded_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.cumsum(nblk_c * TB, 0)[:-1]])
    Tp = ((nt + TB * mc0 + TB - 1) // TB) * TB
    i = torch.arange(nt, dtype=torch.int64, device=dev)
    cid = torch.searchsorted(starts, i, right=True) - 1
    dest = padded_start[cid] + (i - starts[cid])

    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    n = cross(v1 - v0, v2 - v0)
    nn = n / torch.clamp(length(n), min=1e-20)[:, None]
    m = scene.tri_mtl
    uv6 = (scene.tri_uv if scene.tri_uv.shape[0] == nt
           else torch.zeros((nt, 6), **f32))
    tex = (scene.tri_tex.float()[:, None] if scene.tri_tex.shape[0] == nt
           else torch.full((nt, 1), -1.0, **f32))
    attr = torch.zeros((Tp, ATTR_COLS), **f32)
    attr[dest] = torch.cat([nn, m.base_color, m.roughness[:, None],
                            m.metallic[:, None], m.eta[:, None], uv6, tex], 1)
    vert = torch.zeros((Tp, VERT_COLS), **f32)
    vert[dest] = torch.cat([v0, v1, v2], 1)

    NB = Tp // TB
    blk_id = (dest // TB)[:, None].expand(nt, 3)
    vmin = torch.minimum(torch.minimum(v0, v1), v2)
    vmax = torch.maximum(torch.maximum(v0, v1), v2)
    bmin = torch.full((NB, 3), SENTINEL, **f32).scatter_reduce(
        0, blk_id, vmin, "amin", include_self=True)
    bmax = torch.full((NB, 3), -SENTINEL, **f32).scatter_reduce(
        0, blk_id, vmax, "amax", include_self=True)
    with span("sync.stream_empty_block"):
        empty = torch.tensor([SENTINEL] * 3 + [-SENTINEL] * 3 + [0.0, 0.0],
                             **f32).expand((-NB) % SUB, BLK_COLS)
    blk = torch.cat([torch.cat([bmin, bmax, torch.zeros((NB, 2), **f32)], 1),
                     empty], 0)

    cl = torch.cat([scene.tri_cluster_aabb,
                    padded_start.float()[:, None], counts.float()[:, None]], 1)
    cl = _rowpad(cl, max(SUB, ((mc0 + SUB - 1) // SUB) * SUB))
    return dict(dest=dest, Tp=Tp, attr=attr, vert=vert, blk=blk, cl=cl)


def pack_scene_stream(scene: Scene) -> StreamScene:
    """The streamed tables of ``scene`` on its device (see above)."""
    lay = stream_layout(scene)
    nt, dev = scene.num_triangles, scene.device
    dest = lay["dest"]
    v0 = scene.tri_v0
    tri = torch.zeros((lay["Tp"], TRI_COLS), device=dev)
    tri[dest] = torch.cat([
        v0, scene.tri_v1 - v0, scene.tri_v2 - v0,
        torch.ones((nt, 1), device=dev),        # GPU rule: everything blocks
        (scene.tri_mtl.eta <= 0.0).float()[:, None],    # the oracle's rule
        torch.zeros((nt, 1), device=dev)], 1)
    cl, sup, use_super = super_table(lay["cl"])
    if not use_super:
        cl = torch.cat([cl, torch.zeros((cl.shape[0], 8), device=dev)], 1)
    atlas, tex_size = texture_tables(scene)
    return StreamScene(
        sph=sphere_table(scene), tri=tri, attr=lay["attr"], vert=lay["vert"],
        blk=lay["blk"].contiguous(), cl=cl.contiguous(),
        sup=sup.contiguous(), use_super=use_super, dest=dest,
        ns=scene.num_spheres, nl=scene.num_lights, nt=nt,
        scene_min=scene.scene_min, scene_max=scene.scene_max,
        atlas=atlas, tex_size=tex_size)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _live_count(n_live, B: int) -> int:
    return B if n_live is None else max(0, min(B, int(n_live[0])))


def _cols(x: torch.Tensor, a: int):
    return tuple(x[None, :, a + k] for k in range(3))


def _rays(x: torch.Tensor):
    return tuple(x[:, k:k + 1] for k in range(3))


def _nearest_rows(st: StreamScene, tri: torch.Tensor, ro, rd):
    n_s = st.ns + st.nl
    ts = [sphere_ts(ro, rd, st.sph[:n_s, 0:3], st.sph[:n_s, 3], INF)]
    ok, _, _, t = mt_from_edges(_rays(ro), _rays(rd), _cols(tri, 0),
                                _cols(tri, 3), _cols(tri, 6), EPSILON)
    ts.append(torch.where(ok, t, torch.full_like(t, INF)))
    all_t = torch.cat(ts, dim=1)
    j = torch.argmin(all_t, dim=1)       # first minimum: spheres, then idx
    t = torch.gather(all_t, 1, j[:, None])[:, 0]
    hit = t < INF
    is_sph = j < n_s
    light = st.sph[torch.clamp(j, max=max(n_s - 1, 0)), 14] > 0.0
    kind = torch.where(is_sph, torch.where(light, 2, 1), 3)
    idx = torch.where(is_sph, j, st.dest[torch.clamp(j - n_s, min=0,
                                                     max=max(st.nt - 1, 0))])
    return (torch.where(hit, t, torch.full_like(t, INF)),
            torch.where(hit, idx, -1).to(torch.int32),
            torch.where(hit, kind, 0).to(torch.int32))


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES}


def _count_stream_walk(st: StreamScene, ro: torch.Tensor, rd: torch.Tensor,
                       counts: dict) -> torch.Tensor:
    """A plain model of #6's walk (``csrc/mesh_kernels.cu``
    ``WarpNearest``: each lane's own walk) on every given ray.  Adds to
    ``counts`` the rays, their sphere and light-ball tests, each super box
    in the ray's octant order, each entered super's cluster boxes in their
    order (the flat walk: every cluster's, in table order), each entered
    cluster's block boxes and each entered block's triangles; empty supers
    and clusters are skipped untested, and every box is culled against the
    ray's running nearest t as ``slab_hit`` culls it.  Returns that t
    (INF on a miss): the brute force's, since culling never drops a
    closer hit."""
    R, dev = ro.shape[0], ro.device
    n_s = st.ns + st.nl
    counts["rays"] += R
    counts["spheres"] += R * n_s
    t = (sphere_ts(ro, rd, st.sph[:n_s, 0:3], st.sph[:n_s, 3], INF).amin(1)
         if n_s and R else torch.full((R,), INF, device=dev))
    inv = _safe_inv(rd)

    def enter(box, lanes, name):
        counts[name] += lanes.numel()
        return lanes[_slab_hit(box, ro[lanes], inv[lanes], EPSILON, t[lanes])]

    def test(b, rows):
        counts["tris"] += b.numel() * rows.shape[0]
        ok, _, _, tt = mt_from_edges(_rays(ro[b]), _rays(rd[b]),
                                     _cols(rows, 0), _cols(rows, 3),
                                     _cols(rows, 6), EPSILON)
        tt = torch.where(ok, tt, torch.full_like(tt, INF)).amin(1)
        t[b] = torch.minimum(t[b], tt)

    _walk_blocks(st, rd, enter, test)
    return t


def _walk_blocks(st: StreamScene, rd, enter, test) -> None:
    """The streamed kernels' walk on every given ray: ``walk_clusters``
    one level deeper.  Each cluster the lanes enter (``enter(box, lanes,
    name)`` returns the lanes that enter the box), each of its 32-triangle
    blocks they enter, and ``test(lanes, rows)`` on the block's real
    rows."""
    cl = st.cl[:, 6:8].tolist()     # padded start, count

    def cluster(c, lanes):
        start, count = int(cl[c][0]), int(cl[c][1])
        if count <= 0 or not lanes.numel():
            return
        lanes = enter(st.cl[c], lanes, "clusters")
        for j in range((count + TB - 1) // TB if lanes.numel() else 0):
            b = enter(st.blk[start // TB + j], lanes, "blocks")
            if b.numel():
                a = start + j * TB
                test(b, st.tri[a:a + min(TB, count - j * TB)])

    walk_clusters(st, rd, lambda box, lanes: enter(box, lanes, "supers"),
                  cluster)


def _count_stream_shadow_walk(st: StreamScene, p1: torch.Tensor,
                              rd: torch.Tensor, max_d: torch.Tensor,
                              dielectrics_block: bool, counts: dict
                              ) -> torch.Tensor:
    """A plain model of #7's walk (``csrc/mesh_kernels.cu``
    ``BlockerWalk``) on every given segment.  Adds to ``counts`` the
    rays, their blocking spheres in order up to the first that occludes,
    and, while the segment is unblocked, each super box in the ray's
    octant order, each entered super's cluster boxes in their order (the
    flat walk: every cluster's), each entered cluster's block boxes and
    each entered block's blocking triangles in order up to the first that
    occludes, which ends the walk; every box culled against the segment
    (1e-3, max_d) as ``slab_hit`` culls it.  Returns the verdicts: the
    brute force's."""
    R, dev = p1.shape[0], p1.device
    col = 4 if dielectrics_block else 5
    counts["rays"] += R
    blocked = torch.zeros(R, dtype=torch.bool, device=dev)
    if st.ns and R:
        sph = st.sph[:st.ns]
        ts = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], max_d[:, None])
        occ = (ts < INF) & (ts > SHADOW_EPS) & (sph[:, col] > 0.0)[None]
        cb = torch.cumsum((sph[:, col] > 0.0).long(), 0)
        blocked = occ.any(dim=1)
        counts["spheres"] += int(torch.where(
            blocked, cb[torch.argmax(occ.int(), dim=1)], cb[-1]).sum())
    inv = _safe_inv(rd)

    def enter(box, lanes, name):
        lanes = lanes[~blocked[lanes]]
        counts[name] += lanes.numel()
        return lanes[_slab_hit(box, p1[lanes], inv[lanes], SHADOW_EPS,
                               max_d[lanes])]

    def test(b, rows):
        cb = rows[:, col + 5] > 0.0
        ok, _, _, tt = mt_from_edges(_rays(p1[b]), _rays(rd[b]),
                                     _cols(rows, 0), _cols(rows, 3),
                                     _cols(rows, 6), SHADOW_EPS)
        occ = ok & (tt < max_d[b][:, None]) & cb[None]
        hit = occ.any(dim=1)
        cbc = torch.cumsum(cb.long(), 0)
        counts["tris"] += int(torch.where(
            hit, cbc[torch.argmax(occ.int(), dim=1)], cbc[-1]).sum())
        blocked[b[hit]] = True

    _walk_blocks(st, rd, enter, test)
    return blocked


def nearest_hit_stream_plain(st: StreamScene, ro: torch.Tensor,
                             rd: torch.Tensor, n_live=None):
    """Brute force over every sphere, light ball and real triangle:
    (t, idx, kind) as :func:`nearest_hit_stream` returns them."""
    _kernels.plain_calls["nearest_hit_stream"] += 1
    B, dev = ro.shape[0], ro.device
    t = torch.full((B,), INF, device=dev)
    idx = torch.full((B,), -1, dtype=torch.int32, device=dev)
    kind = torch.zeros(B, dtype=torch.int32, device=dev)
    n_prims = st.ns + st.nl + st.nt
    tri = st.tri[st.dest]
    for a, b in _chunks(_live_count(n_live, B), n_prims):
        if b > a and n_prims:
            t[a:b], idx[a:b], kind[a:b] = _nearest_rows(st, tri, ro[a:b],
                                                        rd[a:b])
    return t, idx, kind


def _blocked_rows(st: StreamScene, tri, p1, rd, max_d, col: int):
    md = max_d[:, None]
    ok, _, _, t = mt_from_edges(_rays(p1), _rays(rd), _cols(tri, 0),
                                _cols(tri, 3), _cols(tri, 6), SHADOW_EPS)
    blocked = torch.any(ok & (t < md), dim=1)
    if st.ns:
        sph = st.sph[:st.ns]
        t = sphere_ts(p1, rd, sph[:, 0:3], sph[:, 3], md)
        occ = (t < INF) & (t > SHADOW_EPS) & (sph[:, col] > 0.0)[None]
        blocked |= torch.any(occ, dim=1)
    return blocked


def any_blocker_stream_plain(st: StreamScene, p1: torch.Tensor,
                             rd: torch.Tensor, max_d: torch.Tensor,
                             dielectrics_block: bool, n_live=None
                             ) -> torch.Tensor:
    """Brute force over every sphere and real triangle whose can-block
    flag is set: (B,) bool as :func:`any_blocker_stream` returns it."""
    _kernels.plain_calls["any_blocker_stream"] += 1
    col = 4 if dielectrics_block else 5
    B = p1.shape[0]
    out = torch.zeros(B, dtype=torch.bool, device=p1.device)
    tri = st.tri[st.dest]
    tri = tri[tri[:, col + 5] > 0.0]
    for a, b in _chunks(_live_count(n_live, B), st.ns + tri.shape[0]):
        if b > a:
            out[a:b] = _blocked_rows(st, tri, p1[a:b], rd[a:b], max_d[a:b],
                                     col)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _stream_args(st: StreamScene, device, n_live) -> list:
    if st.device != device:
        raise ValueError(f"scene tables on {st.device}, rays on {device}")
    for nm, x, c in (("sph", st.sph, 16), ("tri", st.tri, TRI_COLS),
                     ("cl", st.cl, CL_COLS), ("sup", st.sup, 16),
                     ("blk", st.blk, BLK_COLS)):
        check_tensor(nm, x, (x.shape[0], c))
        if x.data_ptr() % 16:   # the kernels read rows as float4
            raise ValueError(f"{nm}: rows must start 16-byte aligned")
    if n_live is not None:
        check_tensor("n_live", n_live, (1,), torch.int32)
    return [_ptr(st.sph), st.ns, st.nl, _ptr(st.tri), _ptr(st.cl),
            st.cl.shape[0], _ptr(st.sup), st.n_super, _ptr(st.blk)]


def nearest_hit_stream(st: StreamScene, ro: torch.Tensor, rd: torch.Tensor,
                       n_live=None):
    """Nearest hit per ray over the streamed tables: t (B,) f32 (INF on a
    miss), idx (B,) int32 (the sphere row or the padded triangle index,
    -1 on a miss) and kind (B,) int32 (0 miss, 1 sphere, 2 light ball,
    3 triangle).  ``n_live`` (1,) int32: lanes from it on report a miss
    without work."""
    if ro.device.type == "cpu" and rd.device.type == "cpu":
        return nearest_hit_stream_plain(st, ro, rd, n_live)
    return _launch_nearest("nearest_hit_stream", st, ro, rd, n_live)[:3]


def nearest_hit_stream_counts(st: StreamScene, ro: torch.Tensor,
                              rd: torch.Tensor, n_live=None) -> tuple:
    """``nearest_hit_stream`` through the kernel's counting build: (the
    same t, idx, kind, the counters as a dict keyed by ``COUNT_NAMES``).
    CUDA tensors only."""
    return _launch_nearest("nearest_hit_stream_counts", st, ro, rd, n_live)


def _launch_nearest(name, st, ro, rd, n_live):
    B, dev = ro.shape[0], ro.device
    check_tensor("ro", ro, (B, 3))
    check_tensor("rd", rd, (B, 3))
    args = _stream_args(st, dev, n_live)
    t = torch.empty(B, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    kind = torch.empty(B, dtype=torch.int32, device=dev)
    counted = name.endswith("_counts")
    buf = (torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=dev)
           if counted else None)
    if B:
        _kernels.launch(name, *args, _ptr(ro), _ptr(rd), B, _ptr(n_live),
                        _ptr(t), _ptr(idx), _ptr(kind),
                        *([_ptr(buf)] if counted else []))
    counts = (dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))
              if counted else None)
    return t, idx, kind, counts


def any_blocker_stream(st: StreamScene, p1: torch.Tensor, rd: torch.Tensor,
                       max_d: torch.Tensor, dielectrics_block: bool,
                       n_live=None) -> torch.Tensor:
    """Shadow any-hit per ray in (1e-3, max_d) over the streamed tables,
    (B,) bool; ``n_live`` as in :func:`nearest_hit_stream` (the lanes past
    it report unblocked)."""
    if all(x.device.type == "cpu" for x in (p1, rd, max_d)):
        return any_blocker_stream_plain(st, p1, rd, max_d, dielectrics_block,
                                        n_live)
    return _launch_blocker("any_blocker_stream", st, p1, rd, max_d,
                           dielectrics_block, n_live)[0]


def any_blocker_stream_counts(st: StreamScene, p1: torch.Tensor,
                              rd: torch.Tensor, max_d: torch.Tensor,
                              dielectrics_block: bool, n_live=None) -> tuple:
    """``any_blocker_stream`` through the kernel's counting build: (the
    same verdicts, the counters as a dict keyed by ``COUNT_NAMES``, of
    which it fills ``PLAIN_COUNTS``).  CUDA tensors only."""
    return _launch_blocker("any_blocker_stream_counts", st, p1, rd, max_d,
                           dielectrics_block, n_live)


def _launch_blocker(name, st, p1, rd, max_d, dielectrics_block, n_live):
    B, dev = p1.shape[0], p1.device
    check_tensor("p1", p1, (B, 3))
    check_tensor("rd", rd, (B, 3))
    check_tensor("max_d", max_d, (B,))
    args = _stream_args(st, dev, n_live)
    out = torch.empty(B, dtype=torch.bool, device=dev)
    counted = name.endswith("_counts")
    buf = (torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=dev)
           if counted else None)
    if B:
        _kernels.launch(name, *args, _ptr(p1), _ptr(rd), _ptr(max_d), B,
                        _ptr(n_live), 4 if dielectrics_block else 5,
                        _ptr(out), *([_ptr(buf)] if counted else []))
    counts = (dict(zip(COUNT_NAMES, (int(x) for x in buf.tolist())))
              if counted else None)
    return out, counts


# ---------------------------------------------------------------------------
# the resolver and the sorted calls
# ---------------------------------------------------------------------------

def resolve_stream_attrs(st: StreamScene, t, idx, kind, ro, rd,
                         with_uv: bool = False) -> dict:
    """The hit fields of ``nearest_hit``'s dict from (t, idx, kind), with
    ``_resolve_stream_attrs``' own arithmetic: sphere normals (ro + rd t -
    c) / max(r, 1e-20), misses with zero normal and material, flag 1 for
    triangles; ``with_uv`` recomputes the winner's barycentrics in the
    classic Moller-Trumbore form (parallel guard |a| < 1e-12)."""
    hit = kind > 0
    is_tri = kind == 3
    is_sph = hit & ~is_tri
    zero_i = torch.zeros_like(idx)
    ti = torch.where(is_tri, torch.clamp(idx, 0, st.attr.shape[0] - 1),
                     zero_i).long()
    si = torch.where(is_sph, torch.clamp(idx, 0, st.sph.shape[0] - 1),
                     zero_i).long()
    arow, srow = st.attr[ti], st.sph[si]
    tc = torch.where(hit, t, torch.zeros_like(t))[:, None]
    sn = (ro + rd * tc - srow[:, 0:3]) / torch.clamp(srow[:, 3:4], min=1e-20)
    n = torch.where(is_tri[:, None], arow[:, 0:3], sn)
    n = n * torch.where(dot(n, rd) > 0.0, -1.0, 1.0)[:, None]
    n = n * hit[:, None]
    m = hit.float()
    out = dict(t=t, nx=n[:, 0], ny=n[:, 1], nz=n[:, 2])
    for k, (a, s) in zip(("bcr", "bcg", "bcb", "rough", "metal", "eta"),
                         zip(range(3, 9), range(8, 14))):
        out[k] = m * torch.where(is_tri, arow[:, a], srow[:, s])
    out["flag"] = torch.where(is_tri, 1, kind).to(torch.int32)
    if with_uv:
        vr = st.vert[ti]
        v0 = vr[:, 0:3]
        e1 = vr[:, 3:6] - v0
        e2 = vr[:, 6:9] - v0
        h = cross(rd, e2)
        a = dot(e1, h)
        f = 1.0 / torch.where(torch.abs(a) < 1e-12, torch.ones_like(a), a)
        s = ro - v0
        u = f * dot(s, h)
        v = f * dot(rd, cross(s, e1))
        w0 = 1.0 - u - v
        iu = w0 * arow[:, 9] + u * arow[:, 11] + v * arow[:, 13]
        iv = w0 * arow[:, 10] + u * arow[:, 12] + v * arow[:, 14]
        zero = torch.zeros_like(t)
        out["iu"] = torch.where(is_tri, iu, zero)
        out["iv"] = torch.where(is_tri, iv, zero)
        out["tex"] = torch.where(is_tri, arow[:, 15], zero - 1.0)
    return out


def stream_hit(st: StreamScene, ro: torch.Tensor, rd: torch.Tensor,
               with_uv: bool = False, live=None) -> dict:
    """#6 on coherence-sorted rays (``live``: lanes whose hit is read; the
    others sort last and miss), resolved into ``nearest_hit``'s fields."""
    t, idx, kind = sorted_call(
        st.bounds, ro, rd,
        lambda a, b, n_live: nearest_hit_stream(st, a, b, n_live), live=live)
    return resolve_stream_attrs(st, t, idx, kind, ro, rd, with_uv)


def stream_blocked(st: StreamScene, p1: torch.Tensor, rd: torch.Tensor,
                   max_d: torch.Tensor, dielectrics_block: bool, live=None
                   ) -> torch.Tensor:
    """#7 on coherence-sorted shadow rays (``live`` as in
    :func:`stream_hit`; dead lanes report unblocked)."""
    return sorted_call(
        st.bounds, p1, rd,
        lambda a, b, m, n_live: any_blocker_stream(st, a, b, m,
                                                   dielectrics_block, n_live),
        max_d, live=live)
