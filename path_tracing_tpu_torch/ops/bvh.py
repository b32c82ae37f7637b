"""Triangle clustering: a median-split BVH cut at a fixed leaf size
(``path_tracing_tpu.ops.bvh``).

Triangles are reordered into spatially coherent clusters; the CUDA kernels
test each cluster's AABB per ray and skip the cluster's triangles when the
ray cannot reach it.  Scenes of ``SPHERE_INDEX_MIN`` spheres or more get
the same index over their spheres (``build_sphere_clusters``), which
``cuda_intersect.pack_scene`` lays out as the kernels walk it.
``build_clusters`` takes the C++ builder of
``csrc/pt_runtime.cc`` (``runtime/native.py``) when it builds, as the JAX
package does, else the numpy builder.  The two split the same medians but
break ties between equal centroids differently, so their layouts differ on
scenes with many (cornell's axis-aligned walls).
"""
from __future__ import annotations

import numpy as np

SPHERE_INDEX_MIN = 64     # below this many spheres every ray tests each
SPHERE_LEAF = 16          # spheres a cluster of the sphere index


def median_split(cent: np.ndarray, leaf_size: int):
    """Median splits of the points ``cent`` (N, 3) on their widest axis
    until at most ``leaf_size`` remain: (order (N,), ranges (M, 2) [start,
    count] of the leaves in ``order``)."""
    n = cent.shape[0]
    order = np.arange(n)
    ranges = []

    def rec(lo: int, hi: int):
        if hi - lo <= leaf_size:
            ranges.append((lo, hi - lo))
            return
        c = cent[order[lo:hi]]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (hi - lo) // 2
        part = np.argpartition(c[:, axis], mid)
        order[lo:hi] = order[lo:hi][part]
        rec(lo, lo + mid)
        rec(lo + mid, hi)

    if n:
        rec(0, n)
    return order, ranges


def build_clusters_py(tris9: np.ndarray, leaf_size: int = 16):
    """Median splits on the widest centroid axis.  Returns (order (N,),
    aabbs (M, 6) [min3, max3], ranges (M, 2) [start, count])."""
    tris9 = np.asarray(tris9, np.float32).reshape(-1, 9)
    n = tris9.shape[0]
    v = tris9.reshape(n, 3, 3)
    order, ranges = median_split(v.mean(axis=1), leaf_size)
    aabbs = []
    for lo, k in ranges:
        t = v[order[lo:lo + k]]
        aabbs.append(np.concatenate([t.min(axis=(0, 1)),
                                     t.max(axis=(0, 1))]))
    if not n:
        aabbs.append(np.array([1e9, 1e9, 1e9, -1e9, -1e9, -1e9], np.float32))
        ranges.append((0, 0))
    return (order.astype(np.int32),
            np.asarray(aabbs, np.float32),
            np.asarray(ranges, np.int32))


def build_sphere_clusters(center: np.ndarray, radius: np.ndarray,
                          leaf_size: int):
    """The sphere index: median splits of the centres on their widest
    axis, as the triangles' (``median_split``).  Returns (order (N,),
    aabbs (M, 6) [min3, max3], ranges (M, 2) [start, count]); a cluster's
    box is the union of its spheres' boxes ``c -+ r``, each bound rounded
    outward by one float32 ulp."""
    center = np.asarray(center, np.float32).reshape(-1, 3)
    radius = np.asarray(radius, np.float32).reshape(-1, 1)
    lo = np.nextafter(center - radius, np.float32(-np.inf))
    hi = np.nextafter(center + radius, np.float32(np.inf))
    order, ranges = median_split(center, leaf_size)
    aabbs = [np.concatenate([lo[order[a:a + k]].min(axis=0),
                             hi[order[a:a + k]].max(axis=0)])
             for a, k in ranges]
    return (order.astype(np.int32), np.asarray(aabbs, np.float32),
            np.asarray(ranges, np.int32))


def build_clusters(tris9: np.ndarray, leaf_size: int = 16):
    """The C++ builder when the native runtime is available, else the
    numpy builder."""
    from ..runtime.native import build_clusters_native

    out = build_clusters_native(tris9, leaf_size)
    return out if out is not None else build_clusters_py(tris9, leaf_size)
