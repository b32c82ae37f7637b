"""Triangle clustering: a median-split BVH cut at a fixed leaf size
(``path_tracing_tpu.ops.bvh``).

Triangles are reordered into spatially coherent clusters; the CUDA kernels
test each cluster's AABB per ray and skip the cluster's triangles when the
ray cannot reach it.  ``build_clusters`` takes the C++ builder of
``csrc/pt_runtime.cc`` when it builds; this frozen copy always takes the
numpy builder, so the reference's layout is independent of the program's
(the two split the same medians but break ties between equal centroids
differently, so their layouts differ on scenes with many).
"""
from __future__ import annotations

import numpy as np


def build_clusters_py(tris9: np.ndarray, leaf_size: int = 16):
    """Median splits on the widest centroid axis.  Returns (order (N,),
    aabbs (M, 6) [min3, max3], ranges (M, 2) [start, count])."""
    tris9 = np.asarray(tris9, np.float32).reshape(-1, 9)
    n = tris9.shape[0]
    v = tris9.reshape(n, 3, 3)
    cent = v.mean(axis=1)
    order = np.arange(n)
    aabbs, ranges = [], []

    def rec(lo: int, hi: int):
        if hi - lo <= leaf_size:
            t = v[order[lo:hi]]
            aabbs.append(np.concatenate([t.min(axis=(0, 1)),
                                         t.max(axis=(0, 1))]))
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
    else:
        aabbs.append(np.array([1e9, 1e9, 1e9, -1e9, -1e9, -1e9], np.float32))
        ranges.append((0, 0))
    return (order.astype(np.int32),
            np.asarray(aabbs, np.float32),
            np.asarray(ranges, np.int32))


def build_clusters(tris9: np.ndarray, leaf_size: int = 16):
    """The numpy builder."""
    return build_clusters_py(tris9, leaf_size)
