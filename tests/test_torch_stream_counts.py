"""The plain model of the streamed nearest hit's walk (#6,
``cuda_stream._count_stream_walk``), which the card's counting build is
held to: on the 20,480-triangle icosphere (512 clusters, so the super
walk runs) and on the sphere fixture cut into 32 clusters (leaf 96:
the flat walk),
with rays drawn from a numpy seed.  The t it finds must be the brute
force's bit for bit (culling never drops a closer hit), its triangle
tests at most the brute force's, and its counts a sum over rays."""
from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracing_tpu_torch.ops import cuda_stream as CS
from path_tracing_tpu_torch.scene import synth
from path_tracing_tpu_torch.scene.obj_loader import load_any_scene

SPHERE_OBJ = Path(__file__).resolve().parent / "fixtures" / "sphere.obj"


def _rays(n, seed, span):
    """Origins in a box ``span`` a side around the mesh; half the rays
    aimed near its centre, half in random directions."""
    rs = np.random.default_rng(seed)
    ro = rs.uniform(-span, span, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    aim = -ro + rs.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    rd[::2] = aim[::2]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro), torch.from_numpy(rd)


def _mesh(which):
    if which == "icosphere_17000":
        return synth.icosphere_scene(17000).to_device("cpu"), 1.5
    return load_any_scene(str(SPHERE_OBJ)).to_device(
        "cpu", cluster_leaf_size=96), 0.8


@pytest.mark.parametrize("which", ["icosphere_17000", "sphere_obj"])
def test_count_stream_walk_finds_the_brute_force_t(which):
    scene, span = _mesh(which)
    st = CS.pack_scene_stream(scene)
    assert st.use_super == (which == "icosphere_17000")
    n = 3000
    ro, rd = _rays(n, 21, span)
    counts = CS.new_counts()
    t = CS._count_stream_walk(st, ro, rd, counts)
    tp, idx, kind = CS.nearest_hit_stream_plain(st, ro, rd)
    assert torch.equal(t, tp)
    assert 0.2 < (kind == 3).float().mean().item() < 0.95
    assert counts["rays"] == n
    assert counts["spheres"] == n * (st.ns + st.nl)
    assert 0 < counts["tris"] <= n * st.nt
    assert 0 < counts["blocks"] <= counts["clusters"] * (
        (st.cl[:, 7].max().item() + CS.TB - 1) // CS.TB)
    if st.use_super:
        assert 0 < counts["clusters"] <= CS.SUPER * counts["supers"]
        assert counts["supers"] <= n * st.n_super
    else:
        assert counts["supers"] == 0
        assert counts["clusters"] == n * int((st.cl[:, 7] > 0).sum())
    assert counts["tri_lanes"] == counts["tri_slots"] == 0

    # a sum over rays: the rays in another order
    perm = torch.from_numpy(np.random.default_rng(22).permutation(n))
    again = CS.new_counts()
    assert torch.equal(CS._count_stream_walk(st, ro[perm], rd[perm], again),
                       t[perm])
    assert again == counts


def test_kernel_argtypes_match_the_c_entries():
    """Every kernel entry's ctypes argument list has one type per
    parameter of its C function in ``csrc/`` (the stream last; the scene
    tables' ``PTK_TABLE_PARAMS`` expanded from ``pt_device.cuh``): an
    entry missing the stream's type passes it as a 32-bit int, which the
    host side of a launch can crash on."""
    import ctypes
    import re

    from path_tracing_tpu_torch.ops import _kernels

    hdr = (_kernels.SRC_DIR / "pt_device.cuh").read_text().replace("\\\n", " ")
    tables = re.search(r"#define PTK_TABLE_PARAMS (.*)", hdr).group(1)
    assert len(tables.split(",")) == len(_kernels._TABLES)
    for lib, names in _kernels.LIBRARIES.items():
        src = (_kernels.SRC_DIR / f"{lib}.cu").read_text().replace(
            "PTK_TABLE_PARAMS", tables)
        for k in names:
            params = re.search(rf"int pt_{k}\(([^)]*)\)", src).group(1)
            n = len([x for x in params.split(",") if x.strip()])
            types = _kernels._ARGTYPES[k]
            assert len(types) == n, k
            assert params.split(",")[-1].split()[-1] == "stream", k
            assert types[-1] is ctypes.c_void_p, k
