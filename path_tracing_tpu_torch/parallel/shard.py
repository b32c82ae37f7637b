"""Sharded renders over a ``torch.distributed`` device mesh
(``path_tracing_tpu.parallel.shard``).

One process per rank, each calling the same function (torchrun's model;
the JAX package runs one controller over a ``shard_map``).  The lane axis
is split over every mesh axis in mesh-linear order (row-major over the
axis names, ``_linear_index``), and every rank returns the whole
``(W*H, 3)`` image, its slices gathered in that order:

- **PT**: each rank renders its pixels' lanes; the only collective is the
  final gather.
- **BDPT**: each rank traces its slice of the light paths; the light
  vertices are all-gathered, and each rank connects its pixels against all
  of them.
- **PPM**: each rank traces its slice of the photons, whose events stay on
  it; the hitpoint table is all-gathered, each rank gathers its events
  into every hitpoint, and the flux is summed over the ranks, each
  keeping its pixels' slice (the image needs no photon counts, and the JAX
  function discards them too).

Every per-lane draw takes global Threefry counters (``start``/``total``),
so a rank draws the bits of its slice of the single-process render: PT
and BDPT (fused, or with the exact or global-RIS table) are bit-equal to
the single-process image on any mesh, and PPM equal up to the order in
which its flux sums.  Tile-local RIS (BDPT mega with
``bdpt_resample_vertices`` > 0) folds the rank's offset into its key, as
the JAX package does, so a rank's slice equals ``eye_pass`` over the same
window in one process, not the unsharded image.  Light paths and photons
are padded to a multiple of the mesh size; the pad rows trace nothing.

The process group is the caller's (``tcp://`` or torchrun's ``env://``):
NCCL for CUDA tensors, gloo for CPU ones.  Gloo may also serve CUDA
tensors (several ranks on one card, which NCCL refuses).  Gloo does not
implement every collective for CUDA tensors, so under gloo each tensor is
staged through host memory explicitly.  Every backend takes the same two
collectives, all-gather and all-reduce, which every release of gloo
implements.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import RenderConfig
from ..scene.types import Camera, Material, Scene


def make_mesh(n_devices: int | None = None, axis: str = "dp", dcn: int = 1,
              backend: str | None = None) -> DeviceMesh:
    """The render mesh over the process group's ranks: ``(axis,)``, or
    ``("dcn", axis)`` with ``dcn`` rows (hosts) when ``dcn > 1``.  Every
    rank calls it.  Without a process group it initialises one from the
    environment (``env://``, as torchrun sets it) with ``backend``
    (default: "nccl" when CUDA is available, else "gloo").  ``n_devices``
    must equal the world size."""
    if not dist.is_initialized():
        dist.init_process_group(backend=backend or (
            "nccl" if torch.cuda.is_available() else "gloo"))
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n % dcn:
        raise ValueError(f"{n} ranks do not split into {dcn} DCN groups")
    ranks = torch.arange(n)
    shape, names = ((dcn, n // dcn), ("dcn", axis)) if dcn > 1 else \
        ((n,), (axis,))
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, ranks.reshape(shape),
                      mesh_dim_names=names)


def _linear_index(mesh: DeviceMesh) -> int:
    """This rank's position in mesh-flattening order (row-major over the
    axes).  The collectives concatenate and slice in rank order, so the
    mesh must lay the process group's ranks out in that order, as
    ``make_mesh`` and ``init_device_mesh`` do; then a hybrid mesh and a
    flat one of the same size give the same slices."""
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("the mesh must hold the process group's ranks in "
                         f"order, not {mesh.mesh.tolist()}")
    coord = mesh.get_coordinate()
    idx = 0
    for d in range(mesh.ndim):
        idx = idx * mesh.size(d) + coord[d]
    return idx


def _staged(x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective reads: on the host under gloo, bools as
    bytes."""
    if dist.get_backend() == "gloo":
        x = x.cpu()
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in mesh-linear order
    (rank order, ``_linear_index``)."""
    src = _staged(x)
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(device=x.device, dtype=x.dtype)


def _reduce_scatter(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum over ranks of ``x``, whose dim 0 holds one equal slice for
    each rank in mesh-linear order; this rank receives its slice.  It is
    an all-reduce of the whole tensor of which each rank keeps its slice,
    one path for every backend (gloo's reduce-scatter is not in every
    release)."""
    src = _staged(x)
    dist.all_reduce(src, op=dist.ReduceOp.SUM)
    return src.chunk(mesh.size())[_linear_index(mesh)].to(x.device)


def _lanes(width: int, height: int, mesh: DeviceMesh, device):
    """(this rank's first lane, the lane count, px, py) of a ``W*H``
    render split over the mesh."""
    n, B = mesh.size(), width * height
    if B % n:
        raise ValueError(f"pixels ({B}) must divide the mesh ({n})")
    lo = _linear_index(mesh) * (B // n)
    idx = torch.arange(lo, lo + B // n, dtype=torch.int32, device=device)
    return lo, B, idx % width, idx // width


def _rows(total: int, mesh: DeviceMesh) -> tuple:
    """(first row, rows traced, rows a rank) of this rank's slice of
    ``total`` light paths or photons padded to a multiple of the mesh size.
    The pad rows past ``total`` trace nothing: the rank traces only its
    real rows (the JAX package traces the pad lanes dead)."""
    per = -(-total // mesh.size())
    first = _linear_index(mesh) * per
    return first, max(0, min(per, total - first)), per


def render_pt_sharded(scene: Scene, cam: Camera, width: int, height: int,
                      spp: int, cfg: RenderConfig, key, mesh: DeviceMesh,
                      tier: str = "auto") -> torch.Tensor:
    """PT over the mesh: each rank renders ``W*H/n`` lanes through
    ``wavefront_pt`` (the tier of ``render_pt``); no collective but the
    gather of the image."""
    from ..integrators.pt import wavefront_pt

    lo, B, px, py = _lanes(width, height, mesh, scene.device)
    img = wavefront_pt(scene, cam, cfg, px, py, spp, key, start=lo,
                       total=B, tier=tier) / spp
    return _all_gather(img, mesh)


def render_ppm_sharded(scene: Scene, cam: Camera, width: int, height: int,
                       spl: int, cfg: RenderConfig, key, mesh: DeviceMesh,
                       tier: str = "auto") -> torch.Tensor:
    """One PPM pass over the mesh at the fixed radius: pixel-sharded eye
    pass, photon-sharded trace, every rank's events gathered into the
    all-gathered hitpoints (``gather_flux_dispatch``: #11 or the hash
    grid, by tier), the flux summed over the ranks (``_reduce_scatter``),
    each keeping its pixels'."""
    from ..integrators.ppm import (HitPoints, gather_flux_dispatch,
                                   ppm_eye_trace, ppm_photon_trace,
                                   resolve_image, resolve_tier)
    from ..ops import rng

    tier = resolve_tier(scene, tier)
    plain = tier == "plain"
    lo, B, px, py = _lanes(width, height, mesh, scene.device)
    true_photons = scene.num_lights * spl
    first, real, _ = _rows(true_photons, mesh)
    direct, hp = ppm_eye_trace(scene, cam, cfg, px, py, rng.fold_in(key, 1),
                               start=lo, total=B, plain=plain)
    gather = lambda x: _all_gather(x, mesh)  # noqa: E731
    hp_all = HitPoints(
        pos=gather(hp.pos), normal=gather(hp.normal), wo=gather(hp.wo),
        mtl=Material(**{f.name: gather(getattr(hp.mtl, f.name))
                        for f in dataclasses.fields(Material)}),
        throughput=gather(hp.throughput), valid=gather(hp.valid))
    if real:
        events = ppm_photon_trace(scene, cfg, real, spl,
                                  rng.fold_in(key, 2), start=first,
                                  total=true_photons, plain=plain)
        flux = gather_flux_dispatch(scene, cfg, hp_all, events, 1.0,
                                    tier)[0]
    else:    # every row of this rank is a pad row
        flux = torch.zeros_like(hp_all.pos)
    return gather(resolve_image(cfg, direct, hp, _reduce_scatter(flux,
                                                                 mesh)))


def render_bdpt_sharded(scene: Scene, cam: Camera, width: int, height: int,
                        spp: int, spl: int, cfg: RenderConfig, key,
                        mesh: DeviceMesh, light_sample: int = 0,
                        tier: str = "auto") -> torch.Tensor:
    """BDPT over the mesh (``render_bdpt``'s GPU-parity scaling): each rank
    traces its slice of the ``Nl * light_sample * spl`` light paths, the
    light vertices are all-gathered, and ``eye_pass`` runs on the rank's
    pixels in ``tier``."""
    from ..integrators.bdpt import eye_pass, resolve_tier, trace_light_paths
    from ..ops import rng

    tier = resolve_tier(scene, tier, cfg)
    lo, B, px, py = _lanes(width, height, mesh, scene.device)
    ls = light_sample or spl
    true_paths = scene.num_lights * ls * spl
    first, real, per = _rows(true_paths, mesh)
    scene_used = scene.with_illum_scaled(1.0 / ls)
    lv = trace_light_paths(scene_used, cfg, real, spl,
                           rng.fold_in(key, 0x0101),
                           start=first if real else 0, total=true_paths,
                           plain=tier == "plain")
    # the pad rows: invalid vertices, which compaction puts past the valid
    lv = lv.map(lambda x: _all_gather(torch.cat(
        [x, x.new_zeros((per - real,) + tuple(x.shape[1:]))]), mesh))
    img = eye_pass(scene_used, lv, cam, cfg, px, py, spp, key, float(ls),
                   start=lo, total=B, tier=tier)
    return _all_gather(img, mesh)
