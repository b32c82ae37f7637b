"""Progressive photon mapping with the exact cell-sorted gather
(``path_tracing_tpu.integrators.ppm``).

One pass:

1. the eye pass (``ppm_eye_trace``) follows each pixel's delta chain
   (perfect mirrors and glass) from a jittered camera ray, stores a
   hitpoint at the first rough surface and assigns (does not add) the
   radiance of a light ball the chain reaches;
2. the photon pass (``ppm_photon_trace``) emits ``Nl * spl`` photons, photon
   ``i`` from light ``i % Nl`` with flux ``illum * Nl / spl`` (the
   reference's Nl-times flux, kept as the JAX package keeps it), and
   records their deposits on depositable surfaces (eta <= 0 and not a
   smooth conductor) at most ``light_depth`` non-delta bounces deep;
3. the gather (``ops/cuda_ppm_gather.py``) sums, per hitpoint, every event
   within the radius whose normal agrees, weighted by the hitpoint's BRDF;
4. the image is the direct term plus ``flux / (pi r^2 r2_scale)`` on valid
   hitpoints, clamped at ``cfg.clamp``.

The radius may shrink from pass to pass (``ppm_radius_scale``); progressive
accumulation is the caller's average over passes.

Tiers (``resolve_tier``): ``mega`` (``auto``) runs the eye pass in the
``ppm_eye`` kernel (``ops/cuda_ppm_eye.py``), the photon bounces in the
``photon_trace`` kernel (#10) and the join in the ``gather_flux`` kernel
(#11); ``hash`` runs the same eye pass and photon bounces and gathers
through the reference's spatial hash (``gather_flux_hash``, PyTorch on any
device, the JAX package's gather off the TPU); ``plain`` runs the plain
versions of all of them.  Meshes of any
size take the same route: from 64 clusters on, ``ppm_eye`` and #10 walk the
super-cluster table (the JAX package streams meshes above its VMEM
ceiling through #6/#7 and an XLA photon scan; the photons and hits are
the same).  On CPU tensors every kernel runs its plain version.  The
random numbers are the JAX package's Threefry streams: the eye pass
draws its jitter from ``fold_in(key, 0x9E1)`` and bounce ``it`` from
``iter_key(fold_in(key, 0x9E2), it)``; emission from ``fold_in(key,
0x407)``; photon bounces as ``ops/cuda_photon.py`` says.  A pass renders
from ``fold_in(frame_key, 1)`` (eye) and ``fold_in(frame_key, 2)``
(photons), as the JAX package's does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import RenderConfig
from ..ops import rng
from ..ops.bsdf import _eval_local, _half_vector
from ..ops.cuda_photon import photon_trace, photon_trace_plain
from ..ops.cuda_ppm_eye import HitPoints, ppm_eye
from ..ops.cuda_ppm_gather import gather_flux, gather_flux_plain
from ..ops.frame import build_local_frame, world_to_local
from ..ops.math3 import PI, clamp_radiance, dot, is_valid_color
from ..ops.microfacet import roughness_to_alpha
from ..ops.sampling import sample_light_emission
from ..profiling import span
from ..scene.types import Camera, Material, Scene

TIERS = ("auto", "mega", "hash", "plain")
# hitpoints a step of the hash gather takes at once: bounds its (n, 27, 12)
# candidate block (at 512^2 all of them at once would be 340 MB a step)
HASH_CHUNK = 1 << 16


@dataclass
class PhotonEvents:
    """Photon deposits: rows ``[pos3, normal3, wi3, flux3]`` (E, 12) with
    ``wi`` toward the light, and their valid flags (E,)."""

    table: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def from_fields(pos, normal, wi, flux, valid) -> "PhotonEvents":
        return PhotonEvents(torch.cat([pos, normal, wi, flux], dim=1)
                            .contiguous(), valid)

    @property
    def pos(self):
        return self.table[:, 0:3]

    @property
    def normal(self):
        return self.table[:, 3:6]

    @property
    def wi(self):
        return self.table[:, 6:9]

    @property
    def flux(self):
        return self.table[:, 9:12]


def resolve_tier(scene: Scene, tier: str) -> str:
    """The PPM tier that renders ``scene`` when ``tier`` is asked for:
    "auto" is "mega" (the exact gather, the JAX package's TPU route) on
    every scene, at any triangle count (above ``MAX_RESIDENT_TRIS`` the
    ``kWalkSuper`` instances of ``ppm_eye`` and #10 walk the super-cluster
    table), textured (the textured instances of ``ppm_eye`` and #10) or
    with legacy Ks (which PPM never reads: it casts no shadow
    rays); "hash" and "plain" are taken as asked.  Raises ValueError for a
    tier PPM does not have."""
    if tier not in TIERS:
        raise ValueError(f"PPM has no tier {tier!r}; expected one of {TIERS}")
    return "mega" if tier == "auto" else tier


def ppm_eye_trace(scene: Scene, cam: Camera, cfg: RenderConfig, px, py, key,
                  start: int = 0, total: int | None = None,
                  plain: bool = False):
    """Delta-chase eye pass -> (direct image (B, 3), HitPoints)
    (``ops/cuda_ppm_eye.py::ppm_eye``: the kernel on CUDA tensors, the
    PyTorch loop on CPU tensors or with ``plain``).  ``start``/``total``:
    these lanes are columns [start, start + B) of a ``total``-lane pass.
    ``plain`` runs the loop on the plain nearest hit and Threefry."""
    return ppm_eye(scene.packed.take(), cam, cfg, px, py, key, start,
                   total, plain)


def photon_emission(scene: Scene, num_photons: int, spl: int, key,
                    start: int = 0, total: int | None = None,
                    plain: bool = False):
    """The photons of a pass: (origins, directions, flux (P, 3), real (P,)).
    Photon ``i`` is global photon ``start + i`` of a ``total``-photon pass
    and comes from light ``(start + i) % Nl``; photons past ``total`` are
    not real."""
    draw = rng.uniform_rows_plain if plain else rng.uniform_rows
    dev = scene.device
    P = num_photons
    nl = scene.num_lights
    gi = start + torch.arange(P, device=dev)
    li = gi % nl
    real = (torch.ones(P, dtype=torch.bool, device=dev) if total is None
            else gi < total)
    u = draw(rng.fold_in(key, 0x407), P, 2, start, total, device=dev)
    emit = sample_light_emission(
        scene.light_pos[li], scene.light_dir[li], scene.light_cutoff[li],
        scene.light_is_parallel[li], scene.light_ball_r[li], scene.scene_min,
        scene.scene_max, u[0], u[1])
    flux0 = scene.light_illum[li] * (float(nl) / max(float(spl), 1.0))
    return (emit.origin.contiguous(), emit.direction.contiguous(),
            flux0.contiguous(), real)


def ppm_photon_trace(scene: Scene, cfg: RenderConfig, num_photons: int,
                     spl: int, key, start: int = 0, total: int | None = None,
                     plain: bool = False) -> PhotonEvents:
    """The photon pass: emission, then the bounces in ``photon_trace``
    (or its plain version), recording depth-slotted deposit events."""
    with span("ppm.emission"):
        ro, rd, flux0, real = photon_emission(scene, num_photons, spl, key,
                                              start, total, plain)
    trace = photon_trace_plain if plain else photon_trace
    with span("ppm.photon_trace"):
        ev, valid = trace(scene.packed.take(), ro, rd, flux0, real, key,
                          cfg.light_depth, cfg.max_light_iters, start, total)
    return PhotonEvents(ev, valid)


def ppm_radius_scale(pass_index: int, alpha: float) -> float:
    """Progressive radius: r_i^2 = r_0^2 prod_{k=1..i} (k + alpha) / (k + 1);
    alpha <= 0 or pass 0 keeps the fixed radius (1.0)."""
    if alpha <= 0.0 or pass_index <= 0:
        return 1.0
    scale = 1.0
    for k in range(1, pass_index + 1):
        scale *= (k + alpha) / (k + 1.0)
    return scale


def hash_cell(ix, iy, iz, table_size: int) -> torch.Tensor:
    """The reference's cell hash (ppm_cu.cu:27-30): int32 products that
    wrap, their XOR read as uint32, modulo ``table_size``.  Computed in
    int64 on the low 32 bits of each product, since torch's ``%`` on a
    negative int32 is a floor modulo and its uint32 has few ops."""
    m = 0xFFFFFFFF
    h = (((ix.long() * 73856093) & m) ^ ((iy.long() * 19349663) & m)
         ^ ((iz.long() * 83492791) & m))
    return (h % table_size).to(torch.int32)


def _cell_coords(pos, origin, cell_size: float) -> torch.Tensor:
    """Integer cell of each position: ``floor((pos - origin) / cell_size)``
    as the JAX package computes it under ``jit``, where XLA folds the
    division by the constant cell size into a multiplication by its
    float32 reciprocal; a position one ulp from a cell boundary then lands
    where it lands there.  The reciprocal is rounded on the host and
    multiplied as a float32 tensor."""
    inv = (torch.tensor(1.0, dtype=torch.float32)
           / torch.tensor(cell_size, dtype=torch.float32))
    with span("sync.ppm_cell_inv"):
        inv = inv.to(pos.device)
    return torch.floor((pos - origin) * inv).to(torch.int32)


_OFFS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
              for dz in (-1, 0, 1))


def hash_runs(scene: Scene, cfg: RenderConfig, hp: HitPoints,
              events: PhotonEvents):
    """The hash grid of ``gather_flux_hash``: (the event rows sorted stably
    by their cell's hash, invalid ones last (E, 12); the first sorted row
    (B, 27) and the length (B, 27) of the run of each hitpoint's 27
    neighbour cells).  The runs are a bincount over the
    ``ppm_hash_size + 1`` hashes and its exclusive prefix sum."""
    table, cell = cfg.ppm_hash_size, cfg.ppm_radius
    origin = scene.scene_min
    e_cells = _cell_coords(events.pos, origin, cell)
    e_hash = hash_cell(e_cells[:, 0], e_cells[:, 1], e_cells[:, 2], table)
    e_key = torch.where(events.valid, e_hash, table)
    se = events.table[torch.argsort(e_key, stable=True)]
    h_cells = _cell_coords(hp.pos, origin, cell)
    with span("sync.ppm_hash_offs"):
        offs = torch.tensor(_OFFS, dtype=torch.int32, device=hp.pos.device)
    n_cells = h_cells[:, None, :] + offs[None]
    n_hash = hash_cell(n_cells[..., 0], n_cells[..., 1], n_cells[..., 2],
                       table)
    with span("sync.ppm_hash_bincount"):
        counts = torch.bincount(e_key.long(), minlength=table + 1)
    return se, (torch.cumsum(counts, 0) - counts)[n_hash], counts[n_hash]


def gather_flux_hash(scene: Scene, cfg: RenderConfig, hp: HitPoints,
                     events: PhotonEvents, r2_scale=1.0):
    """Per-hitpoint flux gather over the 27 neighbour cells of the
    reference's spatial hash (the JAX package's ``gather_flux``):
    -> (flux (B, 3), count (B,) int32, overflow ()).

    Events sort (stably) by their cell's hash, invalid ones last, into
    each neighbour cell's run (``hash_runs``).  A hitpoint takes at most
    ``ppm_max_per_cell`` events of a run, and ``overflow`` counts the
    events the budget drops over every hitpoint, valid or not; with
    ``ppm_cell_samples`` = M > 0 it takes M events strided through the run,
    each weighted by ``count / M``, and nothing overflows.  Two
    neighbouring cells whose hashes collide are gathered twice, as in the
    reference.  ``kmax`` (the longest run taken) is read on the host once a
    call."""
    dev = hp.pos.device
    K, M = cfg.ppm_max_per_cell, cfg.ppm_cell_samples
    with span("sync.ppm_hash_r2"):
        r2 = torch.tensor(cfg.ppm_radius * cfg.ppm_radius * r2_scale,
                          dtype=torch.float32, device=dev)
    with span("ppm.gather_prepare"):
        se, start, counts_q = hash_runs(scene, cfg, hp, events)
    with span("ppm.gather"):
        E = se.shape[0]
        with span("sync.ppm_hash_kmax"):
            most = int(counts_q.max())      # the one host sync of the call
        if M > 0:
            overflow = torch.zeros((), dtype=torch.int32, device=dev)
            kmax = min(most, M)
            # the M strata of a run, each weighted by count / M (exact when
            # the run has no more than M events)
            with span("sync.ppm_hash_m"):
                m = torch.tensor(float(M), device=dev)
            stride = torch.clamp(counts_q.to(torch.float32) / m, min=1.0)
        else:
            overflow = torch.clamp(counts_q - K, min=0).sum().to(torch.int32)
            kmax = min(most, K)
            stride = None

        # the BSDF frame once per hitpoint: only the event's direction varies
        tf, bf = build_local_frame(hp.normal)
        wo_l = world_to_local(hp.wo, tf, bf, hp.normal)
        alpha = roughness_to_alpha(hp.mtl.roughness)

        B = hp.pos.shape[0]
        flux = torch.zeros((B, 3), dtype=torch.float32, device=dev)
        count = torch.zeros(B, dtype=torch.int32, device=dev)
        for lo in range(0, B, HASH_CHUNK):
            c = slice(lo, lo + HASH_CHUNK)
            pos, n, tp = hp.pos[c, None], hp.normal[c, None], hp.throughput[c]
            t_, b_, wo, a_ = tf[c, None], bf[c, None], wo_l[c, None], alpha[c]
            mtl = Material(base_color=hp.mtl.base_color[c, None],
                           roughness=hp.mtl.roughness[c, None],
                           metallic=hp.mtl.metallic[c, None],
                           eta=hp.mtl.eta[c, None])
            st, cq, valid = start[c], counts_q[c], hp.valid[c, None]
            f_c, n_c = flux[c], count[c]
            for k in range(kmax):
                off = k if stride is None else (k * stride[c]).to(torch.int64)
                rows = se[torch.clamp(st + off, max=E - 1)]    # (n, 27, 12)
                ev_pos, ev_n = rows[..., 0:3], rows[..., 3:6]
                ev_wi, ev_flux = rows[..., 6:9], rows[..., 9:12]
                d = pos - ev_pos
                ok = ((off < cq) & (dot(n, ev_n) > 0.01) & (dot(d, d) < r2)
                      & valid)
                wi_l = world_to_local(ev_wi, t_, b_, n)
                wh, wh_ok = _half_vector(wo, wi_l)
                brdf = _eval_local(mtl, wo.expand_as(wi_l), wi_l, a_[:, None],
                                   wh, wh_ok)
                ok &= is_valid_color(brdf)
                energy = ev_flux * brdf * tp[:, None]
                if stride is not None:
                    energy = energy * stride[c, :, None]
                f_c += torch.where(ok[..., None], energy,
                                   torch.zeros_like(energy)).sum(dim=1)
                n_c += ok.sum(dim=1, dtype=torch.int32)
        return flux, count, overflow


def gather_flux_dispatch(scene: Scene, cfg: RenderConfig, hp: HitPoints,
                         events: PhotonEvents, r2_scale=1.0,
                         tier: str = "auto"):
    """The photon gather of a PPM tier: #11's exact join (mega), its plain
    version (plain) or the spatial hash (hash).  Shared by
    ``render_ppm_with_stats`` and ``parallel/shard.py``'s sharded PPM."""
    gather = {"mega": gather_flux, "plain": gather_flux_plain,
              "hash": gather_flux_hash}[resolve_tier(scene, tier)]
    return gather(scene, cfg, hp, events, r2_scale)


def resolve_image(cfg: RenderConfig, direct, hp: HitPoints, flux,
                  r2_scale=1.0) -> torch.Tensor:
    """direct + flux / (pi r^2 r2_scale) on valid hitpoints, clamped."""
    area = (torch.tensor(PI * cfg.ppm_radius * cfg.ppm_radius)
            * torch.tensor(float(r2_scale)))
    with span("sync.ppm_area"):
        area = torch.clamp(area, min=1e-6).to(flux.device)
    radiance = flux / area
    radiance = torch.where((hp.valid & is_valid_color(radiance))[:, None],
                           clamp_radiance(radiance, cfg.clamp),
                           torch.zeros_like(radiance))
    return direct + radiance


def render_ppm_with_stats(scene: Scene, cam: Camera, width: int, height: int,
                          spl: int, cfg: RenderConfig, key, r2_scale=1.0,
                          tier: str = "auto"):
    """One PPM pass from the pass key ``key``: (image (H*W, 3), photon
    count (H*W,), overflow ()), ``Nl * spl`` photons."""
    tier = resolve_tier(scene, tier)
    plain = tier == "plain"
    with span("ppm.pass"):
        with span("ppm.eye_pass"):
            idx = torch.arange(width * height, dtype=torch.int32,
                               device=scene.device)
            direct, hp = ppm_eye_trace(scene, cam, cfg, idx % width,
                                       idx // width, rng.fold_in(key, 1),
                                       plain=plain)
        events = ppm_photon_trace(scene, cfg, scene.num_lights * spl, spl,
                                  rng.fold_in(key, 2), plain=plain)
        flux, count, overflow = gather_flux_dispatch(scene, cfg, hp, events,
                                                     r2_scale, tier)
        with span("ppm.resolve"):
            image = resolve_image(cfg, direct, hp, flux, r2_scale)
        return image, count, overflow


def render_ppm(scene: Scene, cam: Camera, width: int, height: int, spl: int,
               cfg: RenderConfig, key, pass_index: int = 0,
               tier: str = "auto") -> torch.Tensor:
    """One PPM pass's image, with pass ``pass_index``'s radius."""
    img, _, _ = render_ppm_with_stats(
        scene, cam, width, height, spl, cfg, key,
        ppm_radius_scale(pass_index, cfg.ppm_alpha), tier)
    return img
