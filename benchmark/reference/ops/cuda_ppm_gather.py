"""The exact PPM photon gather (counterpart of
``path_tracing_tpu.ops.pallas_ppm_gather``).

For every valid hitpoint: the sum, over the valid photon events within the
search radius whose normal agrees (``n_hp . n_ev > 0.01``), of the event's
flux times the hitpoint's BRDF (``eval_local``), times the hitpoint's
throughput, and the number of such events.  A pair whose BRDF is not a
valid colour is dropped before the product.  There is no per-cell budget
and no subsampling.

The join runs on cell keys, as the JAX package's kernel runs it: cells of
side ``max(radius, extent / (G - 4))`` keyed lexicographically
``(cx * G + cy) * G + cz`` (collision-free), invalid rows keyed ``BIG``.
``prepare`` (PyTorch) sorts the events by key (stable, so ties keep the
event order: depth slot, then lane), keeps the first ``cap`` of them
(``cfg.ppm_event_cap_frac``), sorts the hitpoints by key, gives each of the
first ``max_cells`` occupied hitpoint cells its 9 event windows (the 27
neighbour cells fold to 9 runs of 3 consecutive keys, found with
``searchsorted``) and packs the rows the join reads.  Hitpoints of later
cells and valid events past the cap are dropped and counted in the
overflow.

``join_plain``, the plain version of the ``gather_flux`` kernel (#11),
expands the candidate pairs of a chunk of hitpoints and sums them with
``index_add_`` in the kernel's window and event order.  Given a
``counts`` dict (``new_counts``) it counts the work the kernel does
(``PLAIN_COUNTS``), which its roofline is bounded by.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bsdf import _eval_local, _half_vector
from .cuda_connect import _tally
from .frame import build_local_frame, world_to_local
from .math3 import dot, is_valid_color
from .microfacet import roughness_to_alpha
from ..scene.types import Material

G = 200            # cells per axis in the key domain (G^3 < 2^23)
BIG = 2 ** 23 - 1  # key of invalid rows, above every window's top
# (dx, dy) neighbour offsets in key units; dz is the +-1 of each window
OFFS = tuple((dx * G + dy) * G for dx in (-1, 0, 1) for dy in (-1, 0, 1))
EV_CHUNK = 1024    # the event cap rounds up to a multiple of this
HP_COLS = 20       # pos3 normal3 wo3 bc3 rough metal eta tp3 0 0
EV_COLS = 12       # pos3 normal3 wi3 flux3
_PAIR_CHUNK = 1 << 22   # candidate pairs per step of the plain join
# The counting build's counters: candidate pairs, pairs past the distance
# gate, past both gates, evaluations, accepted pairs; the lanes and 32
# slots of the pair test and of the evaluation (their ratio is the SIMT
# efficiency); the warps that ran, and the largest warp's candidate pairs.
# The plain join counts the first five.
COUNT_NAMES = ("pairs", "near", "facing", "evals", "accepted", "pair_lanes",
               "pair_slots", "eval_lanes", "eval_slots", "warps",
               "warp_pairs_max")
PLAIN_COUNTS = COUNT_NAMES[:5]


def _cell_size(scene, cfg) -> torch.Tensor:
    """Radius-sized cells, grown when the scene outruns the G^3 keys (a
    cell no smaller than the radius keeps the search ball inside the 27
    neighbours)."""
    ext = torch.max(scene.scene_max - scene.scene_min)
    return torch.maximum(torch.tensor(float(cfg.ppm_radius),
                                      device=ext.device), ext / (G - 4))


def _keys(pos: torch.Tensor, origin: torch.Tensor, cell: torch.Tensor
          ) -> torch.Tensor:
    """Cell key of each position; cells are clipped into [0, G - 1]."""
    rel = torch.floor((pos - origin) / cell)
    # clip before the conversion, whose result is undefined out of range
    c = torch.clamp(rel, -1.0, float(G)).to(torch.int32) + 1
    c = torch.clamp(c, 0, G - 1)
    return (c[:, 0] * G + c[:, 1]) * G + c[:, 2]


def event_cap(E: int, frac: float) -> int:
    """Sorted events kept: ``frac`` of ``E`` rounded up to EV_CHUNK, at
    least one chunk, at most ``E``."""
    frac = min(max(float(frac), 0.0), 1.0)
    return min(E, max(EV_CHUNK, int(-(-E * frac // EV_CHUNK)) * EV_CHUNK))


@dataclass
class GatherTables:
    """What the join reads: hitpoint rows in cell order, each row's cell
    (-1: not gathered) and original index, every gathered cell's 9 event
    windows ``[lo, hi)`` and the key-sorted event rows."""

    hp: torch.Tensor       # (B, 20) float32
    hp_cell: torch.Tensor  # (B,) int32
    perm: torch.Tensor     # (B,) int32
    win: torch.Tensor      # (C, 18) int32
    ev: torch.Tensor       # (cap, 12) float32
    r2: float
    overflow: torch.Tensor  # () int64: hitpoints and valid events dropped


def prepare(scene, cfg, hp, events, r2_scale=1.0,
            max_cells: int | None = None) -> GatherTables:
    """Sort, cap and pack a pass's hitpoints ``hp`` and events ``events``
    (``integrators.ppm.HitPoints`` / ``PhotonEvents``) for the join."""
    cmax = int(max_cells or cfg.ppm_max_cells)
    dev = hp.pos.device
    origin = scene.scene_min
    cell = _cell_size(scene, cfg)

    E = events.valid.shape[0]
    ekey = torch.where(events.valid, _keys(events.pos, origin, cell),
                       torch.full_like(events.valid, BIG, dtype=torch.int32))
    cap = event_cap(E, cfg.ppm_event_cap_frac)
    skey, eorder = torch.sort(ekey.long(), stable=True)
    skey, eorder = skey[:cap], eorder[:cap]
    ev = events.table[eorder]
    ev_dropped = torch.clamp(events.valid.sum() - cap, min=0)

    hkey = torch.where(hp.valid, _keys(hp.pos, origin, cell),
                       torch.full_like(hp.valid, BIG, dtype=torch.int32))
    shkey, perm = torch.sort(hkey.long(), stable=True)
    real = shkey < BIG
    prev = torch.cat([shkey.new_full((1,), -1), shkey[:-1]])
    starts = real & (shkey != prev)
    rank = torch.cumsum(starts.long(), 0) - 1
    gathered = real & (rank < cmax)
    hp_cell = torch.where(gathered, rank, torch.full_like(rank, -1))
    cell_keys = shkey[starts][:cmax]
    offs = torch.tensor(OFFS, dtype=torch.int64, device=dev)
    qlo = cell_keys[:, None] + offs[None, :] - 1                 # (C, 9)
    lo = torch.searchsorted(skey, qlo, side="left")
    hi = torch.searchsorted(skey, qlo + 2, side="right")
    win = torch.stack([lo, hi], dim=-1).reshape(-1, 18)

    m = hp.mtl
    rows = torch.cat([hp.pos, hp.normal, hp.wo, m.base_color,
                      m.roughness[:, None], m.metallic[:, None],
                      m.eta[:, None], hp.throughput,
                      torch.zeros((hp.pos.shape[0], 2), device=dev)], dim=1)
    overflow = real.sum() - gathered.sum() + ev_dropped
    # the squared radius rounded as float32, as the kernel takes it
    r2 = float(np.float32(cfg.ppm_radius * cfg.ppm_radius)
               * np.float32(r2_scale))
    return GatherTables(
        hp=rows[perm].contiguous(), hp_cell=hp_cell.to(torch.int32),
        perm=perm.to(torch.int32), win=win.to(torch.int32).contiguous(),
        ev=ev.contiguous(), r2=r2, overflow=overflow)


def _pair_chunks(pairs: torch.Tensor):
    """[a, b) row ranges holding about _PAIR_CHUNK pairs each (a row with
    more is a chunk of its own)."""
    cum = np.cumsum(pairs.cpu().numpy())
    out, a, done = [], 0, 0
    while a < len(cum):
        b = max(int(np.searchsorted(cum, done + _PAIR_CHUNK, "right")), a + 1)
        out.append((a, b))
        done, a = int(cum[b - 1]), b
    return out


def new_counts() -> dict:
    return {k: 0 for k in COUNT_NAMES}


def join_plain(t: GatherTables, counts: dict | None = None):
    """Plain PyTorch version of the ``gather_flux`` kernel: (flux (B, 3),
    count (B,) int32) by original hitpoint index.  ``counts`` (from
    ``new_counts``), if given, gains the kernel's work (``PLAIN_COUNTS``);
    the work list is not read."""
    B = t.hp.shape[0]
    dev = t.hp.device
    flux = torch.zeros((B, 3), device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    sel = torch.nonzero(t.hp_cell >= 0)[:, 0]
    if sel.numel() == 0:
        return flux, count
    h = t.hp[sel]
    win = t.win[t.hp_cell[sel].long()].long()
    lo, lens = win[:, 0::2], win[:, 1::2] - win[:, 0::2]         # (n, 9)
    p, nrm = h[:, 0:3], h[:, 3:6]
    tf, bf = build_local_frame(nrm)
    wo_l = world_to_local(h[:, 6:9], tf, bf, nrm)
    alpha = roughness_to_alpha(h[:, 12])
    acc = torch.zeros((h.shape[0], 3), device=dev)
    cnt = torch.zeros(h.shape[0], dtype=torch.int64, device=dev)
    for a, b in _pair_chunks(lens.sum(dim=1)):
        # pairs (row, window, k) in the kernel's order: row, then window
        # 0..8, then the window's events in sorted order
        ln = lens[a:b].reshape(-1)
        seg = torch.repeat_interleave(torch.arange(ln.numel(), device=dev),
                                      ln)
        first = torch.cumsum(ln, 0) - ln
        k = torch.arange(seg.numel(), device=dev) - first[seg]
        e = lo[a:b].reshape(-1)[seg] + k
        r = a + torch.div(seg, 9, rounding_mode="floor")
        ev = t.ev[e]
        d = p[r] - ev[:, 0:3]
        close = dot(d, d) < t.r2
        near = close & (dot(nrm[r], ev[:, 3:6]) > 0.01)
        if counts is not None:
            counts["pairs"] += seg.numel()
            _tally(counts, "near", close)
            _tally(counts, "facing", near)
            _tally(counts, "evals", near)
        r, ev = r[near], ev[near]
        wi_l = world_to_local(ev[:, 6:9], tf[r], bf[r], nrm[r])
        wh, wh_ok = _half_vector(wo_l[r], wi_l)
        mtl = Material(base_color=h[r, 9:12], roughness=h[r, 12],
                       metallic=h[r, 13], eta=h[r, 14])
        f = _eval_local(mtl, wo_l[r], wi_l, alpha[r], wh, wh_ok)
        ok = is_valid_color(f)
        _tally(counts, "accepted", ok)
        acc.index_add_(0, r[ok], ev[ok, 9:12] * f[ok])
        cnt.index_add_(0, r[ok], torch.ones_like(r[ok]))
    idx = t.perm[sel].long()
    flux[idx] = acc * h[:, 15:18]
    count[idx] = cnt.to(torch.int32)
    return flux, count


