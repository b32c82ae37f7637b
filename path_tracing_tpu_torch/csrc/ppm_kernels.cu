// Hand-written CUDA kernels of progressive photon mapping, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use, beside the other libraries):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libppm_kernels.so ppm_kernels.cu
//
// 10. photon_trace  replaces path_tracing_tpu/ops/pallas_photon.py
//                   photon_trace_pallas (_photon_kernel): the photon bounce
//                   loop of a pass, writing depth-slotted deposit events.
// 11. gather_flux   replaces path_tracing_tpu/ops/pallas_ppm_gather.py
//                   gather_flux_pallas (_gather_kernel): the exact join of
//                   hitpoints and photon events over 27 neighbour cells.
//
// #10: one thread per photon runs its whole bounce loop (nearest hit, the
// deposit, the BSDF sample, the flux update) and leaves it when the photon
// dies.  It draws the XLA scan's Threefry stream in the thread: bounce `it`
// takes rows 0-2 of fold_in(k408, it), k408 = fold_in(key, 0x408) from the
// host, at the lane's counter j*total + start + lane, so its events are the
// scan's and the plain version's.  A deposit is a non-delta bounce, which
// raises the photon's depth, so a photon deposits at most once per depth:
// event row dep*P + lane has one writer and needs no atomics.  Rows are
// [pos3, normal3, wi3, flux3], the layout the gather's prep sorts; the
// wrapper zeroes the valid flags, and rows never written are never read.
// Bound on this card: compute per thread.  Each bounce walks every sphere
// and the clusters the ray enters (45 primitive tests on the 36-triangle
// cornell box) for 12 events' worth of bytes, so the 218 MB of events a
// 1M-photon pass writes take 0.07 ms at 3.35 TB/s while the ray tests take
// longer; photons that die early leave their warp waiting on the longest
// path.  Sorting photons by their fate or compacting live lanes is later
// work.
//
// #11: one thread per hitpoint, in cell-sorted order, so the threads of a
// warp mostly share a cell, walk the same 9 event windows (the 27
// neighbour cells fold to 9 runs of 3 consecutive keys) and read the same
// event rows at the same time: the loads broadcast and the rows stay in
// L1/L2.  The per-hitpoint terms (frame, local wo, alpha, material) live in
// registers.  A pair passes the distance gate, then the normal gate, then
// is evaluated with eval_local; a BRDF that is not a valid colour drops the
// pair before the product, so NaN never reaches a sum.  Each thread sums
// its pairs in a fixed order (window 0..8, events in sorted order) and
// writes its flux (times the hitpoint's throughput) and count once, at the
// hitpoint's original index: deterministic, no atomics.
// Bound on this card: operations.  A 1M-photon pass on cornell at 512^2
// gives ~10^8-10^9 candidate pairs (each needs its distance test), against
// ~200 MB of rows read once.  A warp whose hitpoints straddle two cells
// walks both cells' windows with half its lanes idle; block-per-cell
// staging of the windows in shared memory is later work.

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr int kEvCols = 12;  // pos3 normal3 wi3 flux3
constexpr int kHpCols = 20;  // pos3 normal3 wo3 bc3 rough metal eta tp3 0 0
constexpr int kWinCols = 18; // [lo, hi) of windows 0..8

struct PhotonCfg {
  Key k408;               // fold_in(key, 0x408)
  uint32_t start, total;  // this photon is column start + i of a total-photon pass
  int light_depth, iters;
};

// One photon, iteration for iteration its lane of the XLA scan
// (path_tracing_tpu/integrators/ppm.py ppm_photon_trace): a lane that is
// not alive is untouched by later iterations, so the thread stops.
__global__ void photon_trace_kernel(Tables tb, const float* __restrict__ ro_in,
                                    const float* __restrict__ rd_in,
                                    const float* __restrict__ flux_in,
                                    const bool* __restrict__ real, PhotonCfg g, int P,
                                    float* __restrict__ ev, bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P || !real[i]) return;
  V3 ro = load3(ro_in, i), rd = load3(rd_in, i), flux = load3(flux_in, i);
  float eta = 1.0f;
  int dep = 0;
  for (int it = 0; it < g.iters; ++it) {
    HitRec h = nearest_hit_dev<false>(tb, ro, rd);
    // a miss, a light ball or the depth limit ends the photon
    if (h.flag != 1 || dep >= g.light_depth) break;
    const V3 n = h.n;
    const Mtl& m = h.m;
    V3 pos = ro + scale(rd, h.t);
    V3 wi_light = -rd;
    if ((m.eta <= 0.0f) && ((m.metal < 0.99f) || (m.rough > 0.01f))) {
      size_t r = (size_t)dep * P + i;
      float* row = ev + r * kEvCols;
      store3(row, 0, pos);
      store3(row, 1, n);
      store3(row, 2, wi_light);
      store3(row, 3, flux);
      valid[r] = true;
    }
    Key ki = fold_in(g.k408, (uint32_t)it);
    BsdfSample b = bsdf_sample_dev(m, wi_light, n, uniform_at(ki, 0, i, g.start, g.total),
                                   uniform_at(ki, 1, i, g.start, g.total),
                                   uniform_at(ki, 2, i, g.start, g.total), eta);
    if (!(b.pdf > 0.0f)) break;  // the photon pass kills pdf <= 0, deltas too
    float w = b.is_delta ? 1.0f : fabsf(dot3(n, b.wi)) / jmax(b.pdf, 1e-20f);
    V3 new_flux = scale(mul(flux, b.val), w);
    if (!valid3(new_flux)) break;
    V3 off = scale(dot3(b.wi, n) < 0.0f ? -n : n, kEps);
    ro = pos + off;
    rd = b.wi;
    flux = new_flux;
    eta = b.new_eta;
    dep += b.is_delta ? 0 : 1;
  }
}

struct GatherIn {
  const float* __restrict__ hp;     // (B, 20) cell-sorted hitpoint rows
  const int* __restrict__ hp_cell;  // (B,) the row's gathered cell, or -1
  const int* __restrict__ perm;     // (B,) the row's original hitpoint index
  const int* __restrict__ win;      // (C, 18) event windows of each cell
  const float* __restrict__ ev;     // (E, 12) key-sorted event rows
  float r2;
};

__global__ void gather_flux_kernel(GatherIn in, int B, float* __restrict__ flux_out,
                                   int* __restrict__ count_out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  const int cell = in.hp_cell[j];
  V3 acc = mk(0.f, 0.f, 0.f), tp = mk(0.f, 0.f, 0.f);
  int count = 0;
  if (cell >= 0) {
    const float* R = in.hp + (size_t)j * kHpCols;
    const V3 p = mk(R[0], R[1], R[2]);
    const V3 n = mk(R[3], R[4], R[5]);
    const Mtl m = {mk(R[9], R[10], R[11]), R[12], R[13], R[14]};
    tp = mk(R[15], R[16], R[17]);
    V3 t, b;
    build_frame(n, &t, &b);
    const V3 wo_l = to_local(mk(R[6], R[7], R[8]), t, b, n);
    const float alpha = roughness_to_alpha(m.rough);
    const int* W = in.win + (size_t)cell * kWinCols;
    const float4* ev4 = reinterpret_cast<const float4*>(in.ev);
    for (int o = 0; o < 9; ++o) {
      const int hi = W[2 * o + 1];
      for (int e = W[2 * o]; e < hi; ++e) {
        const float4 a = __ldg(ev4 + 3 * (size_t)e);  // pos3, normal.x
        float dx = p.x - a.x, dy = p.y - a.y, dz = p.z - a.z;
        if (!(dx * dx + dy * dy + dz * dz < in.r2)) continue;
        const float4 c = __ldg(ev4 + 3 * (size_t)e + 1);  // normal.yz, wi.xy
        if (!(dot3(n, mk(a.w, c.x, c.y)) > 0.01f)) continue;
        const float4 d = __ldg(ev4 + 3 * (size_t)e + 2);  // wi.z, flux3
        V3 wi_l = to_local(mk(c.z, c.w, d.x), t, b, n);
        bool ok;
        V3 wh = half_vector(wo_l, wi_l, &ok);
        V3 f = eval_local(m, wo_l, wi_l, alpha, wh, ok);
        if (!valid3(f)) continue;
        acc = acc + mul(mk(d.y, d.z, d.w), f);
        ++count;
      }
    }
  }
  const int i = in.perm[j];
  store3(flux_out, i, mul(acc, tp));
  count_out[i] = count;
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.

int pt_photon_trace(const float* sph, int ns, int nl, const float* tri, const float* uv,
                    const float* cl, int nc, const float* ro, const float* rd, const float* flux,
                    const bool* real, int P, uint32_t k0, uint32_t k1, uint32_t start,
                    uint32_t total, int light_depth, int iters, float* ev, bool* valid,
                    void* stream) {
  PhotonCfg g{{k0, k1}, start, total, light_depth, iters};
  photon_trace_kernel<<<blocks_for(P), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, uv, cl, nc), ro, rd, flux, real, g, P, ev, valid);
  return (int)cudaGetLastError();
}

int pt_gather_flux(const float* hp, const int* hp_cell, const int* perm, int B, const int* win,
                   const float* ev, float r2, float* flux, int* count, void* stream) {
  GatherIn in{hp, hp_cell, perm, win, ev, r2};
  gather_flux_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(in, B, flux, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
