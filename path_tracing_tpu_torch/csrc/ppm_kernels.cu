// Hand-written CUDA kernels of progressive photon mapping, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use, beside the other libraries):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libppm_kernels.so ppm_kernels.cu
//
// 10. photon_trace  replaces path_tracing_tpu/ops/pallas_photon.py
//                   photon_trace_pallas (_photon_kernel): the photon bounce
//                   loop of a pass, writing depth-slotted deposit events.
//                   photon_trace_tex is its textured instance: the
//                   with_uv hit and the bilinear texel of a textured
//                   triangle multiplied into its base color before the
//                   deposit and the BSDF sample, as the JAX package's XLA
//                   photon scan (integrators/ppm.py:245-283) textures its
//                   hits through find_closest_hit (its photon megakernel
//                   does not: it traces textured scenes untextured).
// 11. gather_flux   replaces path_tracing_tpu/ops/pallas_ppm_gather.py
//                   gather_flux_pallas (_gather_kernel): the exact join of
//                   hitpoints and photon events over 27 neighbour cells.
//     ppm_eye       replaces no TPU kernel: the JAX package runs the eye
//                   pass as an XLA loop (path_tracing_tpu/integrators/
//                   ppm.py ppm_eye_trace) around nearest_hit_pallas (#1).
//                   Added because in PyTorch that loop is ~3,100 small
//                   launches and 19 host reads a pass, and kept the card
//                   idle four fifths of the pass: here the chase, its
//                   Threefry draws and the hitpoint record are one launch.
//                   ppm_eye_tex is its textured instance.
//
// #10: the design for this card.  Persistent blocks of kPhotonThreads fill
// the card (as many an SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives at the first launch: 8); each lane traces one photon at a time
// through its whole bounce loop (nearest hit, the deposit, the BSDF
// sample, the flux update) and, when the photon dies,
// takes the next photon index from a global counter (one atomicAdd a warp
// step for the lanes that need work, ballot and shuffle; indices that are
// not real are skipped).  Photons live 1 to iters bounces (light depth
// plus the delta budget; mirror and glass chains run longest), so one
// thread a photon left each warp waiting on its longest photon: its lanes
// were busy 0.48 of their warp's bounce slots on cornell's first 512^2
// pass, and are 0.89 here (the rest is the tail, when the counter has run
// out and the last photons finish).  The photon keeps its own index: it
// draws the XLA scan's Threefry stream (bounce it takes rows 0-2 of
// fold_in(k408, it), k408 = fold_in(key, 0x408) from the host, at counter
// j*total + start + photon), so its events are the scan's and the plain
// version's, and the atomic only hands out work.  A deposit is a
// non-delta bounce, which raises the photon's depth, so a photon deposits
// at most once per depth: event row dep*P + photon has one writer and
// needs no atomics.  Rows are [pos3, normal3, wi3, flux3] (48 bytes, the
// layout the gather's prep sorts), written as three 16-byte stores; the
// wrapper zeroes the valid flags and the counter, and rows never written
// are never read.  Measured on an H100 (PERF.md section 6): 1.22 ms
// against the one-thread-a-photon kernel's 1.98 in turns, bit-equal on
// every event row.  The parent already held 8 blocks an SM (62
// registers), so the gain is work stealing's; __launch_bounds__ for 6
// blocks (62 registers, 8 resident) ran 0.5-1% faster than for 8 (60) or
// none, for 10 and 12 (48 and 40 registers, spilling) 1-9% slower, and
// fewer resident blocks (4 or 6 an SM: a shorter tail, less latency
// hidden) 4-19% slower.
// Bound on this card: operations.  A pass of 1M photons on cornell makes
// 4.4 bounces a photon, each walking every sphere and cluster box and the
// triangles of the boxes it enters (24.5 a bounce), for 48 bytes an event
// (155 MB) written once.  The counting build (kCount) counts the photons,
// the bounces, the walk's tests, the BSDF samples, draws and deposits, the
// SIMT efficiency of the bounce step and each warp's most bounces in one
// lane (the busy share of its lanes).
//
// #11: the design for this card.  prepare (ops/cuda_ppm_gather.py) cuts
// the gathered hitpoint rows into work items: a cell's rows in sorted
// order, at most kGatherRows of them, heaviest first (rows x the cell's
// candidate events).  One block of kGatherRows threads takes one item, one
// thread per hitpoint, so a warp never straddles two cells and a
// hitpoint's whole sum stays in one thread.  The block streams its cell's
// 9 event windows (the 27 neighbour cells fold to 9 runs of 3 consecutive
// keys) through shared memory, kGatherTile events a stage, double-buffered
// with cp.async: each event row leaves L2 once per item and every thread
// reads it as a broadcast.  A thread gates its hitpoint against 32 staged
// events at a time (the distance gate, then the normal gate), keeping a
// 32-bit mask of the pairs that pass both.  The warp then packs its set
// bits lane after lane (a prefix count of the masks) and evaluates them 32
// at a time, one pair a lane, each lane reading its pair's hitpoint terms
// from shared memory; each lane then adds its own results in event order.
// So the evaluation (eval_local, most of the work) runs on full warps,
// where a lane evaluating its own set bits left the warp waiting on its
// busiest lane, and a pair evaluated where it passed its gates waited on
// every lane's branch (PERF.md section 6 has the three, and events read
// straight from global memory).  A BRDF that is not a valid colour drops
// the pair before the product, so NaN never reaches a sum.  Sums keep the
// parent's order (window 0..8, events in sorted order), so flux and count
// are its own bit for bit; each thread writes them once, at the
// hitpoint's original index: deterministic, no atomics.  Rows no item
// holds keep the wrapper's zeros.
// Bound on this card: operations.  A 1M-photon pass on cornell at 512^2
// tests ~9e8 candidate pairs and evaluates about a third of them, against
// ~100 MB of rows read once.  The counting build (kCount) counts the pairs,
// the gates, the evaluations and the accepted pairs, the SIMT efficiency
// of the pair test and the evaluation, and each warp's candidate pairs
// (the largest against the mean: how far the densest cells set the pace).
//
// ppm_eye: the design for this card.  A pixel's delta chain (mirrors and
// glass, up to max_eye_iters hits) runs in one thread, iteration for
// iteration the pixel's lane of the PyTorch loop (ops/cuda_ppm_eye.py::
// ppm_eye_plain): the jittered camera ray from rows 0-1 of
// fold_in(key, 0x9E1), iteration it's draws rows 0-2 of
// fold_in(fold_in(key, 0x9E2), it) at the pixel's lane, nearest_hit_dev
// (#1's walk; the texel on a textured scene, as #10), and the BSDF sample
// only on a delta surface (a rough one ends the chain with the hitpoint,
// which needs no sample).  Each lane writes its direct term and hitpoint
// record once, zeros where it has none, so the wrapper allocates with
// torch.empty and the pass reads nothing back.  Under --fmad=false every
// value rounds as the loop's PyTorch ops round it (the clamp's division
// as Tensor.__rtruediv__ does: the reciprocal, then the product).
// Bound on this card: operations (a walk per chain link and a BSDF sample
// per delta link, against 85 bytes a pixel written once and 8 read).  One thread a pixel: most chains
// end at the first hit (walls and the rough spheres), so the lanes of a
// warp mostly run one link together.  #10's per-lane work stealing on
// persistent blocks measured 8% slower on cornell's 512^2 pass (0.115
// against 0.106 ms device-only, in turns) and 1% faster on the
// 327,680-triangle textured icosphere's (PERF.md section 6).

#include <algorithm>
#include <type_traits>

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEvCols = 12;  // pos3 normal3 wi3 flux3
constexpr int kHpCols = 20;  // pos3 normal3 wo3 bc3 rough metal eta tp3 0 0
constexpr int kWinCols = 18; // [lo, hi) of windows 0..8

struct PhotonCfg {
  Key k408;               // fold_in(key, 0x408)
  uint32_t start, total;  // this photon is column start + i of a total-photon pass
  int light_depth, iters;
};

constexpr int kPhotonThreads = 128;
constexpr int kPhotonMinBlocks = 6;  // __launch_bounds__: at most 85 registers

// #10's counters (ops/cuda_photon.py::COUNT_NAMES): the walk's tests at
// the BDPT kernels' indices (kHitSph, kHitBox, kHitTri), then its own
enum PhotonCountIdx {
  kPhotons = kNumCounts, kBounces, kPSamples, kPDraws, kDeposits, kBounceLanes, kBounceSlots,
  kWarpBounceSlots, kPhotonCounts
};

// Each lane traces the photons it takes, one at a time, iteration for
// iteration the photon's lane of the XLA scan (path_tracing_tpu/
// integrators/ppm.py ppm_photon_trace): a lane that is not alive is
// untouched by later iterations, so the photon is done.  A lane whose
// photon is done takes the next index from *work (one atomicAdd a warp
// step for the lanes that need one); indices that are not real are
// skipped.  The photon keeps its own index, so its draws and its event
// rows are the one-thread-per-photon kernel's.  kW: the walk (an instance
// per walk, pt_device.cuh::WalkKind).
// kTex: the textured instance (tx, the atlas).
template <bool kCount, int kW, bool kTex = false>
__global__ void __launch_bounds__(kPhotonThreads, kPhotonMinBlocks)
    photon_trace_kernel(Tables tb, Tex tx, const float* __restrict__ ro_in,
                        const float* __restrict__ rd_in, const float* __restrict__ flux_in,
                        const bool* __restrict__ real, PhotonCfg g, int P, int* __restrict__ work,
                        float* __restrict__ ev, bool* __restrict__ valid,
                        unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, CountN<kPhotonCounts>, NoCount>::type cnt;
  const int lane = threadIdx.x & 31;
  int i = -1;         // the lane's photon: -1 before its first, >= P once the work is out
  bool live = false;  // the photon bounces on
  V3 ro = mk(0.f, 0.f, 0.f), rd = ro, flux = ro;
  float eta = 1.0f;
  int dep = 0, it = 0;
  unsigned my_bounces = 0;
  while (true) {
    // ---- a lane whose photon is done takes the next ----
    const bool need = !live && i < P;
    const unsigned nm = __ballot_sync(kFull, need);
    if (nm) {
      const int leader = __ffs(nm) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(work, __popc(nm));
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        i = base + __popc(nm & ((1u << lane) - 1u));
        if (i < P && real[i]) {
          ro = load3(ro_in, i);
          rd = load3(rd_in, i);
          flux = load3(flux_in, i);
          eta = 1.0f;
          dep = it = 0;
          live = g.iters > 0;
          cnt.add(kPhotons);
        }
      }
    }
    if (!__any_sync(kFull, live || i < P)) break;
    if (!live) continue;  // no photon this step; its warp goes on

    // ---- one bounce of the lane's photon ----
    ++my_bounces;
    cnt.add(kBounces);
    cnt.simt(kBounceLanes);
    HitRec h = nearest_hit_dev<kTex, kW>(tb, ro, rd, cnt);
    if (kTex) {
      const int tex_id = (int)h.tex;
      if (tex_id >= 0) h.m.bc = mul(h.m.bc, sample_bilinear_dev(tx, tex_id, h.iu, h.iv));
    }
    live = false;
    // a miss, a light ball or the depth limit ends the photon
    if (h.flag == 1 && dep < g.light_depth) {
      const V3 n = h.n;
      const Mtl& m = h.m;
      const V3 pos = ro + scale(rd, h.t);
      const V3 wi_light = -rd;
      if ((m.eta <= 0.0f) && ((m.metal < 0.99f) || (m.rough > 0.01f))) {
        // the deposit row [pos3 normal3 wi3 flux3] as three 16-byte stores
        const size_t r = (size_t)dep * P + i;
        float4* row = reinterpret_cast<float4*>(ev + r * kEvCols);
        row[0] = make_float4(pos.x, pos.y, pos.z, n.x);
        row[1] = make_float4(n.y, n.z, wi_light.x, wi_light.y);
        row[2] = make_float4(wi_light.z, flux.x, flux.y, flux.z);
        valid[r] = true;
        cnt.add(kDeposits);
      }
      cnt.add(kPSamples);
      cnt.add(kPDraws, 3u);
      const Key ki = fold_in(g.k408, (uint32_t)it);
      const BsdfSample b =
          bsdf_sample_dev(m, wi_light, n, uniform_at(ki, 0, i, g.start, g.total),
                          uniform_at(ki, 1, i, g.start, g.total),
                          uniform_at(ki, 2, i, g.start, g.total), eta);
      if (b.pdf > 0.0f) {  // the photon pass kills pdf <= 0, deltas too
        const float w = b.is_delta ? 1.0f : fabsf(dot3(n, b.wi)) / jmax(b.pdf, 1e-20f);
        const V3 new_flux = scale(mul(flux, b.val), w);
        if (valid3(new_flux)) {
          const V3 off = scale(dot3(b.wi, n) < 0.0f ? -n : n, kEps);
          ro = pos + off;
          rd = b.wi;
          flux = new_flux;
          eta = b.new_eta;
          dep += b.is_delta ? 0 : 1;
          live = ++it < g.iters;
        }
      }
    }
  }
  if constexpr (kCount) {
    unsigned mx = my_bounces;
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_down_sync(kFull, mx, o));
    if (lane == 0) cnt.add(kWarpBounceSlots, 32u * mx);
    cnt.flush(counts);
  }
}

template <bool kCount, int kW, bool kTex = false>
int launch_photon(const Tables& tb, const float* ro, const float* rd, const float* flux,
                  const bool* real, int P, const PhotonCfg& g, int* work, float* ev, bool* valid,
                  unsigned long long* counts, void* stream, const Tex& tx) {
  // persistent blocks: as many as the card holds at once, or fewer
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, photon_trace_kernel<kCount, kW, kTex>, kPhotonThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  const int blocks = std::min(resident, (P + kPhotonThreads - 1) / kPhotonThreads);
  photon_trace_kernel<kCount, kW, kTex><<<blocks, kPhotonThreads, 0, (cudaStream_t)stream>>>(
      tb, tx, ro, rd, flux, real, g, P, work, ev, valid, counts);
  return (int)cudaGetLastError();
}

constexpr int kEyeThreads = 128;
constexpr int kEyeMinBlocks = 6;  // __launch_bounds__: at most 85 registers, as #10

struct EyeCfg {
  Key k_jit, k_it;        // fold_in(key, 0x9E1), fold_in(key, 0x9E2)
  uint32_t start, total;  // pixel lane i is column start + i of a total-lane pass
  int iters;              // max_eye_iters
  float clamp;
};

// The pass's outputs: the direct term and the hitpoint record, (B, 3) or
// (B,) each
struct EyeOut {
  float *direct, *pos, *normal, *wo, *bc, *rough, *metal, *eta, *tp;
  bool* valid;
};

// A lane's chain: its pixel, ray, throughput, medium and iteration.
struct EyeChain {
  int i;
  V3 ro, rd, tp;
  float eta;
  int it;
};

// ops/math3.py::clamp_radiance as PyTorch rounds it: max_val / m is
// Tensor.__rtruediv__, m's reciprocal times max_val.
__device__ __forceinline__ V3 clamp3_rdiv(V3 c, float mx) {
  const float m = jmax(c.x, jmax(c.y, c.z));
  return scale(c, m > mx ? (1.0f / m) * mx : 1.0f);
}

__device__ __forceinline__ void eye_write(const EyeOut& o, int i, V3 direct, bool deposit, V3 pos,
                                          V3 n, V3 wo, const Mtl& m, V3 tp) {
  const V3 z = mk(0.f, 0.f, 0.f);
  store3(o.direct, i, direct);
  store3(o.pos, i, deposit ? pos : z);
  store3(o.normal, i, deposit ? n : z);
  store3(o.wo, i, deposit ? wo : z);
  store3(o.bc, i, deposit ? m.bc : z);
  o.rough[i] = deposit ? m.rough : 0.f;
  o.metal[i] = deposit ? m.metal : 0.f;
  o.eta[i] = deposit ? m.eta : 0.f;
  store3(o.tp, i, deposit ? tp : z);
  o.valid[i] = deposit;
}

// Pixel i's chain before its first hit; a pass of no iterations writes
// its zeros here.
__device__ __forceinline__ EyeChain eye_start(const Cam& cam, const int* __restrict__ px,
                                              const int* __restrict__ py, const EyeCfg& g,
                                              const EyeOut& o, int i) {
  const float jx = uniform_at(g.k_jit, 0, (uint32_t)i, g.start, g.total);
  const float jy = uniform_at(g.k_jit, 1, (uint32_t)i, g.start, g.total);
  const V3 z = mk(0.f, 0.f, 0.f);
  if (g.iters <= 0) eye_write(o, i, z, false, z, z, z, Mtl{z, 0.f, 0.f, 0.f}, z);
  return {i, cam.eye, primary_dir(cam, (float)px[i] + jx, (float)py[i] + jy), mk(1.f, 1.f, 1.f),
          1.0f, 0};
}

// One iteration of chain c: true when the chain ends here, its outputs
// written.  A miss ends it with nothing; a light ball with its radiance
// through the chain (assigned, not added; zero if not a valid colour); a
// rough surface with the hitpoint; a delta sample of pdf > 0 moves the
// ray, and the chain goes on while its throughput is a valid colour and
// iterations remain.
template <int kW, bool kTex>
__device__ bool eye_step(const Tables& tb, const Tex& tx, const EyeCfg& g, const EyeOut& o,
                         EyeChain& c) {
  NoCount cnt;
  HitRec h = nearest_hit_dev<kTex, kW>(tb, c.ro, c.rd, cnt);
  if (kTex) {
    const int tex_id = (int)h.tex;
    if (tex_id >= 0) h.m.bc = mul(h.m.bc, sample_bilinear_dev(tx, tex_id, h.iu, h.iv));
  }
  const V3 z = mk(0.f, 0.f, 0.f);
  const Mtl& m = h.m;
  const V3 pos = c.ro + scale(c.rd, h.t);
  V3 direct = z;
  bool deposit = false;
  if (h.flag == 2) {
    const V3 e = mul(c.tp, m.bc);
    if (valid3(e)) direct = clamp3_rdiv(e, g.clamp);
  } else if (h.flag == 1) {
    const bool diel = (m.eta > 0.0f) && (m.rough < 0.001f) && (m.metal < 0.01f);
    deposit = !diel && !((m.metal > 0.99f) && (m.rough < 0.001f));
    if (!deposit) {
      const Key ki = fold_in(g.k_it, (uint32_t)c.it);
      const BsdfSample b = bsdf_sample_dev(m, -c.rd, h.n, uniform_at(ki, 0, c.i, g.start, g.total),
                                           uniform_at(ki, 1, c.i, g.start, g.total),
                                           uniform_at(ki, 2, c.i, g.start, g.total), c.eta);
      if (b.pdf > 0.0f) {
        const V3 tp = mul(c.tp, b.val);
        if (valid3(tp)) {
          c.ro = pos + scale(dot3(b.wi, h.n) < 0.0f ? -h.n : h.n, kEps);
          c.rd = b.wi;
          c.tp = tp;
          c.eta = b.new_eta;
          if (++c.it < g.iters) return false;
        }
      }
    }
  }
  eye_write(o, c.i, direct, deposit, pos, h.n, -c.rd, m, c.tp);
  return true;
}

// The eye pass of B pixels.  kW: the walk (an instance per walk,
// pt_device.cuh::WalkKind); kTex: the textured instance (tx, the atlas).
template <int kW, bool kTex>
__global__ void __launch_bounds__(kEyeThreads, kEyeMinBlocks)
    ppm_eye_kernel(Tables tb, Tex tx, const float* __restrict__ cam_tab,
                   const int* __restrict__ px, const int* __restrict__ py, EyeCfg g, int B,
                   EyeOut o) {
  const int i = blockIdx.x * kEyeThreads + threadIdx.x;
  if (i >= B) return;
  const Cam cam = load_cam(cam_tab);
  EyeChain c = eye_start(cam, px, py, g, o, i);
  if (g.iters > 0)
    while (!eye_step<kW, kTex>(tb, tx, g, o, c)) {
    }
}

template <int kW, bool kTex>
int launch_eye(const Tables& tb, const Tex& tx, const float* cam, const int* px, const int* py,
               int B, const EyeCfg& g, const EyeOut& o, void* stream) {
  ppm_eye_kernel<kW, kTex><<<(B + kEyeThreads - 1) / kEyeThreads, kEyeThreads, 0,
                             (cudaStream_t)stream>>>(tb, tx, cam, px, py, g, B, o);
  return (int)cudaGetLastError();
}

constexpr int kGatherRows = 32;   // rows of a work item at most: the block, one thread each
constexpr int kGatherTile = 128;  // events a shared-memory stage holds
constexpr int kSub = 32;          // events a thread gates before the warp evaluates
constexpr int kGatherMinBlocks = 32;  // __launch_bounds__: at most 64 registers
constexpr int kHpFields = 19;     // a lane's hitpoint terms the packed evaluation reads

// A warp's packed evaluations: each lane's hitpoint terms (t3 b3 n3 wo_l3
// bc3 rough metal eta alpha), each lane's mask and the end of its entries,
// and one batch's results (structure of arrays: lane j touches word j).
struct EvalWarp {
  float hp[kHpFields][32];
  unsigned mask[32], end[32];
  float f[3][32];
  int ok[32];
};

// the gather's counters (ops/cuda_ppm_gather.py::COUNT_NAMES), warps and
// the largest warp's candidate pairs last
enum GatherCountIdx {
  kPairs, kNear, kFacing, kGEvals, kAccepted, kPairLanes, kPairSlots, kGEvalLanes,
  kGEvalSlots, kGWarps, kWarpPairsMax, kGatherCounts
};

struct GatherIn {
  const float* __restrict__ hp;    // (B, 20) cell-sorted hitpoint rows
  const int* __restrict__ perm;    // (B,) the row's original hitpoint index
  const int* __restrict__ win;     // (C, 18) event windows of each cell
  const float* __restrict__ ev;    // (E, 12) key-sorted event rows
  const int4* __restrict__ items;  // (N,) cell, first row, rows (0: padding), events
  float r2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kCount>
__global__ void __launch_bounds__(kGatherRows, kGatherMinBlocks)
    gather_flux_kernel(GatherIn in, float* __restrict__ flux_out, int* __restrict__ count_out,
                       unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) float4 stage[2][kGatherTile * 3];
  __shared__ int w_lo[9], w_pre[10];
  __shared__ EvalWarp eval_warps[kGatherRows / 32];
  const int4 item = in.items[blockIdx.x];
  if (item.z <= 0) return;  // the list's padding: the whole block leaves
  typename std::conditional<kCount, CountN<kGWarps>, NoCount>::type cnt;
  const int tid = threadIdx.x;
  if (tid == 0) {  // the cell's windows as one run of E events
    const int* W = in.win + (size_t)item.x * kWinCols;
    int e = 0;
    for (int o = 0; o < 9; ++o) {
      w_lo[o] = W[2 * o];
      w_pre[o] = e;
      e += W[2 * o + 1] - W[2 * o];
    }
    w_pre[9] = e;
  }
  __syncthreads();
  const int E = w_pre[9];
  const float4* ev4 = reinterpret_cast<const float4*>(in.ev);
  // stage events [t * kGatherTile, ...) of the run into buffer `buf`
  auto load_tile = [&](int t, int buf) {
    const int base = t * kGatherTile;
    const int n = min(kGatherTile, E - base) * 3;
    for (int k = tid; k < n; k += kGatherRows) {
      const int v = base + k / 3;
      int o = 0;
#pragma unroll
      for (int q = 1; q < 9; ++q) o += (w_pre[q] <= v);
      const size_t e = (size_t)(w_lo[o] + (v - w_pre[o]));
      cp_async16(&stage[buf][k], ev4 + 3 * e + k % 3);
    }
    cp_async_commit();
  };

  const bool has = tid < item.z;
  const int j = item.y + tid;
  V3 p = mk(0.f, 0.f, 0.f), n = p, t = p, b = p, wo_l = p, tp = p;
  Mtl m = {p, 0.f, 0.f, 0.f};
  float alpha = 0.f;
  if (has) {
    const float* R = in.hp + (size_t)j * kHpCols;
    p = mk(R[0], R[1], R[2]);
    n = mk(R[3], R[4], R[5]);
    m = {mk(R[9], R[10], R[11]), R[12], R[13], R[14]};
    tp = mk(R[15], R[16], R[17]);
    build_frame(n, &t, &b);
    wo_l = to_local(mk(R[6], R[7], R[8]), t, b, n);
    alpha = roughness_to_alpha(m.rough);
  }
  V3 acc = mk(0.f, 0.f, 0.f);
  int count = 0;
  const int lane = tid & 31;
  EvalWarp& ew = eval_warps[tid >> 5];
  const float terms[kHpFields] = {t.x,    t.y,    t.z,    b.x,     b.y,     b.z,   n.x,
                                  n.y,    n.z,    wo_l.x, wo_l.y,  wo_l.z,  m.bc.x, m.bc.y,
                                  m.bc.z, m.rough, m.metal, m.eta, alpha};
#pragma unroll
  for (int k = 0; k < kHpFields; ++k) ew.hp[k][lane] = terms[k];
  __syncwarp();
  // the BRDF of hitpoint terms (t, b, n, wo_l, m, alpha) against the event
  // row R's wi, times its flux; ok: the BRDF is a valid colour
  auto eval_row = [](const float4* R, V3 t, V3 b, V3 n, V3 wo_l, const Mtl& m, float alpha,
                     bool* ok) {
    const float4 c = R[1];  // normal.yz, wi.xy
    const float4 d = R[2];  // wi.z, flux3
    const V3 wi_l = to_local(mk(c.z, c.w, d.x), t, b, n);
    bool wh_ok;
    const V3 wh = half_vector(wo_l, wi_l, &wh_ok);
    const V3 f = eval_local(m, wo_l, wi_l, alpha, wh, wh_ok);
    *ok = valid3(f);
    return mul(mk(d.y, d.z, d.w), f);
  };
  // the warp's hitpoints against ns <= kSub consecutive event rows (every
  // lane of the warp calls this)
  auto sub_tile = [&](const float4* Ss, int ns) {
    unsigned mask = 0u;  // the pairs that pass both gates
    if (has) {
      cnt.add(kPairs, (unsigned)ns);
      cnt.simt(kPairLanes, (unsigned)ns);
#pragma unroll 4
      for (int k = 0; k < ns; ++k) {
        const float4 a = Ss[3 * k];      // pos3, normal.x
        const float4 c = Ss[3 * k + 1];  // normal.yz, wi.xy
        const float dx = p.x - a.x, dy = p.y - a.y, dz = p.z - a.z;
        const bool near = dx * dx + dy * dy + dz * dz < in.r2;
        const bool facing = near && dot3(n, mk(a.w, c.x, c.y)) > 0.01f;
        cnt.add(kNear, near);
        cnt.add(kFacing, facing);
        mask |= (unsigned)facing << k;
      }
    }
    // the set bits packed lane after lane, each lane's in event order
    const unsigned mine = __popc(mask);
    unsigned end = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += y;
    }
    const unsigned total = __shfl_sync(0xffffffffu, end, 31);
    const unsigned first = end - mine;
    ew.mask[lane] = mask;
    ew.end[lane] = end;
    __syncwarp();
    for (unsigned r0 = 0; r0 < total; r0 += 32) {
      const unsigned e = r0 + lane;
      if (e < total) {
        // the entry's lane o (the first whose entries end past e) and its
        // (e - start of o)-th set bit k
        int o = 0;
        for (int step = 16; step > 0; step >>= 1)
          if (ew.end[o + step - 1] <= e) o += step;
        const unsigned om = ew.mask[o];
        const int nth = (int)(e - (o ? ew.end[o - 1] : 0u));
        int k = 0;
        for (int step = 16; step > 0; step >>= 1)
          if (__popc(om & ((1u << (k + step)) - 1u)) <= nth) k += step;
        cnt.add(kGEvals);
        cnt.simt(kGEvalLanes);
        const float* H = &ew.hp[0][o];
        const Mtl mo = {mk(H[12 * 32], H[13 * 32], H[14 * 32]), H[15 * 32], H[16 * 32],
                        H[17 * 32]};
        bool ok;
        const V3 v = eval_row(Ss + 3 * k, mk(H[0], H[32], H[64]), mk(H[96], H[128], H[160]),
                              mk(H[192], H[224], H[256]), mk(H[288], H[320], H[352]), mo,
                              H[18 * 32], &ok);
        ew.f[0][lane] = v.x;
        ew.f[1][lane] = v.y;
        ew.f[2][lane] = v.z;
        ew.ok[lane] = ok;
      }
      __syncwarp();
      // this lane's entries of the batch, in order
      const unsigned lo = max(first, r0), hi = min(end, r0 + 32u);
      for (unsigned q = lo; q < hi; ++q) {
        const int sl = (int)(q - r0);
        if (!ew.ok[sl]) continue;  // a BRDF that is not a valid colour drops the pair
        acc = acc + mk(ew.f[0][sl], ew.f[1][sl], ew.f[2][sl]);
        ++count;
        cnt.add(kAccepted);
      }
      __syncwarp();
    }
  };

  const int tiles = (E + kGatherTile - 1) / kGatherTile;
  if (tiles > 0) load_tile(0, 0);
  for (int ti = 0; ti < tiles; ++ti) {
    if (ti + 1 < tiles) {
      load_tile(ti + 1, (ti + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* S = stage[ti & 1];
    const int nt = min(kGatherTile, E - ti * kGatherTile);
    for (int s0 = 0; s0 < nt; s0 += kSub) sub_tile(S + 3 * s0, min(kSub, nt - s0));
    __syncthreads();  // every thread is done with this buffer before it refills
  }
  if (has) {
    const int i = in.perm[j];
    store3(flux_out, i, mul(acc, tp));
    count_out[i] = count;
  }
  if constexpr (kCount) {
    unsigned long long wp = cnt.v[kPairs];
    for (int o = 16; o > 0; o >>= 1) wp += __shfl_down_sync(0xffffffffu, wp, o);
    cnt.flush(counts);
    if ((tid & 31) == 0 && wp) {
      atomicAdd(counts + kGWarps, 1ull);
      atomicMax(counts + kWarpPairsMax, wp);
    }
  }
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.

// work: one int32, zeroed by the caller (the next photon to hand out);
// valid holds zeros beforehand (rows never written are never read).
int pt_photon_trace(PTK_TABLE_PARAMS, const float* ro,
                    const float* rd, const float* flux, const bool* real, int P, uint32_t k0,
                    uint32_t k1, uint32_t start, uint32_t total, int light_depth, int iters,
                    int* work, float* ev, bool* valid, void* stream) {
  PhotonCfg g{{k0, k1}, start, total, light_depth, iters};
  auto* launch = nsc    ? &launch_photon<false, kWalkIndexed>
                 : nsup ? &launch_photon<false, kWalkSuper>
                        : &launch_photon<false, kWalkFlat>;
  return launch(make_tables(PTK_TABLE_ARGS), ro, rd, flux, real, P, g,
                work, ev, valid, nullptr, stream, Tex{});
}

// #10's textured instance: the atlas (n_tex, th1, tw1, 3) and its sizes
// (n_tex, 2) after the scene tables, the rest as pt_photon_trace.
int pt_photon_trace_tex(PTK_TABLE_PARAMS, const float* atlas,
                        const int* tex_size, int n_tex, int th1, int tw1, const float* ro,
                        const float* rd, const float* flux, const bool* real, int P, uint32_t k0,
                        uint32_t k1, uint32_t start, uint32_t total, int light_depth, int iters,
                        int* work, float* ev, bool* valid, void* stream) {
  PhotonCfg g{{k0, k1}, start, total, light_depth, iters};
  const Tex tx{atlas, tex_size, n_tex, th1, tw1};
  auto* launch =
      nsc    ? &launch_photon<false, kWalkIndexed, true>
      : nsup ? &launch_photon<false, kWalkSuper, true>
             : &launch_photon<false, kWalkFlat, true>;
  return launch(make_tables(PTK_TABLE_ARGS), ro, rd, flux, real, P, g,
                work, ev, valid, nullptr, stream, tx);
}

// The counting build of #10: the same events, and the work counters added
// into counts[kPhotonCounts] (zeroed by the caller).
int pt_photon_trace_counts(PTK_TABLE_PARAMS, const float* ro,
                           const float* rd, const float* flux, const bool* real, int P,
                           uint32_t k0, uint32_t k1, uint32_t start, uint32_t total,
                           int light_depth, int iters, int* work, float* ev, bool* valid,
                           unsigned long long* counts, void* stream) {
  PhotonCfg g{{k0, k1}, start, total, light_depth, iters};
  auto* launch = nsc    ? &launch_photon<true, kWalkIndexed>
                 : nsup ? &launch_photon<true, kWalkSuper>
                        : &launch_photon<true, kWalkFlat>;
  return launch(make_tables(PTK_TABLE_ARGS), ro, rd, flux, real, P, g,
                work, ev, valid, counts, stream, Tex{});
}

// occupancy_row of photon_trace and photon_trace_counts in turn (their
// flat-walk instances, the main path's on the text scenes).
int pt_photon_occupancy(int* out) {
  cudaError_t err =
      occupancy_row((const void*)photon_trace_kernel<false, kWalkFlat>, kPhotonThreads, 0, out);
  if (err == cudaSuccess)
    err = occupancy_row((const void*)photon_trace_kernel<true, kWalkFlat>, kPhotonThreads, 0,
                        out + 5);
  return (int)err;
}

// The eye pass of B pixels px, py (int32) through the camera cam_tab (eye
// ul dx dy, 12 floats): jitter key (j0, j1) = fold_in(key, 0x9E1),
// iteration key (i0, i1) = fold_in(key, 0x9E2), lanes [start, start + B)
// of a total-lane pass, at most iters chain links, the direct term's
// clamp; every output row written.
int pt_ppm_eye(PTK_TABLE_PARAMS, const float* cam,
               const int* px, const int* py, int B, uint32_t j0, uint32_t j1, uint32_t i0,
               uint32_t i1, uint32_t start, uint32_t total, int iters, float clamp,
               float* direct, float* pos, float* normal, float* wo, float* bc, float* rough,
               float* metal, float* eta, float* tp, bool* valid, void* stream) {
  const EyeCfg g{{j0, j1}, {i0, i1}, start, total, iters, clamp};
  const EyeOut o{direct, pos, normal, wo, bc, rough, metal, eta, tp, valid};
  auto* launch = nsc    ? &launch_eye<kWalkIndexed, false>
                 : nsup ? &launch_eye<kWalkSuper, false>
                        : &launch_eye<kWalkFlat, false>;
  return launch(make_tables(PTK_TABLE_ARGS), Tex{}, cam, px, py, B, g,
                o, stream);
}

// ppm_eye's textured instance: the atlas (n_tex, th1, tw1, 3) and its sizes
// (n_tex, 2) after the scene tables, the rest as pt_ppm_eye.
int pt_ppm_eye_tex(PTK_TABLE_PARAMS, const float* atlas,
                   const int* tex_size, int n_tex, int th1, int tw1, const float* cam,
                   const int* px, const int* py, int B, uint32_t j0, uint32_t j1, uint32_t i0,
                   uint32_t i1, uint32_t start, uint32_t total, int iters, float clamp,
                   float* direct, float* pos, float* normal, float* wo, float* bc, float* rough,
                   float* metal, float* eta, float* tp, bool* valid, void* stream) {
  const EyeCfg g{{j0, j1}, {i0, i1}, start, total, iters, clamp};
  const EyeOut o{direct, pos, normal, wo, bc, rough, metal, eta, tp, valid};
  const Tex tx{atlas, tex_size, n_tex, th1, tw1};
  auto* launch = nsc    ? &launch_eye<kWalkIndexed, true>
                 : nsup ? &launch_eye<kWalkSuper, true>
                        : &launch_eye<kWalkFlat, true>;
  return launch(make_tables(PTK_TABLE_ARGS), tx, cam, px, py, B, g, o,
                stream);
}

// occupancy_row of ppm_eye and ppm_eye_tex in turn (their flat-walk
// instances).
int pt_ppm_eye_occupancy(int* out) {
  cudaError_t err =
      occupancy_row((const void*)ppm_eye_kernel<kWalkFlat, false>, kEyeThreads, 0, out);
  if (err == cudaSuccess)
    err = occupancy_row((const void*)ppm_eye_kernel<kWalkFlat, true>, kEyeThreads, 0, out + 5);
  return (int)err;
}

static int launch_gather(const float* hp, const int* perm, const int* win, const float* ev,
                         const int* items, int n_items, float r2, float* flux, int* count,
                         unsigned long long* counts, void* stream) {
  GatherIn in{hp, perm, win, ev, reinterpret_cast<const int4*>(items), r2};
  if (counts)
    gather_flux_kernel<true><<<n_items, kGatherRows, 0, (cudaStream_t)stream>>>(in, flux, count,
                                                                              counts);
  else
    gather_flux_kernel<false><<<n_items, kGatherRows, 0, (cudaStream_t)stream>>>(in, flux, count,
                                                                               nullptr);
  return (int)cudaGetLastError();
}

// One block per work item of items (n_items, 4); flux and count hold zeros
// beforehand (rows no item holds keep them).
int pt_gather_flux(const float* hp, const int* perm, const int* win, const float* ev,
                   const int* items, int n_items, float r2, float* flux, int* count,
                   void* stream) {
  return launch_gather(hp, perm, win, ev, items, n_items, r2, flux, count, nullptr, stream);
}

// The counting build of #11: the same flux and counts, and the work
// counters added into counts[kGatherCounts] (zeroed by the caller).
int pt_gather_flux_counts(const float* hp, const int* perm, const int* win, const float* ev,
                          const int* items, int n_items, float r2, float* flux, int* count,
                          unsigned long long* counts, void* stream) {
  return launch_gather(hp, perm, win, ev, items, n_items, r2, flux, count, counts, stream);
}

// The rows of a work item at most: one thread each in a block of this many
// (prepare cuts the card's work list to it; join raises on another).
int pt_gather_rows() { return kGatherRows; }

// occupancy_row of gather_flux and gather_flux_counts in turn.
int pt_gather_occupancy(int* out) {
  cudaError_t err = occupancy_row((const void*)gather_flux_kernel<false>, kGatherRows, 0, out);
  if (err == cudaSuccess)
    err = occupancy_row((const void*)gather_flux_kernel<true>, kGatherRows, 0, out + 5);
  return (int)err;
}

}  // extern "C"
