// Hand-written CUDA kernels of the PT paths, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libpt_kernels.so pt_kernels.cu
// --fmad=false keeps multiplies and adds separately rounded, as the plain
// PyTorch versions round them, so kernel and plain version agree to a few
// ulps; no --use_fast_math.
//
// One thread per lane (ray or pixel), masked i < B; #5's persistent
// threads take one pixel at a time, #2's persistent warps 32 live lanes.
// Scene tables are read from global memory through const __restrict__
// pointers: the text scenes are a few KB
// and stay in L1/L2, a 81,920-triangle mesh is 11 MB and stays in the 50 MB
// L2.  No float atomics (#5's integer counter only hands out pixels); every
// output is a pure function of the lane's inputs, so a render is
// deterministic per seed.
//
// 1. nearest_hit       replaces path_tracing_tpu/ops/pallas_intersect.py
//                      nearest_hit_pallas (_nearest_kernel /
//                      _nearest_vmem_body); nearest_hit_uv is its with_uv
//                      form (iu, iv, tex of the winning triangle).  Both
//                      take the lanes whose result is read (live).
// 2. any_blocker       replaces pallas_intersect.py any_blocker_pallas
//                      (_blocker_kernel / _blocker_vmem_body).
// 3. shade_step        replaces path_tracing_tpu/ops/pallas_shade.py
//                      shade_step_pallas (_shade_kernel -> _shade_core ->
//                      _shade_from_hit): one fused PT bounce.
// 4. shade_step_tex    replaces pallas_shade.py shade_step_tex_pallas
//                      (_shade_tex_kernel), and with it the with_uv nearest
//                      hit and the sample_bilinear gather that JAX runs
//                      between its two kernels: the textured bounce is one
//                      launch here.
// 5. render_wavefront  replaces pallas_shade.py render_wavefront_pallas
//                      (_wavefront_kernel): the whole PT spp loop of a pixel
//                      in one thread.
// 6. threefry_rows     replaces no Pallas kernel: the (n, P) Threefry table
//                      that path_tracing_tpu/ops/rng.py:60 draws through XLA.
// 7. transmittance_rgb replaces no Pallas kernel: the RGB shadow of
//                      legacy-Ks scenes that path_tracing_tpu/ops/
//                      intersect.py:443 transmittance_rgb computes through
//                      XLA (the JAX package keeps those scenes off its
//                      kernels); one thread a live lane on #2's resident
//                      walk, every occluder of the window folded in
//                      (pt_device.cuh::shadow_rgb_dev), an instance per
//                      walk.  Bound: operations (the walk's tests, as #2).
//
// What bounds them on this card: the primitive sweeps are compute work per
// ray (about 45 primitive tests per ray on a 36-triangle box; on a mesh of
// 64 clusters or more a slab test per super of the ray's octant list, then
// the children of the entered supers and the triangles of the entered
// clusters, as pt_device.cuh::cluster_walk walks them);
// memory traffic is the ray state, 40-130 bytes per lane per bounce, or
// 12 bytes per pixel for the megakernel, whose state never leaves
// registers.  The TPU kernels cull clusters per 4096-ray tile (jnp.any over
// the tile); here each ray culls the clusters it cannot enter on its own,
// which needs no cross-lane vote and skips more work.  The bounce is one
// large function whose cost is registers (it holds hit, material, NEE and
// BSDF state at once): lanes that are not active, not eligible for NEE, or
// end at a light skip the sweeps and the sample they do not need, and draw
// only the uniforms they use.
//
// #5's design for this card.  Persistent blocks fill the card; a lane runs
// one pixel's whole regenerating spp loop and, when it is done, takes the
// next pixel index from a global counter (one atomicAdd a warp step for the
// lanes that need work), so no warp waits on its longest pixel and no
// block on the last.  The lane restarts its iteration count at 0 and draws
// at the pixel's own lane index, so every pixel is computed by one thread,
// in the parent's order, from the same (key, it, lane) draws: the image is
// the one-thread-per-pixel kernel's, bit for bit; the atomic only hands out
// work.  Twelve blocks of 128 an SM (40 registers, the rest spilled) ran
// fastest.  Each lane walks its own NEE shadow ray: packing a warp's rays
// into a queue in shared memory and walking them 32 at a time (the step's
// radiance waiting in a per-lane FIFO until its verdict) lifted the shadow
// step's SIMT from about 0.73 to 0.99 but ran slower at every occupancy
// (PERF.md section 6).  The counting build (kCount) counts the
// iterations, each warp's iterations (its longest lane against the mean),
// the walks and their primitive tests, the BSDF samples, evaluations and
// pdfs, the draws and the SIMT efficiency of the walk, the shade and the
// shadow step.
//
// #4's design for this card: the textured bounce takes the super walk on
// meshes of 64 clusters or more (the 81,920-triangle icosphere: 128 supers
// of 16 clusters), as shade_step_tex_pallas walks super_table; #4, #5 and
// #10 launch an instance per walk, the flat one below 64 clusters.  Eight
// blocks of 128 an SM (64 registers).  Measured on an H100 on the first
// bounce of the textured 1080p frame, bit-equal on every lane (PERF.md
// section 6): the flat walk 14.57 ms; the super walk 2.43 (96 registers, 20
// warps an SM); with 6 / 8 / 10 blocks an SM 2.28 / 2.03-2.06 / 2.04-2.05;
// the octant's 128 super rows (8 KB) staged in shared memory per block
// 2.40-2.41 against 2.38 with the same generic loads unstaged (dropped).
// The counting build (kCount) counts #5's counters that one bounce fills.
//
// #3's design for this card: an instance per walk (the flat one below 64
// clusters, as #4), one thread a lane at 8 blocks of 128 an SM (64
// registers, 142 B spilled in the flat instance), and a counting build.
// Measured on an H100 80GB HBM3 at 700 W in turns (PERF.md section 6),
// every lane bit-equal: a full 1080p bounce 0.61 ms against the parent's
// 0.70; the fused frame's 47 launches 24.7 ms against 27.7.  Persistent
// warps that run the active lanes 32 at a time (LaneQueue) took those 47
// launches in 23.8-24.5 ms but a full bounce in 0.68-0.72, and the whole
// frame (70-78 ms) could not tell them apart: dropped as the larger
// design.  10 and 12 blocks an SM: 2-5% slower over the frame's launches.
//
// #1's and #2's design for this card.  Every caller hands over the lanes
// whose result it reads (live: the bounce's active or NEE-eligible lanes,
// the eye passes' and the light trace's alive ones); a launch walks only
// those and writes the miss record (#1) or false (#2) on the others,
// which is all a lane that is not live costs: its mask byte read and its
// record written.  Bounded by the live lanes' walks (operations; on
// cornell's flat walk every ray tests every box) and, on the thin launches
// of a frame's tail, by the records of the lanes that are not live.  An
// instance per walk (the flat one below 64 clusters).  #1 one thread a
// lane at 10 blocks of 128 an SM (48 registers); #2 on persistent warps
// that take spans of 32 lanes from a counter and walk the live ones 32 at
// a time (LaneQueue), 8 blocks an SM.  Measured on an H100 80GB HBM3 at
// 700 W in turns, device-only, every live lane bit-equal to the parent
// (PERF.md section 6): #1 1.8x the parent over the split 1080p frame's 47
// launches and 1.5x over the BDPT fused exact frame's 56, a full-lane
// bounce level with it; #2 1.34x over the split frame's 47.  #1 on
// LaneQueue's warps ran the split frame's launches 8% slower, the BDPT
// frame's 7% faster (no order over both) and the PPM eye pass's 33%
// slower; #2 one thread a lane 13% slower.  #1 at 8 blocks an SM 1.7%
// slower than at 10 (12: slower still); #2 at 10 or 12 blocks 2.4-7%
// slower than at 8.  The counting builds (kCount) count the walks'
// sphere, box and triangle tests.

#include <algorithm>
#include <type_traits>

#include "pt_device.cuh"

using namespace ptk;

namespace {

// ---------------------------------------------------------------------------
// #1 nearest_hit and #2 any_blocker
// ---------------------------------------------------------------------------

constexpr int kHitMinBlocks = 10;    // #1's __launch_bounds__: 40 warps an SM
constexpr int kShadowMinBlocks = 8;  // #2's: 32 warps an SM
// Whether a launch with a mask runs on persistent warps that take the
// live lanes 32 at a time (LaneQueue), or one thread a lane: #1 one
// thread a lane, #2 queued (measured, PERF.md section 6)
constexpr bool kHitQueue = false;
constexpr bool kShadowQueue = true;

__device__ int g_lane_work;  // the next span of lanes of a queued launch

// The record of a lane that is not live, as nearest_hit_plain writes it:
// a miss (t = kInf, normal, material and flag 0; iu, iv 0, tex -1).
__device__ __forceinline__ HitRec miss_rec() {
  HitRec h;
  h.t = kInf;
  h.n = mk(0.f, 0.f, 0.f);
  h.m = {mk(0.f, 0.f, 0.f), 0.f, 0.f, 0.f};
  h.flag = 0;
  h.iu = h.iv = 0.f;
  h.tex = -1.f;
  return h;
}

// Lane i's record as rows of a (10, B) table -- t n3 bc3 rough metal eta
// -- and, with kUV, rows 10-12 iu iv tex; the flag apart.
template <bool kUV>
__device__ __forceinline__ void store_hit(float* __restrict__ out, int* __restrict__ flag, int B,
                                          int i, const HitRec& h) {
  out[0 * B + i] = h.t;
  out[1 * B + i] = h.n.x;
  out[2 * B + i] = h.n.y;
  out[3 * B + i] = h.n.z;
  out[4 * B + i] = h.m.bc.x;
  out[5 * B + i] = h.m.bc.y;
  out[6 * B + i] = h.m.bc.z;
  out[7 * B + i] = h.m.rough;
  out[8 * B + i] = h.m.metal;
  out[9 * B + i] = h.m.eta;
  if (kUV) {
    out[10 * B + i] = h.iu;
    out[11 * B + i] = h.iv;
    out[12 * B + i] = h.tex;
  }
  flag[i] = h.flag;
}

// The lanes of a launch of #1 or #2: run(i) walks live lane i, skip(i)
// writes what a lane that is not live gets.  Without a mask (live null)
// or without kQueue, one thread a lane; with both, the persistent warps
// of LaneQueue take spans of 32 lanes from g_lane_work (zeroed by the
// launch) and run the live ones 32 at a time.  Every lane of every warp
// returns here, so a counting build can flush after it.
template <bool kQueue, class Run, class Skip>
__device__ __forceinline__ void for_lanes(const bool* __restrict__ live, int B, Run run,
                                          Skip skip) {
  if constexpr (kQueue) {
    if (live) {
      __shared__ int lanes[kThreads / 32][64];
      LaneQueue lq{lanes[threadIdx.x >> 5], 0, true};
      for (;;) {
        lq.fill(&g_lane_work, B, live, skip);
        const int nb = min(lq.n, 32);
        if (nb == 0) break;
        if ((int)(threadIdx.x & 31) < nb) run(lq.q[threadIdx.x & 31]);
        lq.pop(nb);
      }
      return;
    }
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) {
    if (!live || live[i])
      run(i);
    else
      skip(i);
  }
}

template <bool kCount, bool kUV, int kW>
__device__ __forceinline__ void nearest_hit_lanes(const Tables& tb, const float* __restrict__ ro,
                                                  const float* __restrict__ rd,
                                                  const bool* __restrict__ live, int B,
                                                  float* __restrict__ out, int* __restrict__ flag,
                                                  unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, Count, NoCount>::type cnt;
  for_lanes<kHitQueue>(
      live, B,
      [&](int i) {
        store_hit<kUV>(out, flag, B, i,
                       nearest_hit_dev<kUV, kW>(tb, load3(ro, i), load3(rd, i), cnt));
      },
      [&](int i) { store_hit<kUV>(out, flag, B, i, miss_rec()); });
  if constexpr (kCount) cnt.flush(counts);
}

// #1.  kCount: the counting build (the walk's sphere, box and triangle
// tests); kW: the walk (an instance per walk, WalkKind).
template <bool kCount, int kW>
__global__ void __launch_bounds__(kThreads, kHitMinBlocks)
    nearest_hit_kernel(Tables tb, const float* __restrict__ ro, const float* __restrict__ rd,
                       const bool* __restrict__ live, int B, float* __restrict__ out,
                       int* __restrict__ flag, unsigned long long* __restrict__ counts) {
  nearest_hit_lanes<kCount, false, kW>(tb, ro, rd, live, B, out, flag, counts);
}

// #1 with the winner's UVs: a (13, B) table, rows 10-12 iu iv tex
template <bool kCount, int kW>
__global__ void __launch_bounds__(kThreads, kHitMinBlocks)
    nearest_hit_uv_kernel(Tables tb, const float* __restrict__ ro, const float* __restrict__ rd,
                          const bool* __restrict__ live, int B, float* __restrict__ out,
                          int* __restrict__ flag, unsigned long long* __restrict__ counts) {
  nearest_hit_lanes<kCount, true, kW>(tb, ro, rd, live, B, out, flag, counts);
}

// #2: a lane that is not live gets false.
template <bool kCount, int kW>
__global__ void __launch_bounds__(kThreads, kShadowMinBlocks)
    any_blocker_kernel(Tables tb, const float* __restrict__ p1, const float* __restrict__ rd,
                       const float* __restrict__ max_d, const bool* __restrict__ live, int B,
                       int blocks_col, bool* __restrict__ out,
                       unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, Count, NoCount>::type cnt;
  for_lanes<kShadowQueue>(
      live, B,
      [&](int i) {
        out[i] = shadow_blocked_dev<kW>(tb, load3(p1, i), load3(rd, i), max_d[i], blocks_col, cnt);
      },
      [&](int i) { out[i] = false; });
  if constexpr (kCount) cnt.flush(counts);
}

// transmittance_rgb: lane i's RGB factor (a lane that is not live gets 1).
// kW: the walk (an instance per walk, WalkKind).
template <int kW>
__global__ void __launch_bounds__(kThreads, kShadowMinBlocks)
    transmittance_rgb_kernel(Tables tb, const float* __restrict__ ks,
                             const float* __restrict__ p1, const float* __restrict__ rd,
                             const float* __restrict__ max_d, const bool* __restrict__ live,
                             int B, float* __restrict__ out) {
  NoCount cnt;
  for_lanes<false>(
      live, B,
      [&](int i) {
        store3(out, i, shadow_rgb_dev<kW>(tb, ks, load3(p1, i), load3(rd, i), max_d[i], cnt));
      },
      [&](int i) { store3(out, i, mk(1.f, 1.f, 1.f)); });
}

// (n, P) table of uniforms: element [j, lane] of the global (n, total) draw
// at column start + lane
__global__ void threefry_rows_kernel(Key key, int n, int P, uint32_t start, uint32_t total,
                                     float* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * P) return;
  int j = (int)(idx / P);
  uint32_t lane = (uint32_t)(idx - (long long)j * P);
  out[idx] = uniform_at(key, j, lane, start, total);
}

// ---------------------------------------------------------------------------
// the PT bounce shared by shade_step, shade_step_tex and render_wavefront
// ---------------------------------------------------------------------------

struct PathState {
  V3 ro, rd, tp;
  float eta, last_pdf;
  int dep;
  bool alive, last_delta;
};

struct ShadeCfg {
  const float* __restrict__ lights;  // (nl, 12)
  float clamp_val;
  int stub_mis, blocks_col;
};

// the bounce's uniforms as rows of a (>= 6, B) table
struct TableDraws {
  const float* __restrict__ u;
  int B, i;
  __device__ __forceinline__ float operator()(int j) const { return u[j * B + i]; }
};

// the bounce's uniforms drawn in the kernel, at the counters of the rows
// TableDraws would read from threefry_rows' table of the same key
struct ThreefryDraws {
  Key key;
  uint32_t lane, start, total;
  __device__ __forceinline__ float operator()(int j) const {
    return uniform_at(key, j, lane, start, total);
  }
};

// The NEE shadow ray walked where it is cast (has: a ray was cast), by
// the walk kW (WalkKind).
template <class Ctr, int kW = kWalkAny>
struct WalkShadow {
  const Tables& tb;
  int blocks_col;
  Ctr& cnt;
  bool has;
  __device__ __forceinline__ bool operator()(V3 p1, V3 rd, float md) {
    has = true;
    cnt.simt(kShLanes);
    return shadow_blocked_dev<kW>(tb, p1, rd, md, blocks_col, cnt);
  }
};

// One PT bounce of an active lane from its hit: light-ball emission, NEE
// with its shadow sweep (walked by the functor sh), BSDF sample.  Updates s as shade_step_pallas's
// outputs (a lane that missed, hit a light or died leaves with alive false
// and the rest of its state unchanged) and returns the bounce's radiance.
// Uniform j is drawn as u(j), only where it is used: 0-2 NEE, 3-5 BSDF.
template <class Draws, class Shadow>
__device__ V3 shade_from_hit(const Tables& tb, const ShadeCfg& c, const HitRec& h, PathState& s,
                             const Draws& u, Shadow& sh) {
  const int nl = tb.nl;
  V3 radiance = mk(0.f, 0.f, 0.f);
  const V3 n = h.n;
  const Mtl& m = h.m;
  V3 pos = s.ro + scale(s.rd, h.t);
  bool is_light = h.flag == 2;
  bool act = h.flag > 0;
  V3 wo = -s.rd;

  // ---- 1. light-ball emission: the first light whose ball surface is
  // within 1e-2 of the hit, flux -> radiance with the spot-cone gate ----
  if (is_light) {
    int found = 0;
    float e_area = 1.0f, e_cut = 0.0f;
    int e_par = 0;
    V3 e_d = mk(0.f, 0.f, 0.f), e_i = mk(0.f, 0.f, 0.f), c2h_sel = mk(0.f, 0.f, 0.f);
    for (int l = 0; l < nl && !found; ++l) {
      const float* L = c.lights + l * kLightCols;
      float r = L[11];
      V3 c2h = pos - mk(L[0], L[1], L[2]);
      if (fabsf(norm3(c2h) - r) < 1e-2f) {
        found = 1;
        e_area = 4.0f * kPi * r * r;
        e_cut = L[9];
        e_par = L[10] > 0.0f;
        e_d = mk(L[3], L[4], L[5]);
        e_i = mk(L[6], L[7], L[8]);
        c2h_sel = c2h;
      }
    }
    V3 main_dir = normalize3(e_d);
    V3 c2h_dir = normalize3(c2h_sel);
    bool spot = (e_cut > 0.0f) && (e_par == 0);
    bool behind = dot3(main_dir, c2h_dir) < cosf(e_cut);
    float cone = spot ? (1.0f - cosf(e_cut)) / 2.0f : 1.0f;
    if (spot && s.dep == 0) cone = 1.0f;  // the full cone at depth 0
    if (spot && s.dep != 0 && behind) cone = 0.0f;
    bool e_ok = found && (cone > 0.0f);
    float inv_ac = 1.0f / jmax(e_area * cone, 1e-20f);
    V3 emission = e_ok ? scale(e_i, inv_ac) : mk(0.f, 0.f, 0.f);
    bool has_e = (emission.x > 0.0f) || (emission.y > 0.0f) || (emission.z > 0.0f);
    if (has_e) {
      V3 c_delta = mul(s.tp, emission);
      c_delta = valid3(c_delta) ? clamp3(c_delta, c.clamp_val) : mk(0.f, 0.f, 0.f);
      V3 contrib;
      if (c.stub_mis) {
        // the reference's stubbed MIS strategy A: a BSDF ray that hits a
        // light from a non-delta vertex adds nothing
        contrib = s.last_delta ? c_delta : mk(0.f, 0.f, 0.f);
      } else {
        float cos_l = jmax(dot3(n, wo), 1e-6f);
        float pdf_l = (1.0f / ((float)nl * e_area)) * h.t * h.t / cos_l;
        float p_b = s.last_pdf * s.last_pdf;
        float p_l = pdf_l * pdf_l;
        float mis_w = p_b / jmax(p_b + p_l, 1e-8f);
        V3 c_mis = scale(mul(s.tp, emission), mis_w);
        c_mis = (found && valid3(c_mis)) ? clamp3(c_mis, c.clamp_val) : mk(0.f, 0.f, 0.f);
        contrib = s.last_delta ? c_delta : c_mis;
      }
      radiance = radiance + contrib;
    }
  }

  bool alive = act && !is_light;

  // ---- 2. NEE on non-delta surfaces: one light picked uniformly ----
  bool elig = alive && (m.eta <= 0.0f) && ((m.metal < 0.99f) || (m.rough > 0.01f));
  if (elig && nl > 0) {
    float u0 = u(0), u1 = u(1), u2 = u(2);
    int li = min((int)(u0 * (float)nl), nl - 1);
    const float* L = c.lights + li * kLightCols;
    V3 l_pos = mk(L[0], L[1], L[2]), l_dir = mk(L[3], L[4], L[5]);
    V3 l_illum = mk(L[6], L[7], L[8]);
    float l_cut = L[9], l_r = L[11];
    bool l_par = L[10] > 0.0f;

    V3 pdir = normalize3(-l_dir);
    float zc = 1.0f - 2.0f * u1;
    float rr = sqrtf(jmax(0.0f, 1.0f - zc * zc));
    float ph = 2.0f * kPi * u2;
    V3 d_loc = mk(rr * cosf(ph), rr * sinf(ph), zc);
    V3 lp = l_pos + scale(d_loc, l_r);
    V3 wi_vec = lp - pos;
    float dist2 = dot3(wi_vec, wi_vec);
    float dist = sqrtf(dist2);
    V3 wi_sph = scale(wi_vec, 1.0f / jmax(dist, 1e-20f));
    V3 wi = l_par ? pdir : wi_sph;
    float cos_surf = jmax(0.0f, dot3(n, wi));
    float cos_light = jmax(0.0f, dot3(d_loc, -wi_sph));
    bool inside = l_par || (l_cut <= 0.0f) || (dot3(normalize3(l_dir), -wi_sph) >= cosf(l_cut));

    // one shadow sweep; parallel lights target a far point along wi
    V3 p2 = l_par ? pos + scale(pdir, 1e4f) : lp + scale(d_loc, kEps);
    V3 p1 = pos + scale(n, kEps);
    V3 diff = p2 - p1;
    float sdist = norm3(diff);
    V3 srd = scale(diff, 1.0f / jmax(sdist, 1e-20f));
    bool blocked = sh(p1, srd, sdist - kMinD);
    float tr = blocked ? 0.0f : 1.0f;

    V3 brdf;
    float pdf_b;
    eval_pdf_world(m, wo, wi, n, &brdf, &pdf_b);
    V3 base = mul(mul(s.tp, brdf), l_illum);
    V3 nee;
    if (l_par) {
      bool gate = (cos_surf > 0.0f) && (tr > 0.0f);
      nee = gate ? scale(base, tr * cos_surf * (float)nl) : mk(0.f, 0.f, 0.f);
    } else {
      float area = 4.0f * kPi * l_r * l_r;
      float pdf_area = 1.0f / ((float)nl * area);
      float pdf_ld = pdf_area * dist2 / jmax(cos_light, 1e-6f);
      float p_l2 = pdf_ld * pdf_ld;
      float p_b2 = pdf_b * pdf_b;
      float mis = p_l2 / jmax(p_l2 + p_b2, 1e-8f);
      bool gate = (cos_surf > 0.0f) && (cos_light > 0.0f) && inside && (tr > 0.0f);
      nee = gate ? scale(base, tr * cos_surf / pdf_ld * mis) : mk(0.f, 0.f, 0.f);
    }
    nee = valid3(nee) ? clamp3(nee, c.clamp_val) : mk(0.f, 0.f, 0.f);
    radiance = radiance + nee;
  }

  // ---- 3. BSDF sample and state update (surface hits only) ----
  if (alive) {
    BsdfSample b = bsdf_sample_dev(m, wo, n, u(3), u(4), u(5), s.eta);
    bool dead = (b.pdf <= 0.0f) && !b.is_delta;
    alive = !dead;
    float cos_wi = fabsf(dot3(n, b.wi));
    float w = b.is_delta ? 1.0f : cos_wi / jmax(b.pdf, 1e-20f);
    V3 new_tp = scale(mul(s.tp, b.val), w);
    alive = alive && valid3(new_tp);
    V3 off = scale(dot3(b.wi, n) < 0.0f ? -n : n, kEps);
    s.ro = b.is_delta ? pos + off : pos + scale(n, kEps);
    s.rd = b.wi;
    s.tp = new_tp;
    s.eta = b.new_eta;
    s.dep = s.dep + (b.is_delta ? 0 : 1);  // delta bounces do not consume depth
    s.last_delta = b.is_delta;
    if (!b.is_delta) s.last_pdf = b.pdf;
  }
  s.alive = alive;
  return radiance;
}

// ---------------------------------------------------------------------------
// per-bounce kernels: shade_step and shade_step_tex
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMegaThreads = 128;
constexpr int kMegaMinBlocks = 12;  // __launch_bounds__: 48 warps an SM
constexpr int kTexMinBlocks = 8;    // #4's __launch_bounds__: 32 warps an SM
constexpr int kStepMinBlocks = 8;   // #3's __launch_bounds__: 32 warps an SM

// #5's counters after the shared ones (ops/cuda_wavefront.py::COUNT_NAMES);
// #4's counting build fills the same
enum MegaCountIdx {
  kIters = kNumCounts, kBsdfSamples, kDraws, kWalkLanes, kWalkSlots, kShadeLanes, kShadeSlots,
  kWarpIterSlots, kWideWalks, kWideSteps, kMegaCounts
};

struct StateIn {
  const float* __restrict__ ro;
  const float* __restrict__ rd;
  const float* __restrict__ tp;
  const float* __restrict__ eta;
  const int* __restrict__ depth;
  const bool* __restrict__ act;
  const bool* __restrict__ last_delta;
  const float* __restrict__ last_pdf;
  const float* __restrict__ u;  // (>= 6, B) rows of uniforms
};

struct StateOut {
  float* __restrict__ rad;
  float* __restrict__ ro;
  float* __restrict__ rd;
  float* __restrict__ tp;
  float* __restrict__ eta;
  int* __restrict__ depth;
  bool* __restrict__ alive;
  bool* __restrict__ delta;
  float* __restrict__ pdf;
};

__device__ __forceinline__ PathState load_state(const StateIn& in, int i) {
  PathState s;
  s.ro = load3(in.ro, i);
  s.rd = load3(in.rd, i);
  s.tp = load3(in.tp, i);
  s.eta = in.eta[i];
  s.last_pdf = in.last_pdf[i];
  s.dep = in.depth[i];
  s.alive = in.act[i];
  s.last_delta = in.last_delta[i];
  return s;
}

__device__ __forceinline__ void store_state(const StateOut& out, int i, const PathState& s,
                                            V3 radiance) {
  store3(out.rad, i, radiance);
  store3(out.ro, i, s.ro);
  store3(out.rd, i, s.rd);
  store3(out.tp, i, s.tp);
  out.eta[i] = s.eta;
  out.depth[i] = s.dep;
  out.alive[i] = s.alive;
  out.delta[i] = s.last_delta;
  out.pdf[i] = s.last_pdf;
}

// One bounce of lane i from its state in `in` to `out`: for #3 the hit,
// for #4 (kTex) the with_uv hit and the bilinear texel of a textured
// triangle multiplied into its base color, then the bounce of
// shade_from_hit, its uniforms from the table (TableDraws).  An inactive
// lane passes through with alive false.  The counting builds count #5's
// counters that a bounce fills: the active lanes (kIters), their walks'
// tests, the NEE shadow rays with their evaluations and pdfs, the BSDF
// samples and the SIMT of the walk, the shade and the shadow step (no
// draws: the uniforms come from the table).  kW: the walk (an instance
// per walk, WalkKind).
template <bool kTex, int kW, class Ctr>
__device__ __forceinline__ void bounce_lane(const Tables& tb, const Tex& tx, const ShadeCfg& c,
                                            const StateIn& in, const StateOut& out, int B, int i,
                                            Ctr& cnt) {
  PathState s = load_state(in, i);
  V3 radiance = mk(0.f, 0.f, 0.f);
  if (s.alive) {
    cnt.add(kIters);
    cnt.simt(kWalkLanes);
    HitRec h = nearest_hit_dev<kTex, kW>(tb, s.ro, s.rd, cnt);
    if (kTex) {
      const int tex_id = (int)h.tex;
      if (tex_id >= 0) h.m.bc = mul(h.m.bc, sample_bilinear_dev(tx, tex_id, h.iu, h.iv));
    }
    cnt.simt(kShadeLanes);
    WalkShadow<Ctr, kW> sh{tb, c.blocks_col, cnt, false};
    radiance = shade_from_hit(tb, c, h, s, TableDraws{in.u, B, i}, sh);
    if (sh.has) {
      cnt.add(kShadowRays);
      cnt.add(kEvals);
      cnt.add(kPdfs);
    }
    if (h.flag == 1) cnt.add(kBsdfSamples);
  }
  store_state(out, i, s, radiance);
}

// #3.  kW: the walk (an instance per walk, WalkKind).
template <bool kCount, int kW>
__global__ void __launch_bounds__(kThreads, kStepMinBlocks)
    shade_step_kernel(Tables tb, ShadeCfg c, StateIn in, StateOut out, int B,
                      unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, CountN<kMegaCounts>, NoCount>::type cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) bounce_lane<false, kW>(tb, Tex{}, c, in, out, B, i, cnt);  // every lane flushes
  if constexpr (kCount) cnt.flush(counts);
}

// #4.  kW: the walk (an instance per walk, WalkKind).
template <bool kCount, int kW>
__global__ void __launch_bounds__(kThreads, kTexMinBlocks)
    shade_step_tex_kernel(Tables tb, Tex tx, ShadeCfg c, StateIn in, StateOut out, int B,
                          unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, CountN<kMegaCounts>, NoCount>::type cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) bounce_lane<true, kW>(tb, tx, c, in, out, B, i, cnt);  // every lane flushes
  if constexpr (kCount) cnt.flush(counts);
}

// ---------------------------------------------------------------------------
// render_wavefront: every sample of a pixel in one thread, pixels handed
// out by a global counter
// ---------------------------------------------------------------------------

struct WavefrontCfg {
  Key key;
  uint32_t start, total;   // pixel i is column start + i of a total-lane render
  int spp, eye_depth, max_path_iters, max_total;
};

// #5's indexed instance walks each wide ray (sphere_pad's k > 0) with its
// whole warp.  A wide ray tests far more of the index than the others
// (its boxes grow by up to k times their farthest corner's distance), so
// a lane that walked one alone held its warp's other 31.  Once the narrow
// lanes have walked their own rays, the warp takes its wide rays one
// after another in ballot order: the owner's ray, pad and running t go to
// every lane; the octant's supers are tested 32 a step, each entered
// super's 16 children two supers a step, each entered cluster's spheres
// two clusters a step (a cluster holds at most 16, bvh.SPHERE_LEAF).
// Each lane keeps its first least t and the sphere step that found it;
// after each sphere step the warp's least t culls the boxes that follow.
// Steps come in walk order, a step's lanes in walk order, and no box is
// tested with a t found after it in that order, so the least (t, step,
// lane) is the lane walk's winner: the least t, on an exact tie the first
// sphere the walk visits.  The owner rebuilds the record from the winning
// row with test_sphere, as the lane walk wrote it.  The counting build
// counts each box and sphere test on the lane that makes it (the rebuild
// is no test), and on the owner the walk (kWideWalks) and its steps
// (kWideSteps): a super step, a children step and a sphere step each one;
// ops/cuda_intersect.py::_count_nearest_walk's warp model counts the same.

__device__ __forceinline__ V3 shfl3(V3 v, int src) {
  return mk(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
            __shfl_sync(kFull, v.z, src));
}

// The warp's least t: a hit's t is above kEps and a miss's kInf, so the
// bits of these positive floats order as their values.
__device__ __forceinline__ float warp_min_t(float t) {
  return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(t)));
}

// The sphere index walked for lane owner's wide ray by the whole warp (every
// lane calls it); best: the owner's running hit (the light balls'), which
// gains the winning sphere's record.
template <class Ctr>
__device__ __forceinline__ void warp_sphere_walk(const Tables& tb, int owner, V3 ro_own,
                                                 V3 rd_own, V3 inv_own, SpherePad pad_own,
                                                 HitRec& best, Ctr& cnt) {
  const int lane = threadIdx.x & 31;
  const V3 ro = shfl3(ro_own, owner), rd = shfl3(rd_own, owner), inv = shfl3(inv_own, owner);
  const SpherePad pad = {__shfl_sync(kFull, pad_own.pad, owner),
                         __shfl_sync(kFull, pad_own.k, owner)};
  const int cols = tb.nssup ? kSclCols : kClCols;
  const int oct = octant(rd);
  float run_t = __shfl_sync(kFull, best.t, owner);  // the warp's running t
  float bt = run_t;                                 // the lane's least t
  int brow = -1, bstep = 0, step = 0;
  unsigned steps = 0;
  // the spheres of the entered clusters (lane l's cluster c, entered on
  // the lanes of cm), two clusters a step: lanes 0-15 the first's, 16-31
  // the second's
  auto spheres = [&](unsigned cm, int c) {
    while (cm) {
      const int la = __ffs(cm) - 1;
      cm &= cm - 1;
      const bool two = cm != 0;
      const int lb = two ? __ffs(cm) - 1 : la;
      cm &= cm - 1;
      const int ca = __shfl_sync(kFull, c, la), cb = __shfl_sync(kFull, c, lb);
      if (lane < 16 || two) {
        const float* C = tb.scl + (lane < 16 ? ca : cb) * cols;
        if ((lane & 15) < (int)C[7]) {
          const int i = (int)C[6] + (lane & 15);
          V3 oc;
          cnt.add(kHitSph);
          const float t = sphere_t(ro, rd, tb.sph + i * kSphCols, INFINITY, &oc);
          if (t < bt) {
            bt = t;
            brow = i;
            bstep = step;
          }
        }
      }
      ++step;
      ++steps;
      run_t = warp_min_t(bt);
    }
  };
  // lane l's cluster c (valid: a row the walk visits): its box, then the
  // spheres of the clusters entered
  auto clusters = [&](int c, bool valid) {
    bool in = false;
    if (valid) {
      const float* C = tb.scl + c * cols;
      if ((int)C[7] > 0) {
        cnt.add(kHitBox);
        in = slab_hit_pad(C, ro, inv, pad, kEps, run_t);
      }
    }
    ++steps;
    spheres(__ballot_sync(kFull, in), c);
  };
  if (tb.nssup) {
    for (int base = 0; base < tb.nssup; base += 32) {
      int s = 0;
      bool in = false;
      if (base + lane < tb.nssup) {
        s = (int)tb.ssup[(base + lane) * kSupCols + 8 + oct];
        const float* S = tb.ssup + s * kSupCols;
        if ((int)S[7] > 0) {
          cnt.add(kHitBox);
          in = slab_hit_pad(S, ro, inv, pad, kEps, run_t);
        }
      }
      ++steps;
      // the entered supers' children, two supers a step
      for (unsigned sm = __ballot_sync(kFull, in); sm;) {
        const int la = __ffs(sm) - 1;
        sm &= sm - 1;
        const bool two = sm != 0;
        const int lb = two ? __ffs(sm) - 1 : la;
        sm &= sm - 1;
        const int sa = __shfl_sync(kFull, s, la), sb = __shfl_sync(kFull, s, lb);
        const int first = (lane < 16 ? sa : sb) * kSuper;
        clusters(first + (int)tb.scl[(first + (lane & 15)) * kSclCols + 8 + oct],
                 lane < 16 || two);
      }
    }
  } else {
    for (int base = 0; base < tb.nsc; base += 32) clusters(base + lane, base + lane < tb.nsc);
  }
  const float tmin = warp_min_t(bt);
  const unsigned rank = (brow >= 0 && bt == tmin) ? ((unsigned)bstep << 5) | (unsigned)lane : ~0u;
  const unsigned win = __reduce_min_sync(kFull, rank);
  const int row = __shfl_sync(kFull, brow, win & 31u);
  if (lane == owner) {
    cnt.add(kWideWalks);
    cnt.add(kWideSteps, steps);
    if (win != ~0u) test_sphere(tb.sph + row * kSphCols, ro_own, rd_own, best);
  }
}

// #5's nearest hit in its indexed instance: nearest_hit_dev<false,
// kWalkIndexed>'s record, the index walked by the lane for a narrow ray
// and by the whole warp for a wide one (warp_sphere_walk).  Every lane of
// the warp calls it; run: the lane has a ray (a lane without one helps).
template <class Ctr>
__device__ __forceinline__ HitRec nearest_hit_warp(const Tables& tb, V3 ro, V3 rd, bool run,
                                                   Ctr& cnt) {
  const bool flat = tb.nsup == 0;
  NearestVisit<false, Ctr> w{tb, cnt, ro, rd, mk(0.f, 0.f, 0.f), flat ? kClCols : kSclCols};
  w.best.t = kInf;
  w.best.n = mk(0.f, 0.f, 0.f);
  w.best.m = {mk(0.f, 0.f, 0.f), 0.f, 0.f, 0.f};
  w.best.flag = 0;
  w.best_tri = -1;
  w.best_u = w.best_v = 0.f;
  SpherePad pad = {0.f, 0.f};
  if (run) {
    for (int i = tb.nsc ? tb.ns : 0; i < tb.ns + tb.nl; ++i) {
      cnt.add(kHitSph);
      test_sphere(tb.sph + i * kSphCols, ro, rd, w.best);
    }
    w.inv = mk(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
    if (tb.nsc) {
      const int cols = tb.nssup ? kSclCols : kClCols;
      pad = sphere_pad(tb.scl + tb.nsc * cols, ro, rd);
      if (!(pad.k > 0.0f)) {
        NearestSphereVisit<Ctr> sv{tb, cnt, ro, rd, w.inv, pad, cols, w.best};
        sphere_walk(tb, rd, sv);
      }
    }
  }
  for (unsigned m = __ballot_sync(kFull, run && pad.k > 0.0f); m; m &= m - 1)
    warp_sphere_walk(tb, __ffs(m) - 1, ro, rd, w.inv, pad, w.best, cnt);
  if (run) {
    if (flat)
      cluster_walk<true>(tb.cl, tb.nc, tb.sup, tb.nsup, 0, w);
    else
      cluster_walk<false>(tb.cl, tb.nc, tb.sup, tb.nsup, octant(rd), w);
  }
  HitRec best = w.best;
  float sgn = dot3(best.n, rd) > 0.0f ? -1.0f : 1.0f;
  best.n = scale(best.n, sgn);
  if (!(best.t < kInf)) best.flag = 0;
  best.iu = 0.0f;
  best.iv = 0.0f;
  best.tex = -1.0f;
  return best;
}

// Each lane runs the loop of _wavefront_kernel for the pixels it takes,
// iteration for iteration the pixel's column of integrators/pt.py::
// wavefront_loop: regenerate while samples are owed, one bounce, the
// max_path_iters budget, flush finished paths.  Iteration it of pixel i
// draws from fold_in(key, it) at the counters uniform_rows(iter_key(key,
// it), B, 8, start, total) gives lane i, so the pixel sum equals the
// per-bounce tier's.  A pixel is done when its lane has no work left (the
// loop of that pixel leaves it untouched from then on) or after max_total
// iterations; paths cut by that cap still contribute what they gathered.
// kW: the walk (an instance per walk, WalkKind); kWalkIndexed, the
// instance for scenes with a sphere index, walks wide rays by the warp
// (nearest_hit_warp), so there every lane of a warp runs its nearest hit.
template <bool kCount, int kW>
__global__ void __launch_bounds__(kMegaThreads, kMegaMinBlocks)
    render_wavefront_kernel(Tables tb, ShadeCfg c, const float* __restrict__ cam_tab,
                            WavefrontCfg g, const int* __restrict__ px,
                            const int* __restrict__ py, int B, int* __restrict__ work,
                            float* __restrict__ img_out, unsigned long long* __restrict__ counts) {
  typename std::conditional<kCount, CountN<kMegaCounts>, NoCount>::type cnt;
  const int lane = threadIdx.x & 31;
  const Cam cam = load_cam(cam_tab);

  PathState s = {cam.eye, cam.eye, cam.eye, 1.0f, 1.0f, 0, false, true};
  V3 rad = mk(0.f, 0.f, 0.f), img = rad;
  int pix = -1;  // the lane's pixel: -1 before its first, >= B once the work is out
  int sample = 0, path_it = 0, it = 0;
  unsigned my_iters = 0;
  // the lane's pixel has no work left (or has had max_total iterations)
  auto pixel_done = [&]() { return it >= g.max_total || (!s.alive && sample >= g.spp); };
  while (true) {
    // ---- a lane whose pixel is done writes it and takes the next ----
    const bool done = pix < 0 || (pix < B && pixel_done());
    if (done && pix >= 0) {
      if (s.alive && valid3(rad)) img = img + rad;
      store3(img_out, pix, img);
    }
    const unsigned nm = __ballot_sync(kFull, done);
    if (nm) {
      const int leader = __ffs(nm) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(work, __popc(nm));
      base = __shfl_sync(kFull, base, leader);
      if (done) {
        pix = base + __popc(nm & ((1u << lane) - 1u));
        s.ro = cam.eye;
        s.rd = mk(0.f, 0.f, 0.f);
        s.tp = mk(1.f, 1.f, 1.f);
        s.eta = 1.0f;
        s.last_pdf = 1.0f;
        s.dep = 0;
        s.alive = false;
        s.last_delta = true;
        rad = img = mk(0.f, 0.f, 0.f);
        sample = path_it = it = 0;
      }
    }
    if (!__any_sync(kFull, pix < B)) break;
    // nothing to run; its warp goes on (the indexed instance's lane first
    // helps its warp walk the wide rays)
    const bool run = pix < B && !pixel_done();
    if (kW != kWalkIndexed && !run) continue;

    // ---- one iteration of the lane's pixel ----
    ThreefryDraws u{fold_in(g.key, (uint32_t)it), (uint32_t)pix, g.start, g.total};
    if (run) {
      ++my_iters;
      cnt.add(kIters);
      cnt.add(kDraws);
      if (!s.alive) {  // regenerate: the pixel's next sample
        s.rd = primary_dir(cam, (float)px[pix] + u(6), (float)py[pix] + u(7));
        s.ro = cam.eye;
        s.tp = mk(1.f, 1.f, 1.f);
        rad = mk(0.f, 0.f, 0.f);
        s.eta = 1.0f;
        s.dep = 0;
        path_it = 0;
        s.last_delta = true;
        s.last_pdf = 1.0f;
        sample += 1;
        s.alive = true;
        cnt.add(kSamples);
        cnt.add(kDraws, 2u);
      }
      cnt.simt(kWalkLanes);
    }
    HitRec h;
    if constexpr (kW == kWalkIndexed)
      h = nearest_hit_warp(tb, s.ro, s.rd, run, cnt);
    else
      h = nearest_hit_dev<false, kW>(tb, s.ro, s.rd, cnt);
    if (!run) continue;
    cnt.simt(kShadeLanes);
    WalkShadow<decltype(cnt), kW> walk{tb, c.blocks_col, cnt, false};
    rad = rad + shade_from_hit(tb, c, h, s, u, walk);
    if (walk.has) {
      cnt.add(kShadowRays);
      cnt.add(kEvals);
      cnt.add(kPdfs);
      cnt.add(kDraws, 3u);
    }
    if (h.flag == 1) {
      cnt.add(kBsdfSamples);
      cnt.add(kDraws, 3u);
    }
    path_it += 1;
    it += 1;
    const bool alive_out = s.alive && (s.last_delta || s.dep < g.eye_depth) &&
                           (path_it < g.max_path_iters);
    if (!alive_out) {  // flush a finished path into the pixel
      if (valid3(rad)) img = img + rad;
      rad = mk(0.f, 0.f, 0.f);
    }
    s.alive = alive_out;
  }
  if constexpr (kCount) {
    unsigned mx = my_iters;
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_down_sync(kFull, mx, o));
    if (lane == 0) cnt.add(kWarpIterSlots, 32u * mx);
    cnt.flush(counts);
  }
}

template <bool kCount, int kW>
int launch_wavefront(PTK_TABLE_PARAMS, const float* lights,
                     const float* cam, const int* px, const int* py, int B, int spp,
                     int eye_depth, int max_path_iters, int max_total, uint32_t k0, uint32_t k1,
                     uint32_t start, uint32_t total, float clamp_val, int stub_mis,
                     int blocks_col, int* work, float* img, unsigned long long* counts,
                     void* stream) {
  ShadeCfg c{lights, clamp_val, stub_mis, blocks_col};
  WavefrontCfg g{{k0, k1}, start, total, spp, eye_depth, max_path_iters, max_total};
  // persistent blocks: as many as the card holds at once, or fewer
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, render_wavefront_kernel<kCount, kW>, kMegaThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  const int blocks = std::min(resident, (B + kMegaThreads - 1) / kMegaThreads);
  render_wavefront_kernel<kCount, kW><<<blocks, kMegaThreads, 0, (cudaStream_t)stream>>>(
      make_tables(PTK_TABLE_ARGS), c, cam, g, px, py, B, work, img,
      counts);
  return (int)cudaGetLastError();
}

template <bool kCount>
int launch_tex(PTK_TABLE_PARAMS, const float* atlas,
               const int* tex_size, int n_tex, int th1, int tw1, const float* lights,
               const float* ro, const float* rd, const float* tp, const float* eta,
               const int* depth, const bool* act, const bool* last_delta, const float* last_pdf,
               const float* u, int B, float clamp_val, int stub_mis, int blocks_col,
               float* o_rad, float* o_ro, float* o_rd, float* o_tp, float* o_eta, int* o_depth,
               bool* o_alive, bool* o_delta, float* o_pdf, unsigned long long* counts,
               void* stream) {
  StateIn in{ro, rd, tp, eta, depth, act, last_delta, last_pdf, u};
  StateOut out{o_rad, o_ro, o_rd, o_tp, o_eta, o_depth, o_alive, o_delta, o_pdf};
  ShadeCfg c{lights, clamp_val, stub_mis, blocks_col};
  Tex tx{atlas, tex_size, n_tex, th1, tw1};
  const Tables tb = make_tables(PTK_TABLE_ARGS);
  if (nsc)
    shade_step_tex_kernel<kCount, kWalkIndexed><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        tb, tx, c, in, out, B, counts);
  else if (nsup)
    shade_step_tex_kernel<kCount, kWalkSuper><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        tb, tx, c, in, out, B, counts);
  else
    shade_step_tex_kernel<kCount, kWalkFlat><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        tb, tx, c, in, out, B, counts);
  return (int)cudaGetLastError();
}


template <bool kCount, int kW>
cudaError_t launch_step_at(const Tables& tb, const ShadeCfg& c, const StateIn& in,
                           const StateOut& out, int B, unsigned long long* counts,
                           cudaStream_t stream) {
  auto* fn = shade_step_kernel<kCount, kW>;
  fn<<<blocks_for(B), kThreads, 0, stream>>>(tb, c, in, out, B, counts);
  return cudaGetLastError();
}

// #3's instance at the scene's walk (the flat one below 64 clusters).
template <bool kCount>
int launch_step(PTK_TABLE_PARAMS, const float* lights,
                const float* ro, const float* rd, const float* tp, const float* eta,
                const int* depth, const bool* act, const bool* last_delta, const float* last_pdf,
                const float* u, int B, float clamp_val, int stub_mis, int blocks_col, float* o_rad,
                float* o_ro, float* o_rd, float* o_tp, float* o_eta, int* o_depth, bool* o_alive,
                bool* o_delta, float* o_pdf, unsigned long long* counts, void* stream) {
  StateIn in{ro, rd, tp, eta, depth, act, last_delta, last_pdf, u};
  StateOut out{o_rad, o_ro, o_rd, o_tp, o_eta, o_depth, o_alive, o_delta, o_pdf};
  ShadeCfg c{lights, clamp_val, stub_mis, blocks_col};
  auto* go = nsc    ? &launch_step_at<kCount, kWalkIndexed>
             : nsup ? &launch_step_at<kCount, kWalkSuper>
                    : &launch_step_at<kCount, kWalkFlat>;
  return (int)go(make_tables(PTK_TABLE_ARGS), c, in, out, B, counts,
                 (cudaStream_t)stream);
}

// The grid of a launch of #1 or #2 (for_lanes): with a mask and kQueue,
// as many persistent blocks as the card holds at once (fewer for a small
// B), the span counter zeroed first on the stream; else a thread a lane.
// The host queries are made once per kernel instance, so a launch
// enqueues only the memset and the kernel (and can be captured in a CUDA
// graph).
template <bool kQueue, class F>
cudaError_t lanes_grid(F fn, const bool* live, int B, cudaStream_t stream, int* blocks) {
  *blocks = blocks_for(B);
  if (!kQueue || !live) return cudaSuccess;
  static int* work = nullptr;
  static F fns[16];
  static int resident[16], n = 0;
  int k = 0;
  while (k < n && fns[k] != fn) ++k;
  cudaError_t err = cudaSuccess;
  if (!work) err = cudaGetSymbolAddress((void**)&work, g_lane_work);
  if (err == cudaSuccess && k == n) {
    err = persistent_blocks(fn, kThreads, 0, 1 << 30, &resident[k]);
    fns[k] = fn;
    n += err == cudaSuccess;
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(work, 0, sizeof(int), stream);
  *blocks = std::min(resident[k], *blocks);
  return err;
}

// #1's instance at the scene's walk (the flat one below 64 clusters).
template <bool kCount>
int launch_hit(PTK_TABLE_PARAMS, int with_uv, const float* ro,
               const float* rd, const bool* live, int B, float* out, int* flag,
               unsigned long long* counts, void* stream) {
  auto* fn = with_uv ? (nsc    ? &nearest_hit_uv_kernel<kCount, kWalkIndexed>
                        : nsup ? &nearest_hit_uv_kernel<kCount, kWalkSuper>
                               : &nearest_hit_uv_kernel<kCount, kWalkFlat>)
                     : (nsc    ? &nearest_hit_kernel<kCount, kWalkIndexed>
                        : nsup ? &nearest_hit_kernel<kCount, kWalkSuper>
                               : &nearest_hit_kernel<kCount, kWalkFlat>);
  int blocks = 0;
  cudaError_t err = lanes_grid<kHitQueue>(fn, live, B, (cudaStream_t)stream, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(PTK_TABLE_ARGS), ro, rd, live, B, out, flag, counts);
  return (int)cudaGetLastError();
}

// #2's instance at the scene's walk.
template <bool kCount>
int launch_blocker(PTK_TABLE_PARAMS, const float* p1,
                   const float* rd, const float* max_d, const bool* live, int B, int blocks_col,
                   bool* out, unsigned long long* counts, void* stream) {
  auto* fn = nsc    ? &any_blocker_kernel<kCount, kWalkIndexed>
             : nsup ? &any_blocker_kernel<kCount, kWalkSuper>
                    : &any_blocker_kernel<kCount, kWalkFlat>;
  int blocks = 0;
  cudaError_t err = lanes_grid<kShadowQueue>(fn, live, B, (cudaStream_t)stream, &blocks);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(PTK_TABLE_ARGS), p1, rd, max_d, live, B, blocks_col,
      out, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.  The scene
// tables come first in every entry (PTK_TABLE_PARAMS).

// live: the lanes whose result is read (null: every lane); a lane that
// is not live gets #1's miss record or #2's false.
int pt_nearest_hit(PTK_TABLE_PARAMS, int with_uv,
                   const float* ro, const float* rd, const bool* live, int B, float* out,
                   int* flag, void* stream) {
  return launch_hit<false>(PTK_TABLE_ARGS, with_uv, ro, rd, live, B, out,
                           flag, nullptr, stream);
}

// The counting build of #1: the same records, and the walk's counters
// added into counts[kNumCounts] (zeroed by the caller).
int pt_nearest_hit_counts(PTK_TABLE_PARAMS, int with_uv,
                          const float* ro, const float* rd, const bool* live, int B, float* out,
                          int* flag, unsigned long long* counts, void* stream) {
  return launch_hit<true>(PTK_TABLE_ARGS, with_uv, ro, rd, live, B, out,
                          flag, counts, stream);
}

int pt_any_blocker(PTK_TABLE_PARAMS, const float* p1,
                   const float* rd, const float* max_d, const bool* live, int B, int blocks_col,
                   bool* out, void* stream) {
  return launch_blocker<false>(PTK_TABLE_ARGS, p1, rd, max_d, live, B,
                               blocks_col, out, nullptr, stream);
}

// The counting build of #2: the same verdicts, and the walk's counters
// added into counts[kNumCounts] (zeroed by the caller).
int pt_any_blocker_counts(PTK_TABLE_PARAMS, const float* p1,
                          const float* rd, const float* max_d, const bool* live, int B,
                          int blocks_col, bool* out, unsigned long long* counts, void* stream) {
  return launch_blocker<true>(PTK_TABLE_ARGS, p1, rd, max_d, live, B,
                              blocks_col, out, counts, stream);
}

// ks: the legacy rows (ns + nt, 4); out (B, 3); a lane that is not live
// (live null: every lane is) gets 1.
int pt_transmittance_rgb(PTK_TABLE_PARAMS, const float* ks,
                         const float* p1, const float* rd, const float* max_d, const bool* live,
                         int B, float* out, void* stream) {
  auto* fn = nsup ? &transmittance_rgb_kernel<kWalkSuper> : &transmittance_rgb_kernel<kWalkFlat>;
  fn<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(PTK_TABLE_ARGS), ks, p1, rd, max_d, live, B, out);
  return (int)cudaGetLastError();
}

// occupancy_row of nearest_hit, nearest_hit_counts, any_blocker and
// any_blocker_counts in turn (their flat-walk instances, the text scenes').
int pt_hit_occupancy(int* out) {
  const void* fns[4] = {(const void*)nearest_hit_kernel<false, kWalkFlat>,
                        (const void*)nearest_hit_kernel<true, kWalkFlat>,
                        (const void*)any_blocker_kernel<false, kWalkFlat>,
                        (const void*)any_blocker_kernel<true, kWalkFlat>};
  for (int k = 0; k < 4; ++k) {
    cudaError_t err = occupancy_row(fns[k], kThreads, 0, out + 5 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int pt_shade_step(PTK_TABLE_PARAMS, const float* lights,
                  const float* ro, const float* rd, const float* tp, const float* eta,
                  const int* depth, const bool* act, const bool* last_delta, const float* last_pdf,
                  const float* u, int B, float clamp_val, int stub_mis, int blocks_col,
                  float* o_rad, float* o_ro, float* o_rd, float* o_tp, float* o_eta, int* o_depth,
                  bool* o_alive, bool* o_delta, float* o_pdf, void* stream) {
  return launch_step<false>(PTK_TABLE_ARGS, lights, ro, rd, tp, eta, depth,
                            act, last_delta, last_pdf, u, B, clamp_val, stub_mis, blocks_col,
                            o_rad, o_ro, o_rd, o_tp, o_eta, o_depth, o_alive, o_delta, o_pdf,
                            nullptr, stream);
}

// The counting build of #3: the same outputs, and the work counters added
// into counts[kMegaCounts] (zeroed by the caller).
int pt_shade_step_counts(PTK_TABLE_PARAMS,
                         const float* lights, const float* ro, const float* rd, const float* tp,
                         const float* eta, const int* depth, const bool* act,
                         const bool* last_delta, const float* last_pdf, const float* u, int B,
                         float clamp_val, int stub_mis, int blocks_col, float* o_rad,
                         float* o_ro, float* o_rd, float* o_tp, float* o_eta, int* o_depth,
                         bool* o_alive, bool* o_delta, float* o_pdf,
                         unsigned long long* counts, void* stream) {
  return launch_step<true>(PTK_TABLE_ARGS, lights, ro, rd, tp, eta, depth,
                           act, last_delta, last_pdf, u, B, clamp_val, stub_mis, blocks_col,
                           o_rad, o_ro, o_rd, o_tp, o_eta, o_depth, o_alive, o_delta, o_pdf,
                           counts, stream);
}

int pt_shade_step_tex(PTK_TABLE_PARAMS, const float* atlas,
                      const int* tex_size, int n_tex, int th1, int tw1, const float* lights,
                      const float* ro, const float* rd, const float* tp, const float* eta,
                      const int* depth, const bool* act, const bool* last_delta,
                      const float* last_pdf, const float* u, int B, float clamp_val, int stub_mis,
                      int blocks_col, float* o_rad, float* o_ro, float* o_rd, float* o_tp,
                      float* o_eta, int* o_depth, bool* o_alive, bool* o_delta, float* o_pdf,
                      void* stream) {
  return launch_tex<false>(PTK_TABLE_ARGS, atlas, tex_size, n_tex, th1,
                           tw1, lights, ro, rd, tp, eta, depth, act, last_delta, last_pdf, u, B,
                           clamp_val, stub_mis, blocks_col, o_rad, o_ro, o_rd, o_tp, o_eta,
                           o_depth, o_alive, o_delta, o_pdf, nullptr, stream);
}

// The counting build of #4: the same outputs, and the work counters added
// into counts[kMegaCounts] (zeroed by the caller).
int pt_shade_step_tex_counts(PTK_TABLE_PARAMS,
                             const float* atlas, const int* tex_size, int n_tex, int th1,
                             int tw1, const float* lights, const float* ro, const float* rd,
                             const float* tp, const float* eta, const int* depth,
                             const bool* act, const bool* last_delta, const float* last_pdf,
                             const float* u, int B, float clamp_val, int stub_mis,
                             int blocks_col, float* o_rad, float* o_ro, float* o_rd,
                             float* o_tp, float* o_eta, int* o_depth, bool* o_alive,
                             bool* o_delta, float* o_pdf, unsigned long long* counts,
                             void* stream) {
  return launch_tex<true>(PTK_TABLE_ARGS, atlas, tex_size, n_tex, th1,
                          tw1, lights, ro, rd, tp, eta, depth, act, last_delta, last_pdf, u, B,
                          clamp_val, stub_mis, blocks_col, o_rad, o_ro, o_rd, o_tp, o_eta,
                          o_depth, o_alive, o_delta, o_pdf, counts, stream);
}

// work: one int32, zeroed by the caller (the next pixel to hand out).
int pt_render_wavefront(PTK_TABLE_PARAMS, const float* lights,
                        const float* cam, const int* px, const int* py, int B, int spp,
                        int eye_depth, int max_path_iters, int max_total, uint32_t k0, uint32_t k1,
                        uint32_t start, uint32_t total, float clamp_val, int stub_mis,
                        int blocks_col, int* work, float* img, void* stream) {
  auto* launch = nsc    ? &launch_wavefront<false, kWalkIndexed>
                 : nsup ? &launch_wavefront<false, kWalkSuper>
                        : &launch_wavefront<false, kWalkFlat>;
  return launch(PTK_TABLE_ARGS, lights, cam, px, py, B, spp, eye_depth,
                max_path_iters, max_total, k0, k1, start, total, clamp_val, stub_mis, blocks_col,
                work, img, nullptr, stream);
}

// The counting build of #5: the same image, and the work counters added
// into counts[kMegaCounts] (zeroed by the caller).
int pt_render_wavefront_counts(PTK_TABLE_PARAMS,
                               const float* lights, const float* cam, const int* px, const int* py,
                               int B, int spp, int eye_depth, int max_path_iters, int max_total,
                               uint32_t k0, uint32_t k1, uint32_t start, uint32_t total,
                               float clamp_val, int stub_mis, int blocks_col, int* work, float* img,
                               unsigned long long* counts, void* stream) {
  auto* launch = nsc    ? &launch_wavefront<true, kWalkIndexed>
                 : nsup ? &launch_wavefront<true, kWalkSuper>
                        : &launch_wavefront<true, kWalkFlat>;
  return launch(PTK_TABLE_ARGS, lights, cam, px, py, B, spp, eye_depth,
                max_path_iters, max_total, k0, k1, start, total, clamp_val, stub_mis, blocks_col,
                work, img, counts, stream);
}

// occupancy_row of shade_step and shade_step_counts in turn (their
// flat-walk instances, the fused tier's on the text scenes).
int pt_step_occupancy(int* out) {
  const void* fns[2] = {(const void*)shade_step_kernel<false, kWalkFlat>,
                        (const void*)shade_step_kernel<true, kWalkFlat>};
  for (int k = 0; k < 2; ++k) {
    cudaError_t err = occupancy_row(fns[k], kThreads, 0, out + 5 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// occupancy_row of render_wavefront and render_wavefront_counts in turn
// (their flat-walk instances, the main path's on the text scenes).
int pt_mega_occupancy(int* out) {
  cudaError_t err = occupancy_row((const void*)render_wavefront_kernel<false, kWalkFlat>,
                                  kMegaThreads, 0, out);
  if (err == cudaSuccess)
    err = occupancy_row((const void*)render_wavefront_kernel<true, kWalkFlat>, kMegaThreads, 0,
                        out + 5);
  return (int)err;
}

int pt_threefry_rows(uint32_t k0, uint32_t k1, int n, int P, uint32_t start, uint32_t total,
                     float* out, void* stream) {
  threefry_rows_kernel<<<blocks_for((long long)n * P), kThreads, 0, (cudaStream_t)stream>>>(
      Key{k0, k1}, n, P, start, total, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
