// Hand-written CUDA kernels of the BDPT eye pass, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use, beside pt_kernels.cu):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libbdpt_kernels.so bdpt_kernels.cu
//
// 8. connect   replaces path_tracing_tpu/ops/pallas_connect.py connect_pallas
//              (_connect_kernel -> connect_core): per eye vertex, the sum of
//              its connections to every valid light vertex.
// 9. bdpt_eye  replaces path_tracing_tpu/ops/pallas_bdpt_eye.py
//              bdpt_eye_pallas (_bdpt_eye_kernel): the whole eye pass of a
//              frame, every sample of a pixel in one thread.
//
// One thread per eye lane (pixel), no atomics: a pixel's sum is a pure
// function of its inputs, added in a fixed order, so renders are
// deterministic per seed and #9 equals the per-bounce tier that launches #8.
//
// What bounds them on this card: compute per thread.  Each connection is
// ~300 flops of geometry and two BSDF evaluations plus a shadow ray that
// walks every sphere and the clusters it enters (45 primitive tests on the
// 36-triangle cornell box), and every eye vertex sweeps all V light
// vertices (V ~ 810 on cornell for the exact sweep at spl 8, or Kp = 32 after tile
// RIS).  The table is 160 bytes a row and a few hundred KB at most: it
// stays in L1/L2 and every warp reads the same row at the same time, so
// the loads broadcast.  Rows whose gate closes are skipped before the work
// they would waste (geometry gates before the BSDF math, zero evaluations
// before the shadow sweep), which gives the same sum because the reference
// adds +0 for them.  The TPU kernel skipped the shadow sweep only when no
// lane of its 16K-lane tile needed it; here each thread skips on its own,
// at the price of divergence inside a warp.  Shared-memory staging of the
// table, warp-level shadow culling and lane compaction are later work.
//
// The random numbers are the per-bounce tier's Threefry stream, drawn in
// the thread: sample s keys k_s = fold_in(k02, s) with k02 = fold_in(key,
// 0x0202) from the host; the jitter is rows 0-1 of fold_in(k_s, 0xA11CE) and
// bounce `it` draws rows 0-2 of fold_in(fold_in(k_s, 0xE7E), it); row j of
// a key sits at the lane's counter j*total + start + lane.

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr float kPdfFwdFloor = 1e-8f;

// Connections of the eye vertices: (B, 3) inputs row-major, the material
// as (B,) rows, and rows [0, n_valid) of the shared (V, 40) table.
struct ConnectIn {
  const float* __restrict__ pos;
  const float* __restrict__ n;
  const float* __restrict__ tp;
  const float* __restrict__ bc;
  const float* __restrict__ rough;
  const float* __restrict__ metal;
  const float* __restrict__ eta;
  const float* __restrict__ wo_e;
  const float* __restrict__ wo_s;
  const float* __restrict__ eye_f;
  const bool* __restrict__ act;
};

__global__ void connect_kernel(Tables tb, const float* __restrict__ lv, int n_valid, ConnectIn in,
                               int B, float clamp_val, int blocks_col, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  V3 acc = mk(0.f, 0.f, 0.f);
  if (in.act[i]) {
    Mtl m = {load3(in.bc, i), in.rough[i], in.metal[i], in.eta[i]};
    EyeVertex e = make_eye_vertex(load3(in.pos, i), load3(in.n, i), load3(in.tp, i), m,
                                  load3(in.wo_e, i), load3(in.wo_s, i), in.eye_f[i]);
    acc = connect_dev(tb, lv, n_valid, e, clamp_val, blocks_col);
  }
  store3(out, i, acc);
}

struct EyeCfg {
  Key k02;                 // fold_in(key, 0x0202)
  uint32_t start, total;   // this lane is column start + i of a total-lane render
  int spp, eye_depth, max_iters;
  float clamp_val, light_hit_scale;
  int blocks_col;
};

// The light-vertex rows of pixel i: the shared table, or its tile's table
// (tile_stride floats apart, one per tile_lanes consecutive pixels).
struct EyeTable {
  const float* __restrict__ lv;
  int n_valid, tile_lanes;
  long long tile_stride;
  __device__ __forceinline__ const float* rows(int i) const {
    return tile_lanes > 0 ? lv + (long long)(i / tile_lanes) * tile_stride : lv;
  }
};

// One sample of eye_trace_and_connect for one lane, iteration for
// iteration the lane's column of integrators/bdpt.py::eye_sample: hit, the
// depth-0 light credit, the connection sweep, the BSDF bounce and the G
// recurrence.  A path that dies is untouched by later iterations of that
// loop, so the thread stops.  Returns the sample's radiance.
__device__ V3 eye_sample_dev(const Tables& tb, const Cam& cam, const EyeCfg& g,
                             const float* __restrict__ rows, int n_valid, float fpx, float fpy,
                             uint32_t lane, int s) {
  Key ks = fold_in(g.k02, (uint32_t)s);
  Key kj = fold_in(ks, 0xA11CEu);
  Key ke = fold_in(ks, 0xE7Eu);
  V3 rd = primary_dir(cam, fpx + uniform_at(kj, 0, lane, g.start, g.total),
                      fpy + uniform_at(kj, 1, lane, g.start, g.total));
  V3 ro = cam.eye, last_p = cam.eye, prev_v = cam.eye, last_n = rd;
  V3 tp = mk(1.f, 1.f, 1.f), rad = mk(0.f, 0.f, 0.f);
  float eta = 1.0f, last_pdf = 1.0f, g_mis = 0.0f;
  int dep = 0;
  for (int it = 0; it < g.max_iters; ++it) {
    HitRec h = nearest_hit_dev<false>(tb, ro, rd);
    if (h.flag == 0) break;  // a miss ends the path
    const V3 n = h.n;
    const Mtl& m = h.m;
    V3 pos = ro + scale(rd, h.t);
    if (h.flag == 2 && dep == 0) {  // the camera sees a light ball
      rad = rad + scale(m.bc, g.light_hit_scale);
      break;
    }

    // ---- connect the vertex to the light vertices ----
    V3 wo_e = -rd;
    V3 wo_s = dep == 0 ? normalize3(cam.eye - pos) : normalize3(prev_v - pos);
    float eye_f = (dep == 0 || m.eta > 0.0f) ? 0.0f : (1.0f / kPdfFwdFloor) * (1.0f + g_mis);
    EyeVertex e = make_eye_vertex(pos, n, tp, m, wo_e, wo_s, eye_f);
    rad = rad + connect_dev(tb, rows, n_valid, e, g.clamp_val, g.blocks_col);

    // ---- bounce ----
    V3 d_vec = pos - last_p;
    float dist2 = dot3(d_vec, d_vec);
    if (!(dist2 >= 1e-6f)) break;
    float cos_at_hit = fabsf(dot3(n, -rd));
    float cos_at_prev = fabsf(dot3(last_n, rd));
    float pdf_fwd = last_pdf * cos_at_hit / jmax(dist2, 1e-20f);
    Key ki = fold_in(ke, (uint32_t)it);
    BsdfSample b = bsdf_sample_dev(m, wo_e, n, uniform_at(ki, 0, lane, g.start, g.total),
                                   uniform_at(ki, 1, lane, g.start, g.total),
                                   uniform_at(ki, 2, lane, g.start, g.total), eta);
    if (!((b.pdf > 0.0f) || b.is_delta)) break;
    bool rough = !b.is_delta;
    // pdf_rev: bsdf_pdf(m, wo = sampled wi, wi = wo_e) in the hit frame
    V3 ft, fb;
    build_frame(n, &ft, &fb);
    V3 wi_b_l = to_local(b.wi, ft, fb, n);
    V3 wo_e_l = to_local(wo_e, ft, fb, n);
    bool wh_ok;
    V3 wh = half_vector(wi_b_l, wo_e_l, &wh_ok);
    float pdf_rev = pdf_local(m, wi_b_l, wo_e_l, roughness_to_alpha(m.rough), wh, wh_ok) *
                    cos_at_prev / jmax(dist2, 1e-20f);
    float g_new = (dep == 0 || m.eta > 0.0f)
                      ? 0.0f
                      : (1.0f + pdf_rev * g_mis) / jmax(pdf_fwd, kPdfFwdFloor);
    float w = b.is_delta ? 1.0f : fabsf(dot3(n, b.wi)) / jmax(b.pdf, 1e-20f);
    V3 new_tp = scale(mul(tp, b.val), w);
    V3 off = scale(dot3(b.wi, n) < 0.0f ? -n : n, kEps);
    ro = b.is_delta ? pos + off : pos + scale(n, kEps);
    rd = b.wi;
    tp = new_tp;
    eta = b.new_eta;
    dep += rough ? 1 : 0;
    last_n = n;
    last_p = pos;
    last_pdf = b.is_delta ? 1.0f : b.pdf;
    if (rough) {
      g_mis = g_new;
      prev_v = pos;
    }
    if (!(valid3(new_tp) && (b.is_delta || dep < g.eye_depth))) break;
  }
  return rad;
}

__global__ void bdpt_eye_kernel(Tables tb, EyeTable tab, const float* __restrict__ cam_tab,
                                EyeCfg g, const int* __restrict__ px, const int* __restrict__ py,
                                int B, float* __restrict__ img_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const Cam cam = load_cam(cam_tab);
  const float* rows = tab.rows(i);
  V3 img = mk(0.f, 0.f, 0.f);
  for (int s = 0; s < g.spp; ++s) {
    V3 rad = eye_sample_dev(tb, cam, g, rows, tab.n_valid, (float)px[i], (float)py[i],
                            (uint32_t)i, s);
    if (valid3(rad)) img = img + rad;
  }
  store3(img_out, i, img);
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.  The scene
// tables come first: sph, ns, nl, tri, uv, cl, n_clusters.

int pt_connect(const float* sph, int ns, int nl, const float* tri, const float* uv,
               const float* cl, int nc, const float* lv, int n_valid, const float* pos,
               const float* n, const float* tp, const float* bc, const float* rough,
               const float* metal, const float* eta, const float* wo_e, const float* wo_s,
               const float* eye_f, const bool* act, int B, float clamp_val, int blocks_col,
               float* out, void* stream) {
  ConnectIn in{pos, n, tp, bc, rough, metal, eta, wo_e, wo_s, eye_f, act};
  connect_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, uv, cl, nc), lv, n_valid, in, B, clamp_val, blocks_col, out);
  return (int)cudaGetLastError();
}

int pt_bdpt_eye(const float* sph, int ns, int nl, const float* tri, const float* uv,
                const float* cl, int nc, const float* lv, int n_valid, int tile_lanes,
                long long tile_stride, const float* cam, const int* px, const int* py, int B,
                int spp, int eye_depth, int max_iters, uint32_t k0, uint32_t k1, uint32_t start,
                uint32_t total, float clamp_val, int blocks_col, float light_hit_scale,
                float* img, void* stream) {
  EyeTable tab{lv, n_valid, tile_lanes, tile_stride};
  EyeCfg g{{k0, k1}, start, total, spp, eye_depth, max_iters, clamp_val, light_hit_scale,
           blocks_col};
  bdpt_eye_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, uv, cl, nc), tab, cam, g, px, py, B, img);
  return (int)cudaGetLastError();
}

}  // extern "C"
