// Hand-written CUDA kernels of the PT main path, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libpt_kernels.so pt_kernels.cu
// --fmad=false keeps multiplies and adds separately rounded, as the plain
// PyTorch versions round them, so kernel and plain version agree to a few
// ulps; no --use_fast_math.
//
// One thread per lane (ray), masked i < B.  Scene tables are read from
// global memory through const __restrict__ pointers: the scenes of this
// path are a few KB and stay in L1/L2.  No atomics; every output is a pure
// function of the lane's inputs, so a render is deterministic per seed.
//
// 1. nearest_hit  replaces path_tracing_tpu/ops/pallas_intersect.py
//                 nearest_hit_pallas (_nearest_kernel / _nearest_vmem_body).
// 2. any_blocker  replaces pallas_intersect.py any_blocker_pallas
//                 (_blocker_kernel / _blocker_vmem_body).
// 3. shade_step   replaces path_tracing_tpu/ops/pallas_shade.py
//                 shade_step_pallas (_shade_kernel -> _shade_core ->
//                 _shade_from_hit): one fused PT bounce.
//
// What bounds them on this card: the primitive sweeps are compute work per
// ray (about 45 primitive tests per ray on a 36-triangle box); memory
// traffic is the ray state, 40-130 bytes per lane.  The TPU kernels cull
// clusters per 4096-ray tile (jnp.any over the tile); here each ray culls
// the clusters it cannot enter on its own, which needs no cross-lane vote
// and skips more work.  The fused shade step is one large kernel whose cost
// is registers (it holds hit, material, NEE and BSDF state at once): lanes
// that are not active, not eligible for NEE, or end at a light skip the
// sweeps and the sample they do not need, so dead lanes cost a load and a
// store.  Shared-memory staging of the tables, the 2-level super-cluster
// walk and ray compaction are later work.

#include "pt_device.cuh"

using namespace ptk;

namespace {

__global__ void nearest_hit_kernel(Tables tb, const float* __restrict__ ro,
                                   const float* __restrict__ rd, int B, float* __restrict__ out,
                                   int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  HitRec h = nearest_hit_dev(tb, load3(ro, i), load3(rd, i));
  // fields as rows of a (10, B) table: t n3 bc3 rough metal eta
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
  flag[i] = h.flag;
}

__global__ void any_blocker_kernel(Tables tb, const float* __restrict__ p1,
                                   const float* __restrict__ rd, const float* __restrict__ max_d,
                                   int B, int blocks_col, bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  out[i] = shadow_blocked_dev(tb, load3(p1, i), load3(rd, i), max_d[i], blocks_col);
}

struct ShadeIn {
  const float* __restrict__ lights;  // (nl, 12)
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

struct ShadeOut {
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

__global__ void shade_step_kernel(Tables tb, ShadeIn in, ShadeOut out, int B, float clamp_val,
                                  int stub_mis, int blocks_col) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int nl = tb.nl;
  V3 ro = load3(in.ro, i), rd = load3(in.rd, i), tp = load3(in.tp, i);
  float eta = in.eta[i];
  int dep = in.depth[i];
  bool last_delta = in.last_delta[i];
  float last_pdf = in.last_pdf[i];
  V3 radiance = mk(0.f, 0.f, 0.f);

  // default outputs: the lane's state passes through unchanged
  V3 o_ro = ro, o_rd = rd, o_tp = tp;
  float o_eta = eta, o_pdf = last_pdf;
  int o_dep = dep;
  bool o_alive = false, o_delta = last_delta;

  if (in.act[i]) {
    HitRec h = nearest_hit_dev(tb, ro, rd);
    V3 n = h.n;
    const Mtl& m = h.m;
    V3 pos = ro + scale(rd, h.t);
    bool is_light = h.flag == 2;
    bool act = h.flag > 0;
    V3 wo = -rd;

    // ---- 1. light-ball emission: the first light whose ball surface is
    // within 1e-2 of the hit, flux -> radiance with the spot-cone gate ----
    if (is_light) {
      int found = 0;
      float e_area = 1.0f, e_cut = 0.0f;
      int e_par = 0;
      V3 e_d = mk(0.f, 0.f, 0.f), e_i = mk(0.f, 0.f, 0.f), c2h_sel = mk(0.f, 0.f, 0.f);
      for (int l = 0; l < nl && !found; ++l) {
        const float* L = in.lights + l * kLightCols;
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
      if (spot && dep == 0) cone = 1.0f;  // the full cone at depth 0
      if (spot && dep != 0 && behind) cone = 0.0f;
      bool e_ok = found && (cone > 0.0f);
      float inv_ac = 1.0f / jmax(e_area * cone, 1e-20f);
      V3 emission = e_ok ? scale(e_i, inv_ac) : mk(0.f, 0.f, 0.f);
      bool has_e = (emission.x > 0.0f) || (emission.y > 0.0f) || (emission.z > 0.0f);
      if (has_e) {
        V3 c_delta = mul(tp, emission);
        c_delta = valid3(c_delta) ? clamp3(c_delta, clamp_val) : mk(0.f, 0.f, 0.f);
        V3 contrib;
        if (stub_mis) {
          // the reference's stubbed MIS strategy A: a BSDF ray that hits a
          // light from a non-delta vertex adds nothing
          contrib = last_delta ? c_delta : mk(0.f, 0.f, 0.f);
        } else {
          float cos_l = jmax(dot3(n, wo), 1e-6f);
          float pdf_l = (1.0f / ((float)nl * e_area)) * h.t * h.t / cos_l;
          float p_b = last_pdf * last_pdf;
          float p_l = pdf_l * pdf_l;
          float mis_w = p_b / jmax(p_b + p_l, 1e-8f);
          V3 c_mis = scale(mul(tp, emission), mis_w);
          c_mis = (found && valid3(c_mis)) ? clamp3(c_mis, clamp_val) : mk(0.f, 0.f, 0.f);
          contrib = last_delta ? c_delta : c_mis;
        }
        radiance = radiance + contrib;
      }
    }

    bool alive = act && !is_light;

    // ---- 2. NEE on non-delta surfaces: one light picked uniformly ----
    bool elig = alive && (m.eta <= 0.0f) && ((m.metal < 0.99f) || (m.rough > 0.01f));
    if (elig && nl > 0) {
      float u0 = in.u[0 * B + i], u1 = in.u[1 * B + i], u2 = in.u[2 * B + i];
      int li = min((int)(u0 * (float)nl), nl - 1);
      const float* L = in.lights + li * kLightCols;
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
      bool blocked = shadow_blocked_dev(tb, p1, srd, sdist - kMinD, blocks_col);
      float tr = blocked ? 0.0f : 1.0f;

      V3 brdf;
      float pdf_b;
      eval_pdf_world(m, wo, wi, n, &brdf, &pdf_b);
      V3 base = mul(mul(tp, brdf), l_illum);
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
      nee = valid3(nee) ? clamp3(nee, clamp_val) : mk(0.f, 0.f, 0.f);
      radiance = radiance + nee;
    }

    // ---- 3. BSDF sample and state update (surface hits only) ----
    if (alive) {
      BsdfSample s = bsdf_sample_dev(m, wo, n, in.u[3 * B + i], in.u[4 * B + i], in.u[5 * B + i],
                                     eta);
      bool dead = (s.pdf <= 0.0f) && !s.is_delta;
      alive = alive && !dead;
      float cos_wi = fabsf(dot3(n, s.wi));
      float w = s.is_delta ? 1.0f : cos_wi / jmax(s.pdf, 1e-20f);
      V3 new_tp = scale(mul(tp, s.val), w);
      alive = alive && valid3(new_tp);
      V3 off = scale(dot3(s.wi, n) < 0.0f ? -n : n, kEps);
      o_ro = s.is_delta ? pos + off : pos + scale(n, kEps);
      o_rd = s.wi;
      o_tp = new_tp;
      o_eta = s.new_eta;
      o_dep = dep + (s.is_delta ? 0 : 1);  // delta bounces do not consume depth
      o_alive = alive;
      o_delta = s.is_delta;
      if (!s.is_delta) o_pdf = s.pdf;
    }
  }

  store3(out.rad, i, radiance);
  store3(out.ro, i, o_ro);
  store3(out.rd, i, o_rd);
  store3(out.tp, i, o_tp);
  out.eta[i] = o_eta;
  out.depth[i] = o_dep;
  out.alive[i] = o_alive;
  out.delta[i] = o_delta;
  out.pdf[i] = o_pdf;
}

constexpr int kThreads = 128;

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

inline Tables make_tables(const float* sph, int ns, int nl, const float* tri, const float* cl,
                          int nc) {
  Tables tb;
  tb.sph = sph;
  tb.ns = ns;
  tb.nl = nl;
  tb.tri = tri;
  tb.cl = cl;
  tb.nc = nc;
  return tb;
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.

int pt_nearest_hit(const float* sph, int ns, int nl, const float* tri, const float* cl, int nc,
                   const float* ro, const float* rd, int B, float* out, int* flag, void* stream) {
  nearest_hit_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, cl, nc), ro, rd, B, out, flag);
  return (int)cudaGetLastError();
}

int pt_any_blocker(const float* sph, int ns, int nl, const float* tri, const float* cl, int nc,
                   const float* p1, const float* rd, const float* max_d, int B, int blocks_col,
                   bool* out, void* stream) {
  any_blocker_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, cl, nc), p1, rd, max_d, B, blocks_col, out);
  return (int)cudaGetLastError();
}

int pt_shade_step(const float* sph, int ns, int nl, const float* tri, const float* cl, int nc,
                  const float* lights, const float* ro, const float* rd, const float* tp,
                  const float* eta, const int* depth, const bool* act, const bool* last_delta,
                  const float* last_pdf, const float* u, int B, float clamp_val, int stub_mis,
                  int blocks_col, float* o_rad, float* o_ro, float* o_rd, float* o_tp,
                  float* o_eta, int* o_depth, bool* o_alive, bool* o_delta, float* o_pdf,
                  void* stream) {
  ShadeIn in{lights, ro, rd, tp, eta, depth, act, last_delta, last_pdf, u};
  ShadeOut out{o_rad, o_ro, o_rd, o_tp, o_eta, o_depth, o_alive, o_delta, o_pdf};
  shade_step_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_tables(sph, ns, nl, tri, cl, nc), in, out, B, clamp_val, stub_mis, blocks_col);
  return (int)cudaGetLastError();
}

}  // extern "C"
