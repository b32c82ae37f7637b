// Device functions shared by the kernels of pt_kernels.cu and
// bdpt_kernels.cu: Threefry, ray-primitive tests, the cluster walk, nearest
// hit (optionally with the winner's interpolated UVs), the shadow sweep, the
// bilinear atlas fetch, Fresnel, GGX, VNDF sampling, BSDF eval/pdf,
// bsdf_sample, the camera ray and the BDPT connection sweep.
//
// The math follows path_tracing_tpu/ops/pallas_shade.py and
// pallas_intersect.py operation for operation (built with --fmad=false, so
// each multiply and add rounds on its own), including the reference quirks:
// the non-normalized GGX D (alpha^2 + tan^4), the eta = 0 Fresnel edge and
// the light-ball material.  max/min propagate NaN as jnp.maximum does.
//
// Scene tables (row-major float32, see ops/cuda_intersect.py::pack_scene):
//   sph (Ms, 16): cx cy cz r | blocks_gpu blocks_cpu 0 0 | r g b rough metal
//                 eta is_light 0        (spheres, then light balls)
//   tri (Mt, 24): v0 v1 v2 | blocks_gpu blocks_cpu 0 | n3 0 | r g b rough
//                 metal eta 0 0
//   uv  (Mt, 8):  u0 v0 u1 v1 u2 v2 tex 0   (tex = -1: untextured)
//   cl  (Mc, 8):  min3 max3 start count; from SUPER_MIN_CLUSTERS (64)
//                 clusters on (Mc, 16): the same, then the relative index
//                 of the row's child in each octant's front-to-back order
//   sup (NS, 16): min3 max3 0 count | super order per octant, the union
//                 boxes of 16 consecutive clusters (nsup 0: none, the flat
//                 walk); ops/cuda_intersect.py::super_table builds both
//   scl, ssup:    the sphere index, cl's and sup's layout over the spheres
//                 sph[0, ns) (nsc 0: none, every ray tests each sphere),
//                 then one row min3 max3 r_min 0 of its bounds and least
//                 radius
//   lights (Nl, 12): pos3 dir3 illum3 cutoff is_parallel ball_r
//   light vertices (V, 40): see ops/cuda_connect.py::pack_light_vertices
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptk {

constexpr float kEps = 1e-4f;      // EPSILON of ops/math3.py
constexpr float kInf = 1e20f;      // miss sentinel
constexpr float kPi = 3.14159265358979323846f;
constexpr float kMinD = 1e-3f;     // shadow-ray endpoint clearance
constexpr int kSphCols = 16, kTriCols = 24, kUvCols = 8, kClCols = 8, kLightCols = 12;
// the super walk: 16 clusters a super, cluster and super rows of 16 columns
constexpr int kSuper = 16, kSclCols = 16, kSupCols = 16;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// NaN-propagating max/min (jnp.maximum / jnp.minimum semantics)
__device__ __forceinline__ float jmax(float a, float b) { return a > b ? a : (a == a ? b : a); }
__device__ __forceinline__ float jmin(float a, float b) { return a < b ? a : (a == a ? b : a); }

__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ V3 normalize3(V3 a) { return scale(a, 1.0f / jmax(norm3(a), 1e-20f)); }

__device__ __forceinline__ bool valid3(V3 c) {
  bool bad = isnan(c.x) || isnan(c.y) || isnan(c.z) || isinf(c.x) || isinf(c.y) ||
             isinf(c.z) || c.x < 0.0f || c.y < 0.0f || c.z < 0.0f;
  return !bad;
}

__device__ __forceinline__ V3 clamp3(V3 c, float mx) {
  float m = jmax(c.x, jmax(c.y, c.z));
  return scale(c, m > mx ? mx / m : 1.0f);
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

struct Mtl {
  V3 bc;
  float rough, metal, eta;
};

struct Tables {
  const float* __restrict__ sph;
  int ns, nl;
  const float* __restrict__ tri;
  const float* __restrict__ uv;
  const float* __restrict__ cl;
  int nc;
  const float* __restrict__ sup;
  int nsup;  // super rows the walk visits; 0: the flat walk over 8-column cl rows
  const float* __restrict__ scl;
  int nsc;  // the sphere index's cluster rows; 0: no index
  const float* __restrict__ ssup;
  int nssup;  // its super rows the walk visits; 0: its flat walk
};

// ---------------------------------------------------------------------------
// work counters of the counting builds (the *_counts entries).  The BDPT
// kernels' counters (ops/cuda_connect.py::COUNT_NAMES names them in this
// order); the PT megakernel's (ops/cuda_wavefront.py::COUNT_NAMES) keep
// the walk and BSDF counters at the same indices and add their own after
// them; the PPM gather's are its own (ppm_kernels.cu).
// ---------------------------------------------------------------------------

enum CountIdx {
  kSamples, kVertices, kRows, kRowsGated, kEvals, kPdfs, kShadowRays, kContribs,
  kHitSph, kHitBox, kHitTri, kShSph, kShBox, kShTri,
  kRowLanes, kRowSlots, kShLanes, kShSlots, kTriLanes, kTriSlots, kSweepLanes, kSweepSlots,
  kNumCounts
};

// The plain builds count nothing: every call inlines away.
struct NoCount {
  __device__ __forceinline__ void add(int, unsigned = 1u) {}
  __device__ __forceinline__ void simt(int, unsigned = 1u) {}
};

// Per-thread integer tallies, summed over the warp and added with one
// atomicAdd a counter a warp; nothing here touches radiance.
template <int N>
struct CountN {
  unsigned v[N];
  __device__ __forceinline__ CountN() {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = 0u;
  }
  __device__ __forceinline__ void add(int k, unsigned n = 1u) { v[k] += n; }
  // the lanes that run this step together, and 32 slots, each times n
  // steps, counted once by the lowest active lane (SIMT efficiency = lanes
  // / slots)
  __device__ __forceinline__ void simt(int k, unsigned n = 1u) {
    unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
      v[k] += __popc(m) * n;
      v[k + 1] += 32u * n;
    }
  }
  // every lane of the warp must call this
  __device__ __forceinline__ void flush(unsigned long long* out) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      unsigned long long s = v[k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if ((threadIdx.x & 31) == 0 && s) atomicAdd(out + k, s);
    }
  }
};

using Count = CountN<kNumCounts>;

// ---------------------------------------------------------------------------
// Threefry-2x32 (20 rounds), bit-exact with jax.random and ops/rng.py on
// native uint32 words
// ---------------------------------------------------------------------------

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void threefry2x32(Key k, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.fold_in: threefry2x32(key, (0, d))
__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k, x0, x1);
  return {x0, x1};
}

// Element [j, start + lane] of a global (n, total) uniform draw: counter
// j*total + start + lane (high word 0), o0 ^ o1, the top 23 bits as the
// mantissa of a float in [1, 2), minus 1, then 1 - u: a float in (0, 1].
// The counter holds in 32 bits while n*total < 2^32 (the wrappers check).
__device__ __forceinline__ float uniform_at(Key k, int j, uint32_t lane, uint32_t start,
                                            uint32_t total) {
  uint32_t x0 = 0u, x1 = (uint32_t)j * total + start + lane;
  threefry2x32(k, x0, x1);
  float u = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
  return 1.0f - u;
}

// ---------------------------------------------------------------------------
// primitive tests
// ---------------------------------------------------------------------------

// Ray-sphere distance: near root, else far root, each > kEps (and < tmax).
__device__ __forceinline__ float sphere_t(V3 ro, V3 rd, const float* __restrict__ s, float tmax,
                                          V3* oc_out) {
  float r = s[3];
  V3 oc = ro - mk(s[0], s[1], s[2]);
  float b = oc.x * rd.x + oc.y * rd.y + oc.z * rd.z;
  float c = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z - r * r;
  float h = b * b - c;
  float sh = sqrtf(jmax(h, 0.0f));
  float t1 = -b - sh;
  float t2 = -b + sh;
  bool ok = (h >= 0.0f) && (r > 0.0f);
  bool v1 = ok && (t1 > kEps) && (t1 < tmax);
  bool v2 = ok && (t2 > kEps) && (t2 < tmax);
  *oc_out = oc;
  return v1 ? t1 : (v2 ? t2 : kInf);
}

// Moller-Trumbore against one triangle row; returns t, or kInf on a miss,
// and the barycentrics u, v (weights of v1 and v2).
__device__ __forceinline__ float triangle_t(V3 ro, V3 rd, const float* __restrict__ T, float* u_out,
                                            float* v_out) {
  V3 v0 = mk(T[0], T[1], T[2]);
  V3 e1 = mk(T[3] - v0.x, T[4] - v0.y, T[5] - v0.z);
  V3 e2 = mk(T[6] - v0.x, T[7] - v0.y, T[8] - v0.z);
  V3 h = cross3(rd, e2);
  float a = dot3(e1, h);
  bool parallel = (a > -1e-6f) && (a < 1e-6f);
  float f = 1.0f / (parallel ? 1.0f : a);
  V3 s = ro - v0;
  float u = f * dot3(s, h);
  V3 q = cross3(s, e1);
  float v = f * dot3(rd, q);
  float t = f * dot3(e2, q);
  bool ok = !parallel && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
            (t > kEps);
  *u_out = u;
  *v_out = v;
  return ok ? t : kInf;
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d);
}

// NaN-propagating min and max in one instruction each (sm_80 on): equal
// in value to jmin and jmax, a zero's sign aside, which no comparison sees
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Slab test of one box row [min3 max3 ...] (16-byte aligned in global
// memory: cluster, super and block rows): the ray enters it past tlo and
// before tlimit.  The box is read as two float4 and each NaN-propagating
// min/max is one instruction; the products and the verdict are those of
// the six-load, select-based form it replaced (measured 19% faster in #6 on
// an H100, PERF.md section 6).
__device__ __forceinline__ bool slab_hit(const float* __restrict__ B, V3 ro, V3 inv, float tlo,
                                         float tlimit) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(B));
  const float4 b = __ldg(reinterpret_cast<const float4*>(B) + 1);
  const float t0x = (a.x - ro.x) * inv.x, t1x = (a.w - ro.x) * inv.x;
  const float t0y = (a.y - ro.y) * inv.y, t1y = (b.x - ro.y) * inv.y;
  const float t0z = (a.z - ro.z) * inv.z, t1z = (b.y - ro.z) * inv.z;
  const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                           max_nan(min_nan(t0z, t1z), tlo));
  const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  return (tn <= tf) && (tn < tlimit);
}

// How much the sphere index's boxes grow for a ray (sphere_pad): pad,
// and for a wide ray (pad above the index's least radius) k, the factor
// of a box's own bound, k times the distance to its farthest corner (0:
// the ray takes pad alone).
struct SpherePad {
  float pad, k;
};

// slab_hit on the box grown by the ray's pad on every side, for a wide ray
// by no more than the box's own bound.
__device__ __forceinline__ bool slab_hit_pad(const float* __restrict__ B, V3 ro, V3 inv,
                                             SpherePad p, float tlo, float tlimit) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(B));
  const float4 b = __ldg(reinterpret_cast<const float4*>(B) + 1);
  float pad = p.pad;
  if (p.k > 0.0f) {
    const float qx = jmax(fabsf(ro.x - a.x), fabsf(ro.x - a.w));
    const float qy = jmax(fabsf(ro.y - a.y), fabsf(ro.y - b.x));
    const float qz = jmax(fabsf(ro.z - a.z), fabsf(ro.z - b.y));
    pad = jmin(pad, p.k * sqrtf(qx * qx + qy * qy + qz * qz));
  }
  const float t0x = ((a.x - pad) - ro.x) * inv.x, t1x = ((a.w + pad) - ro.x) * inv.x;
  const float t0y = ((a.y - pad) - ro.y) * inv.y, t1y = ((b.x + pad) - ro.y) * inv.y;
  const float t0z = ((a.z - pad) - ro.z) * inv.z, t1z = ((b.y + pad) - ro.z) * inv.z;
  const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
                           max_nan(min_nan(t0z, t1z), tlo));
  const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  return (tn <= tf) && (tn < tlimit);
}

// The pad of a ray's walk through the sphere index.  sphere_t forms h =
// b^2 - c with c = |oc|^2 - r^2, which cancels, and takes rd as unit, so
// it reports hits off the sphere: the point at the t it returns lies
// within sqrt(r^2 + E) of the centre, E = 16 eps |oc|^2 + |1 - |rd|^2| t^2
// at most (eps = 2^-24; a direction's length is off 1 where the
// reference's unnormalised sphere normals pass that on to the rays they
// reflect).  The near root's t is at most |rd| |oc|; the far root, taken
// only from on or inside the sphere, at most 3 |rd| r, and there the
// farthest corner is at least sqrt(3) r away.  So with q2 the squared
// distance to the index's farthest corner from the ray's origin, E <=
// (16 eps + 3 eta (1 + eta)) q2, eta = |1 - |rd|^2|; the pad takes 32 eps
// and 4 eta (1 + eta), sqrt(r^2 + E) - r <= min(sqrt(E), E / 2r) with r
// the index's least radius, plus 32 eps sqrt(q2) for the slab test's own
// rounding.  A box grown by it holds every such hit, so culling never
// drops a hit the linear loop finds.  The same bound from a box's own
// farthest corner holds for the spheres inside it, so a wide ray (one
// whose direction is off unit length, with a pad wider than the least
// sphere) grows each box by no more than k = sqrt(32 eps + 4 eta (1 +
// eta)) + 32 eps times that corner's distance: its near boxes little.  M:
// the index's bounds row.  ops/cuda_intersect.py::sphere_pad computes the
// same, in the same order.
constexpr float kPadEps = 1.9073486328125e-6f;  // 2^-19: 32 eps

__device__ __forceinline__ SpherePad sphere_pad(const float* __restrict__ M, V3 ro, V3 rd) {
  const float qx = jmax(fabsf(ro.x - M[0]), fabsf(ro.x - M[3]));
  const float qy = jmax(fabsf(ro.y - M[1]), fabsf(ro.y - M[4]));
  const float qz = jmax(fabsf(ro.z - M[2]), fabsf(ro.z - M[5]));
  const float q2 = qx * qx + qy * qy + qz * qz;
  const float eta = fabsf(rd.x * rd.x + rd.y * rd.y + rd.z * rd.z - 1.0f);
  const float coef = kPadEps + 4.0f * eta * (1.0f + eta);
  const float e = coef * q2;
  const float pad = jmin(sqrtf(e), e / (2.0f * M[6])) + kPadEps * sqrtf(q2);
  return {pad, pad > M[6] ? sqrtf(coef) + kPadEps : 0.0f};
}

__device__ __forceinline__ int octant(V3 rd) {
  return (rd.x >= 0.0f ? 1 : 0) + (rd.y >= 0.0f ? 2 : 0) + (rd.z >= 0.0f ? 4 : 0);
}

// Which cluster walk a kernel instance takes: chosen at run time by nsup,
// or fixed.  #4, #5 and #10 launch an instance per walk (the flat one
// below SUPER_MIN_CLUSTERS), since the branch cost #5 and #10 registers
// and time on cornell.  Only kWalkIndexed (the triangle walk chosen at run
// time) walks a sphere index, where nsc > 0: #1-#5, #9, #10 and ppm_eye
// launch it for scenes that have one, so the other instances keep the
// spheres' loop alone (the index's code cost #5 11% on cornell, unused).
// An instance without the index tests every sphere in turn, which finds
// the same hits.
enum WalkKind { kWalkAny, kWalkFlat, kWalkSuper, kWalkIndexed };

template <int kW>
__device__ __forceinline__ bool flat_walk(const Tables& tb) {
  return kW == kWalkFlat || (kW != kWalkSuper && tb.nsup == 0);
}

template <int kW>
__device__ __forceinline__ bool sphere_indexed(const Tables& tb) {
  return kW == kWalkIndexed && tb.nsc > 0;
}

// The cluster walk of the resident kernels, as the JAX package's kernels
// walk super_table: below SUPER_MIN_CLUSTERS (nsup 0) every cluster row
// in table order; else the supers in octant oct's front-to-back order, and
// of each super whose box the visitor enters, its 16 children in their
// order (cluster columns 8-15).  The visitor: enters_super(box) tests a
// super box against its running limit, cluster(c) visits cluster row c
// (its box test included), done() ends the walk (a blocked shadow ray).
template <bool kFlat, class Visit>
__device__ __forceinline__ void cluster_walk(const float* __restrict__ cl, int nc,
                                             const float* __restrict__ sup, int nsup, int oct,
                                             Visit& w) {
  if (kFlat) {
    for (int c = 0; c < nc && !w.done(); ++c) w.cluster(c);
    return;
  }
  for (int si = 0; si < nsup && !w.done(); ++si) {
    const int s = (int)sup[si * kSupCols + 8 + oct];
    const float* S = sup + s * kSupCols;
    if ((int)S[7] <= 0 || !w.enters_super(S)) continue;
    const int base = s * kSuper;
    for (int k = 0; k < kSuper && !w.done(); ++k)
      w.cluster(base + (int)cl[(base + k) * kSclCols + 8 + oct]);
  }
}

// ---------------------------------------------------------------------------
// nearest hit: spheres, then light balls, then cluster-culled triangles;
// strictly closer wins (the reference's tie-break)
// ---------------------------------------------------------------------------

struct HitRec {
  float t;
  V3 n;    // flipped toward the ray
  Mtl m;
  int flag;  // 0 miss, 1 surface, 2 light ball
  // kUV only: the winner's interpolated texture coordinates and texture id
  // (0, 0, -1 for spheres, light balls, misses and untextured triangles)
  float iu, iv, tex;
};

// The nearest-hit walk's visitor: a box is entered if the ray enters it
// before its running nearest t (culling never changes the result), an
// entered cluster's triangles are tested in order, strictly closer wins.
template <bool kUV, class Ctr>
struct NearestVisit {
  const Tables& tb;
  Ctr& cnt;
  V3 ro, rd, inv;
  int cl_cols;  // 8 (the flat walk) or 16 (the super walk)
  HitRec best;
  int best_tri;
  float best_u, best_v;
  __device__ __forceinline__ bool done() const { return false; }
  __device__ __forceinline__ bool enters_super(const float* S) {
    cnt.add(kHitBox);
    return slab_hit(S, ro, inv, kEps, best.t);
  }
  __device__ __forceinline__ void cluster(int c) {
    const float* C = tb.cl + c * cl_cols;
    const int count = (int)C[7];
    if (count <= 0) return;
    cnt.add(kHitBox);
    if (!slab_hit(C, ro, inv, kEps, best.t)) return;
    const int start = (int)C[6];
    cnt.add(kHitTri, (unsigned)count);
    for (int i = start; i < start + count; ++i) {
      const float* T = tb.tri + i * kTriCols;
      float u, v;
      float t = triangle_t(ro, rd, T, &u, &v);
      if (t < best.t) {
        best.t = t;
        best.n = mk(T[12], T[13], T[14]);
        best.m = {mk(T[16], T[17], T[18]), T[19], T[20], T[21]};
        best.flag = 1;
        if (kUV) {
          best_tri = i;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
};

// One sphere (or light ball) row s against the running nearest hit:
// strictly closer wins; the normal (oc + rd t) / r, the row's material, a
// light ball's flag 2.
__device__ __forceinline__ void test_sphere(const float* __restrict__ s, V3 ro, V3 rd,
                                            HitRec& best) {
  V3 oc;
  float t = sphere_t(ro, rd, s, INFINITY, &oc);
  if (t < best.t) {
    float inv_r = 1.0f / jmax(s[3], 1e-20f);
    best.t = t;
    best.n = scale(oc + scale(rd, t), inv_r);
    best.m = {mk(s[8], s[9], s[10]), s[11], s[12], s[13]};
    best.flag = s[14] > 0.0f ? 2 : 1;
  }
}

// The sphere index's visitor for the nearest hit: a box grown by the
// ray's pad is entered if the ray enters it before the running nearest t,
// an entered cluster's spheres are tested in order (test_sphere).
template <class Ctr>
struct NearestSphereVisit {
  const Tables& tb;
  Ctr& cnt;
  V3 ro, rd, inv;
  SpherePad pad;
  int cl_cols;
  HitRec& best;
  __device__ __forceinline__ bool done() const { return false; }
  __device__ __forceinline__ bool enters_super(const float* S) {
    cnt.add(kHitBox);
    return slab_hit_pad(S, ro, inv, pad, kEps, best.t);
  }
  __device__ __forceinline__ void cluster(int c) {
    const float* C = tb.scl + c * cl_cols;
    const int count = (int)C[7];
    if (count <= 0) return;
    cnt.add(kHitBox);
    if (!slab_hit_pad(C, ro, inv, pad, kEps, best.t)) return;
    const int start = (int)C[6];
    cnt.add(kHitSph, (unsigned)count);
    for (int i = start; i < start + count; ++i) test_sphere(tb.sph + i * kSphCols, ro, rd, best);
  }
};

// The sphere index's walk (flat below SUPER_MIN_CLUSTERS clusters, else
// the supers in the ray's octant order) with visitor w.
template <class Visit>
__device__ __forceinline__ void sphere_walk(const Tables& tb, V3 rd, Visit& w) {
  if (tb.nssup)
    cluster_walk<false>(tb.scl, tb.nsc, tb.ssup, tb.nssup, octant(rd), w);
  else
    cluster_walk<true>(tb.scl, tb.nsc, tb.ssup, 0, 0, w);
}

// kUV keeps the winning triangle's Moller-Trumbore barycentrics and
// interpolates its vertex UVs as ops/texture.py::interpolate_uv does:
// w0 = 1 - u - v, iu = w0*u0 + u*u1 + v*u2.  cnt counts the primitive
// tests (a super box as a box).  Spheres and light balls are tested in
// turn; with a sphere index (sphere_indexed) the light balls alone, then
// the index is walked (sphere_walk, NearestSphereVisit), all under one
// running nearest t.  The triangles are walked by cluster_walk:
// from 64 clusters on the supers in the ray's octant order, as
// nearest_hit_pallas walks them; t is the flat walk's, and only the winner
// of an exact tie may differ (the first visited wins).  kW: the walk
// (WalkKind).
template <bool kUV, int kW = kWalkAny, class Ctr>
__device__ HitRec nearest_hit_dev(const Tables& tb, V3 ro, V3 rd, Ctr& cnt) {
  const bool flat = flat_walk<kW>(tb);
  NearestVisit<kUV, Ctr> w{tb, cnt, ro, rd, mk(0.f, 0.f, 0.f), flat ? kClCols : kSclCols};
  w.best.t = kInf;
  w.best.n = mk(0.f, 0.f, 0.f);
  w.best.m = {mk(0.f, 0.f, 0.f), 0.f, 0.f, 0.f};
  w.best.flag = 0;
  w.best_tri = -1;
  w.best_u = w.best_v = 0.f;
  const bool indexed = sphere_indexed<kW>(tb);
  for (int i = indexed ? tb.ns : 0; i < tb.ns + tb.nl; ++i) {
    cnt.add(kHitSph);
    test_sphere(tb.sph + i * kSphCols, ro, rd, w.best);
  }
  // per-ray culling: a box the ray cannot enter before the current best
  // hit is skipped
  w.inv = mk(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  if (indexed) {
    const int cols = tb.nssup ? kSclCols : kClCols;
    NearestSphereVisit<Ctr> sv{tb,   cnt, ro, rd, w.inv, sphere_pad(tb.scl + tb.nsc * cols, ro, rd),
                               cols, w.best};
    sphere_walk(tb, rd, sv);
  }
  if (flat)
    cluster_walk<true>(tb.cl, tb.nc, tb.sup, tb.nsup, 0, w);
  else
    cluster_walk<false>(tb.cl, tb.nc, tb.sup, tb.nsup, octant(rd), w);
  HitRec best = w.best;
  float sgn = dot3(best.n, rd) > 0.0f ? -1.0f : 1.0f;
  best.n = scale(best.n, sgn);
  if (!(best.t < kInf)) best.flag = 0;
  best.iu = 0.0f;
  best.iv = 0.0f;
  best.tex = -1.0f;
  if (kUV && w.best_tri >= 0) {
    const float* U = tb.uv + w.best_tri * kUvCols;
    float w0 = 1.0f - w.best_u - w.best_v;
    best.iu = w0 * U[0] + w.best_u * U[2] + w.best_v * U[4];
    best.iv = w0 * U[1] + w.best_u * U[3] + w.best_v * U[5];
    best.tex = U[6];
  }
  return best;
}

template <bool kUV>
__device__ __forceinline__ HitRec nearest_hit_dev(const Tables& tb, V3 ro, V3 rd) {
  NoCount cnt;
  return nearest_hit_dev<kUV>(tb, ro, rd, cnt);
}

// The shadow walk's visitor: a box is entered if the segment enters it in
// (kMinD, md); an entered cluster's can-block triangles are tested in
// order up to the first that occludes, which ends the walk.
template <class Ctr>
struct ShadowVisit {
  const Tables& tb;
  Ctr& cnt;
  V3 p1, rd, inv;
  float md;
  int cl_cols, blocks_col;
  bool blocked;
  __device__ __forceinline__ bool done() const { return blocked; }
  __device__ __forceinline__ bool enters_super(const float* S) {
    cnt.add(kShBox);
    return slab_hit(S, p1, inv, kMinD, md);
  }
  __device__ __forceinline__ void cluster(int c) {
    const float* C = tb.cl + c * cl_cols;
    const int count = (int)C[7];
    if (count <= 0) return;
    cnt.add(kShBox);
    if (!slab_hit(C, p1, inv, kMinD, md)) return;
    const int start = (int)C[6];
    for (int i = start; i < start + count; ++i) {
      const float* T = tb.tri + i * kTriCols;
      if (!(T[blocks_col + 5] > 0.0f)) continue;
      float u, v;
      cnt.add(kShTri);
      cnt.simt(kTriLanes);
      float t = triangle_t(p1, rd, T, &u, &v);
      if (t < md && t > kMinD) {
        blocked = true;
        return;
      }
    }
  }
};

// The sphere index's visitor for a shadow ray: a box grown by the ray's
// pad is entered if the segment enters it in (kMinD, md); an entered
// cluster's can-block spheres are tested in order up to the first that
// occludes, which ends the walk.
template <class Ctr>
struct ShadowSphereVisit {
  const Tables& tb;
  Ctr& cnt;
  V3 p1, rd, inv;
  float md;
  SpherePad pad;
  int cl_cols, blocks_col;
  bool blocked;
  __device__ __forceinline__ bool done() const { return blocked; }
  __device__ __forceinline__ bool enters_super(const float* S) {
    cnt.add(kShBox);
    return slab_hit_pad(S, p1, inv, pad, kMinD, md);
  }
  __device__ __forceinline__ void cluster(int c) {
    const float* C = tb.scl + c * cl_cols;
    const int count = (int)C[7];
    if (count <= 0) return;
    cnt.add(kShBox);
    if (!slab_hit_pad(C, p1, inv, pad, kMinD, md)) return;
    const int start = (int)C[6];
    for (int i = start; i < start + count; ++i) {
      const float* s = tb.sph + i * kSphCols;
      if (!(s[blocks_col] > 0.0f)) continue;
      V3 oc;
      cnt.add(kShSph);
      const float t = sphere_t(p1, rd, s, md, &oc);
      if (t < kInf && t > kMinD) {
        blocked = true;
        return;
      }
    }
  }
};

// Shadow any-hit for t in (kMinD, md): spheres and triangles whose
// can-block column (4 GPU rule / 5 oracle rule) is set; light balls never
// block and are not visited.  The spheres in turn, or with a sphere index
// (sphere_indexed) its walk (ShadowSphereVisit).  cnt counts the primitive tests (a super
// box as a box).  From 64 clusters on the walk takes the supers in the ray's
// octant order and each entered super's children in theirs (the JAX
// package's blocker takes the children in table order: the verdict is the
// same, the tests up to the first blocker may differ).  kW: the walk.
template <int kW = kWalkAny, class Ctr>
__device__ bool shadow_blocked_dev(const Tables& tb, V3 p1, V3 rd, float md, int blocks_col,
                                   Ctr& cnt) {
  if (sphere_indexed<kW>(tb)) {
    const int cols = tb.nssup ? kSclCols : kClCols;
    ShadowSphereVisit<Ctr> sv{tb,   cnt, p1, rd, mk(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z)),
                              md,   sphere_pad(tb.scl + tb.nsc * cols, p1, rd),
                              cols, blocks_col, false};
    sphere_walk(tb, rd, sv);
    if (sv.blocked) return true;
  } else {
    for (int i = 0; i < tb.ns; ++i) {
      const float* s = tb.sph + i * kSphCols;
      if (!(s[blocks_col] > 0.0f)) continue;
      V3 oc;
      cnt.add(kShSph);
      float t = sphere_t(p1, rd, s, md, &oc);
      if (t < kInf && t > kMinD) return true;
    }
  }
  const bool flat = flat_walk<kW>(tb);
  ShadowVisit<Ctr> w{tb, cnt, p1, rd, mk(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z)), md,
                     flat ? kClCols : kSclCols, blocks_col, false};
  if (flat)
    cluster_walk<true>(tb.cl, tb.nc, tb.sup, tb.nsup, 0, w);
  else
    cluster_walk<false>(tb.cl, tb.nc, tb.sup, tb.nsup, octant(rd), w);
  return w.blocked;
}

__device__ __forceinline__ bool shadow_blocked_dev(const Tables& tb, V3 p1, V3 rd, float md,
                                                   int blocks_col) {
  NoCount cnt;
  return shadow_blocked_dev(tb, p1, rd, md, blocks_col, cnt);
}

// ---------------------------------------------------------------------------
// RGB shadow transmittance of legacy-Ks scenes (the JAX package's
// ops/intersect.py transmittance_rgb, geometric.cuh:293-325 of the
// reference): legacy rows ks (ns + nt, 4) = [ks_r ks_g ks_b refract], of
// sphere i at row i and of triangle j at row ns + j
// (ops/cuda_intersect.py::pack_scene)
// ---------------------------------------------------------------------------

// One occluder's factor, as the JAX fold 1 - occ (1 - ks) rounds it: 1 -
// (1 - Ks) per component where refract > 0, else 1 - (1 - 0) = 0.
__device__ __forceinline__ V3 legacy_factor(const float* __restrict__ ks, int row) {
  const float4 k = __ldg(reinterpret_cast<const float4*>(ks) + row);
  const bool r = k.w > 0.0f;
  return mk(1.0f - (1.0f - (r ? k.x : 0.0f)), 1.0f - (1.0f - (r ? k.y : 0.0f)),
            1.0f - (1.0f - (r ? k.z : 0.0f)));
}

// The RGB shadow walk's visitor: a box is entered if the segment enters it
// in (kMinD, md); an entered cluster's triangles are tested in order, each
// occluder's factor multiplied in; the walk ends once every component is 0.
template <class Ctr>
struct RgbShadowVisit {
  const Tables& tb;
  const float* __restrict__ ks;
  Ctr& cnt;
  V3 p1, rd, inv;
  float md;
  int cl_cols;
  V3 tr;
  __device__ __forceinline__ bool done() const {
    return tr.x == 0.0f && tr.y == 0.0f && tr.z == 0.0f;
  }
  __device__ __forceinline__ bool enters_super(const float* S) {
    cnt.add(kShBox);
    return slab_hit(S, p1, inv, kMinD, md);
  }
  __device__ __forceinline__ void cluster(int c) {
    const float* C = tb.cl + c * cl_cols;
    const int count = (int)C[7];
    if (count <= 0) return;
    cnt.add(kShBox);
    if (!slab_hit(C, p1, inv, kMinD, md)) return;
    const int start = (int)C[6];
    for (int i = start; i < start + count; ++i) {
      float u, v;
      cnt.add(kShTri);
      cnt.simt(kTriLanes);
      const float t = triangle_t(p1, rd, tb.tri + i * kTriCols, &u, &v);
      if (t < md && t > kMinD) {
        tr = mul(tr, legacy_factor(ks, tb.ns + i));
        if (done()) return;
      }
    }
  }
};

// RGB transmittance of the segment for t in (kMinD, md): every sphere and
// every triangle of the walk's entered clusters that occludes multiplies
// its factor in (no early exit at the first occluder, as the binary walk
// has); light balls never occlude and are not visited.  The walk is
// shadow_blocked_dev's (cluster_walk, the same window and box test) and
// ends once all three components are 0.  cnt counts the primitive tests
// at the shadow walk's counters.  kW: the walk.
template <int kW = kWalkAny, class Ctr>
__device__ V3 shadow_rgb_dev(const Tables& tb, const float* __restrict__ ks, V3 p1, V3 rd,
                             float md, Ctr& cnt) {
  V3 tr = mk(1.f, 1.f, 1.f);
  for (int i = 0; i < tb.ns; ++i) {
    V3 oc;
    cnt.add(kShSph);
    const float t = sphere_t(p1, rd, tb.sph + i * kSphCols, md, &oc);
    if (t < kInf && t > kMinD) tr = mul(tr, legacy_factor(ks, i));
  }
  const bool flat = flat_walk<kW>(tb);
  RgbShadowVisit<Ctr> w{tb, ks, cnt, p1, rd, mk(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z)),
                        md, flat ? kClCols : kSclCols, tr};
  if (flat)
    cluster_walk<true>(tb.cl, tb.nc, tb.sup, tb.nsup, 0, w);
  else
    cluster_walk<false>(tb.cl, tb.nc, tb.sup, tb.nsup, octant(rd), w);
  return w.tr;
}

// ---------------------------------------------------------------------------
// texture atlas: (n, th1, tw1, 3) float32, texture t in the top-left
// size[t] = (h, w) texels of its slice plus a one-texel wrapped border
// (row h = row 0, col w = col 0), as scene/parser.py builds it
// ---------------------------------------------------------------------------

struct Tex {
  const float* __restrict__ atlas;
  const int* __restrict__ size;
  int n, th1, tw1;
};

__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// Bilinear fetch with wrap addressing (ops/texture.py::sample_bilinear):
// uv wrapped to [0, 1), v flipped (image row 0 is the top), texel centers at
// half-integers; the 2x2 footprint starts at the floor-mod wrapped texel and
// is clamped into the slice as a CLIP-mode gather clamps its start.
__device__ V3 sample_bilinear_dev(const Tex& tx, int tex_id, float iu, float iv) {
  int t = min(max(tex_id, 0), tx.n - 1);
  float h = (float)tx.size[2 * t];
  float w = (float)tx.size[2 * t + 1];
  float fu = iu - floorf(iu);
  float fv = iv - floorf(iv);
  float x = fu * w - 0.5f;
  float y = (1.0f - fv) * h - 0.5f;
  float x0 = floorf(x);
  float y0 = floorf(y);
  float ax = x - x0;
  float ay = y - y0;
  int xi = floor_mod((int)x0, max((int)w, 1));
  int yi = floor_mod((int)y0, max((int)h, 1));
  xi = min(max(xi, 0), tx.tw1 - 2);
  yi = min(max(yi, 0), tx.th1 - 2);
  const float* r0 = tx.atlas + ((size_t)(t * tx.th1 + yi) * tx.tw1 + xi) * 3;
  const float* r1 = r0 + (size_t)tx.tw1 * 3;
  float bx = 1.0f - ax;
  float by = 1.0f - ay;
  V3 top = scale(mk(r0[0], r0[1], r0[2]), bx) + scale(mk(r0[3], r0[4], r0[5]), ax);
  V3 bot = scale(mk(r1[0], r1[1], r1[2]), bx) + scale(mk(r1[3], r1[4], r1[5]), ax);
  return scale(top, by) + scale(bot, ay);
}

// ---------------------------------------------------------------------------
// local frames, Fresnel, GGX
// ---------------------------------------------------------------------------

__device__ __forceinline__ void build_frame(V3 n, V3* t, V3* b) {
  V3 ax = fabsf(n.z) < 0.999f ? mk(0.f, 0.f, 1.f) : mk(0.f, 1.f, 0.f);
  *t = normalize3(cross3(ax, n));
  *b = cross3(n, *t);
}

__device__ __forceinline__ V3 to_local(V3 v, V3 t, V3 b, V3 n) {
  return mk(dot3(v, t), dot3(v, b), dot3(v, n));
}

__device__ __forceinline__ V3 to_world(V3 v, V3 t, V3 b, V3 n) {
  return mk(t.x * v.x + b.x * v.y + n.x * v.z, t.y * v.x + b.y * v.y + n.y * v.z,
            t.z * v.x + b.z * v.y + n.z * v.z);
}

__device__ __forceinline__ float fr_dielectric(float cos_i, float eta_i, float eta_t) {
  cos_i = jmin(jmax(cos_i, -1.0f), 1.0f);
  bool entering = cos_i > 0.0f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  cos_i = fabsf(cos_i);
  float sin_i = sqrtf(jmax(0.0f, 1.0f - cos_i * cos_i));
  float sin_t = ei / et * sin_i;
  bool tir = sin_t >= 1.0f;
  float cos_t = sqrtf(jmax(0.0f, 1.0f - sin_t * sin_t));
  float r_par = ((et * cos_i) - (ei * cos_t)) / ((et * cos_i) + (ei * cos_t));
  float r_per = ((ei * cos_i) - (et * cos_t)) / ((ei * cos_i) + (et * cos_t));
  return tir ? 1.0f : (r_par * r_par + r_per * r_per) / 2.0f;
}

__device__ __forceinline__ V3 fr_schlick(float cos_i, V3 r0) {
  float c = jmax(0.0f, 1.0f - cos_i);
  float c5 = c * c * c * c * c;
  return mk(r0.x + (1.0f - r0.x) * c5, r0.y + (1.0f - r0.y) * c5, r0.z + (1.0f - r0.z) * c5);
}

__device__ __forceinline__ float tan2_theta(V3 w) {
  float c2 = w.z * w.z;
  float s2 = jmax(0.0f, 1.0f - c2);
  return s2 / (c2 + 1e-7f);
}

// The reference's non-normalized GGX D: cos^4 (alpha^2 + tan^4).
__device__ __forceinline__ float tr_d(V3 wh, float alpha) {
  float t2 = tan2_theta(wh);
  float cos4 = (wh.z * wh.z) * (wh.z * wh.z);
  float e = cos4 * (alpha * alpha + t2 * t2);
  float d = (alpha * alpha) / (kPi * e);
  return (isinf(t2) || e < 1e-12f) ? 0.0f : d;
}

__device__ __forceinline__ float tr_lambda(V3 w, float alpha) {
  float c2 = w.z * w.z;
  float s2 = jmax(0.0f, 1.0f - c2);
  float abs_tan = fabsf(sqrtf(s2) / (w.z + 1e-7f));
  float a2t2 = (alpha * abs_tan) * (alpha * abs_tan);
  return isinf(abs_tan) ? 0.0f : (-1.0f + sqrtf(1.0f + a2t2)) / 2.0f;
}

__device__ __forceinline__ float roughness_to_alpha(float r) {
  float x = jmax(r, 1e-3f);
  return x * x;
}

__device__ __forceinline__ V3 half_vector(V3 wo, V3 wi, bool* ok) {
  V3 wh = wo + wi;
  float ln = norm3(wh);
  wh = scale(wh, 1.0f / jmax(ln, 1e-20f));
  if (wh.z < 0.0f) wh = -wh;
  *ok = ln >= 1e-6f;
  return wh;
}

// x / pi.  kTorchPi: as PyTorch's CUDA division of a tensor by a Python
// number rounds it, the product with the float reciprocal 1 / pi (the
// plain loops' rounding on the card, which bdpt_light matches bit for
// bit); else IEEE division, which the other kernels keep.
template <bool kTorchPi>
__device__ __forceinline__ float over_pi(float x) {
  if constexpr (kTorchPi) {
    return x * (1.0f / kPi);
  } else {
    return x / kPi;
  }
}

template <bool kTorchPi = false>
__device__ V3 eval_local(const Mtl& m, V3 wo, V3 wi, float alpha, V3 wh, bool wh_ok) {
  bool zero_cos = (wo.z == 0.0f) || (wi.z == 0.0f);
  bool smooth_diel = (m.eta > 0.0f) && (m.rough < 0.001f);
  if (zero_cos || smooth_diel || !wh_ok) return mk(0.f, 0.f, 0.f);
  bool same = wo.z * wi.z > 0.0f;
  float kd = over_pi<kTorchPi>(1.0f - m.metal);
  V3 diffuse = mk(m.bc.x * kd, m.bc.y * kd, m.bc.z * kd);
  if (wo.z * wi.z < 0.0f) diffuse = mk(0.f, 0.f, 0.f);
  if (!same) return diffuse;
  float d = tr_d(wh, alpha);
  float g = 1.0f / (1.0f + tr_lambda(wo, alpha) + tr_lambda(wi, alpha));
  V3 f;
  if (m.metal > 0.0f) {
    f = fr_schlick(fabsf(wo.z), m.bc);
  } else {
    float fr = fr_dielectric(dot3(wo, wh), 1.0f, m.eta);
    f = mk(fr, fr, fr);
  }
  float denom = jmax(4.0f * fabsf(wo.z) * fabsf(wi.z), 1e-4f);
  return diffuse + scale(f, d * g / denom);
}

template <bool kTorchPi = false>
__device__ float pdf_local(const Mtl& m, V3 wo, V3 wi, float alpha, V3 wh, bool wh_ok) {
  bool opposite = wo.z * wi.z <= 0.0f;
  bool smooth_diel = (m.eta > 0.0f) && (m.rough < 0.001f);
  if (opposite || smooth_diel || !wh_ok) return 0.0f;
  float pdf_diff = over_pi<kTorchPi>(fabsf(wi.z));
  float g1 = 1.0f / (1.0f + tr_lambda(wo, alpha));
  float dwh = dot3(wo, wh);
  float pdf_wh = tr_d(wh, alpha) * g1 * jmax(0.0f, dwh) / jmax(fabsf(wo.z), 1e-20f);
  float pdf_spec = pdf_wh / (4.0f * dwh + 1e-7f);
  float sw = m.metal > 0.0f ? 1.0f : 0.5f;
  return (1.0f - sw) * pdf_diff + sw * pdf_spec;
}

// Heitz VNDF sample; wo must be in the upper hemisphere.
__device__ V3 sample_vndf(V3 wo, float alpha, float u1, float u2) {
  V3 v = normalize3(mk(alpha * wo.x, alpha * wo.y, wo.z));
  V3 cz = cross3(mk(0.f, 0.f, 1.f), v);
  cz = scale(cz, 1.0f / jmax(norm3(cz), 1e-20f));
  V3 t1 = v.z < 0.9999f ? cz : mk(1.f, 0.f, 0.f);
  V3 t2 = cross3(v, t1);
  float r = sqrtf(u1);
  float phi = 2.0f * kPi * u2;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + v.z);
  p2 = (1.0f - s) * sqrtf(jmax(0.0f, 1.0f - p1 * p1)) + s * p2;
  V3 nh = scale(t1, p1) + scale(t2, p2) + scale(v, sqrtf(jmax(0.0f, 1.0f - p1 * p1 - p2 * p2)));
  return normalize3(mk(alpha * nh.x, alpha * nh.y, jmax(0.0f, nh.z)));
}

struct BsdfSample {
  V3 wi, val;
  float pdf;
  bool is_delta;
  float new_eta;
};

// Sample an outgoing direction: smooth dielectric, smooth conductor or the
// rough VNDF/cosine mix, picked by the material (kTorchPi: over_pi's).
template <bool kTorchPi = false>
__device__ BsdfSample bsdf_sample_dev(const Mtl& m, V3 wo_w, V3 n, float u_rr, float u1, float u2,
                                      float cur_eta) {
  V3 t, b;
  build_frame(n, &t, &b);
  V3 wo = to_local(wo_w, t, b, n);
  bool m_diel = (m.eta > 0.0f) && (m.rough < 0.001f) && (m.metal < 0.01f);
  bool m_cond = !m_diel && (m.metal > 0.99f) && (m.rough < 0.001f);
  V3 refl = mk(-wo.x, -wo.y, wo.z);
  BsdfSample out;
  out.is_delta = m_diel || m_cond;
  out.new_eta = cur_eta;
  V3 wi_l;
  if (m_diel) {
    float f = fr_dielectric(wo.z, cur_eta, m.eta);
    bool entering = wo.z > 0.0f;
    float eta_ratio = entering ? cur_eta / m.eta : m.eta / cur_eta;
    float sin2_i = jmax(0.0f, 1.0f - wo.z * wo.z);
    float sin2_t = eta_ratio * eta_ratio * sin2_i;
    bool tir = sin2_t >= 1.0f;
    float cos_t = sqrtf(jmax(0.0f, 1.0f - sin2_t));
    if (entering) cos_t = -cos_t;
    V3 refr = mk(-eta_ratio * wo.x, -eta_ratio * wo.y, cos_t);
    bool take_refl = u_rr < f;
    wi_l = take_refl ? refl : refr;
    float d_cos = jmax(fabsf(wi_l.z), 1e-20f);
    out.pdf = take_refl ? f : 1.0f - f;
    out.val = take_refl ? mk(f / d_cos, f / d_cos, f / d_cos) : scale(m.bc, (1.0f - f) / d_cos);
    if (!take_refl && tir) {  // TIR reaching the refract branch kills the lane
      out.pdf = 0.0f;
      out.val = mk(0.f, 0.f, 0.f);
    }
    out.new_eta = take_refl ? cur_eta : (entering ? m.eta : 1.0f);
  } else if (m_cond) {
    wi_l = refl;
    out.val = scale(fr_schlick(fabsf(wo.z), m.bc), 1.0f / jmax(fabsf(refl.z), 1e-20f));
    out.pdf = 1.0f;
  } else {
    float alpha = roughness_to_alpha(m.rough);
    float sw = m.metal > 0.0f ? 1.0f : 0.5f;
    bool take_spec = u_rr < sw;
    bool dead = false;
    if (take_spec) {
      V3 wo_up = wo.z > 0.0f ? wo : -wo;
      V3 wh = sample_vndf(wo_up, alpha, u1, u2);
      if (wo.z < 0.0f) wh = -wh;
      wi_l = (-wo) - scale(wh, 2.0f * dot3(wh, -wo));
      dead = wo.z * wi_l.z <= 0.0f;
    } else {
      float r = sqrtf(u1);
      float phi = 2.0f * kPi * u2;
      wi_l = mk(r * cosf(phi), r * sinf(phi), sqrtf(jmax(0.0f, 1.0f - u1)));
      if (wo.z < 0.0f) wi_l.z = -wi_l.z;
    }
    bool wh_ok;
    V3 wh_r = half_vector(wo, wi_l, &wh_ok);
    out.pdf = dead ? 0.0f : pdf_local<kTorchPi>(m, wo, wi_l, alpha, wh_r, wh_ok);
    out.val = dead ? mk(0.f, 0.f, 0.f) : eval_local<kTorchPi>(m, wo, wi_l, alpha, wh_r, wh_ok);
  }
  out.wi = to_world(wi_l, t, b, n);
  return out;
}

__device__ void eval_pdf_world(const Mtl& m, V3 wo_w, V3 wi_w, V3 n, V3* f, float* pdf) {
  V3 t, b;
  build_frame(n, &t, &b);
  V3 wo = to_local(wo_w, t, b, n);
  V3 wi = to_local(wi_w, t, b, n);
  float alpha = roughness_to_alpha(m.rough);
  bool ok;
  V3 wh = half_vector(wo, wi, &ok);
  *f = eval_local(m, wo, wi, alpha, wh, ok);
  *pdf = pdf_local(m, wo, wi, alpha, wh, ok);
}

// ---------------------------------------------------------------------------
// camera
// ---------------------------------------------------------------------------

struct Cam {
  V3 eye, ul, dx, dy;
};

// cam_tab: eye, ul, dx, dy as 12 floats
__device__ __forceinline__ Cam load_cam(const float* __restrict__ cam_tab) {
  return {load3(cam_tab, 0), load3(cam_tab, 1), load3(cam_tab, 2), load3(cam_tab, 3)};
}

// The jittered camera ray, rounded as scene/camera.py::primary_ray_dirs
// rounds it: ((ul + dx*fx) + dy*fy) - eye, divided by its length.
__device__ __forceinline__ V3 primary_dir(const Cam& cam, float fx, float fy) {
  V3 d = mk(cam.ul.x + cam.dx.x * fx + cam.dy.x * fy - cam.eye.x,
            cam.ul.y + cam.dx.y * fx + cam.dy.y * fy - cam.eye.y,
            cam.ul.z + cam.dx.z * fx + cam.dy.z * fy - cam.eye.z);
  float len = sqrtf(dot3(d, d));
  return mk(d.x / len, d.y / len, d.z / len);
}

// ---------------------------------------------------------------------------
// BDPT connection of one eye vertex against a light-vertex table
// ---------------------------------------------------------------------------

constexpr int kLvCols = 40;
constexpr float kPdfOmegaFloor = 1e-6f;

// The eye vertex's side of a connection, its frame built once.
struct EyeVertex {
  V3 pos, n, tp;
  Mtl m;
  V3 t, b, wo_e_l, wo_s_l;  // frame and local wo_e (eval) and wo_s (MIS pdf)
  float alpha, eye_f;
};

__device__ __forceinline__ EyeVertex make_eye_vertex(V3 pos, V3 n, V3 tp, const Mtl& m, V3 wo_e,
                                                     V3 wo_s, float eye_f) {
  EyeVertex e;
  e.pos = pos;
  e.n = n;
  e.tp = tp;
  e.m = m;
  build_frame(n, &e.t, &e.b);
  e.wo_e_l = to_local(wo_e, e.t, e.b, n);
  e.wo_s_l = to_local(wo_s, e.t, e.b, n);
  e.alpha = roughness_to_alpha(m.rough);
  e.eye_f = eye_f;
  return e;
}

// One pair of path_tracing_tpu/ops/pallas_connect.py::connect_core: an
// active eye vertex against one row of a row-major (V, 40) table
// (ops/cuda_connect.py::pack_light_vertices), in two halves that #8 and #9
// both call, so their sums agree.  The reference's quirks: the evals take
// the unit wi, both MIS pdfs wi * dist; pdfs floored at 1e-6; the
// spot-cone gate on emitter rows; G = cosE cosL / max(d^2, 1e-4);
// dist-scaled area conversions; mis_w = 1 / (1 + pdf_t_to_s eye_f +
// pdf_s_to_t mis_a) where finite and > 0.  A pair whose gate is closed adds
// +0 in the reference, so it stops before the work it would waste: invalid
// rows and failed geometry or cone gates before the BSDF math (row_gate),
// zero evals before the shadow ray, and the light-side eval on emitter
// rows, whose f_L is 1 (row_eval).

// The pair's geometry, as row_gate leaves it for row_eval.
struct RowGeo {
  V3 wi;
  float dist2, dist, cos_e, cos_l;
};

// The validity, geometry and spot-cone gates of the pair (eye vertex at
// pos with normal n): whether it goes on to row_eval.
__device__ __forceinline__ bool row_gate(V3 pos, V3 n, const float* __restrict__ R, RowGeo* g) {
  if (!(R[25] > 0.0f)) return false;  // invalid row
  V3 d_vec = mk(R[0], R[1], R[2]) - pos;
  g->dist2 = dot3(d_vec, d_vec);
  g->dist = sqrtf(jmax(g->dist2, 1e-20f));
  g->wi = scale(d_vec, 1.0f / g->dist);
  g->cos_e = jmax(0.0f, dot3(n, g->wi));
  g->cos_l = jmax(0.0f, dot3(-mk(R[3], R[4], R[5]), g->wi));
  if (!((g->dist2 >= 1e-6f) && (g->cos_e > 0.0f) && (g->cos_l > 0.0f))) return false;
  bool cone_bad = (R[15] > 0.0f) && (R[16] > 0.0f) && !(R[17] > 0.0f) &&
                  (dot3(mk(R[18], R[19], R[20]), -g->wi) < R[36]);
  return !cone_bad;
}

// Both BSDF evaluations and their zero gates, both MIS pdfs and the
// contribution of a pair that passed row_gate, each evaluation and pdf
// counted where it runs.  Returns whether the pair needs its shadow ray;
// then *p2 is the ray's far endpoint and, when the ray is clear, the pair
// adds *contrib (G fE fL Le MIS, clamp3-ed) if *ok (it passed valid3),
// else nothing.  kRgb (the RGB shadow of legacy-Ks scenes): *contrib is
// tp fE fL Le and *gm G MIS, which the caller multiplies by the shadow
// factor (contrib * tr * gm, the JAX package's order), then checks and
// clamps.
template <bool kRgb = false, class Ctr>
__device__ __forceinline__ bool row_eval(const EyeVertex& e, const float* __restrict__ R,
                                         const RowGeo& g, float clamp_val, Ctr& cnt, V3* contrib,
                                         bool* ok, V3* p2, float* gm = nullptr) {
  // eye side: eval with wo_e, MIS pdf with wo_s against wi * dist
  V3 wi_e_l = to_local(g.wi, e.t, e.b, e.n);
  bool wh_ok;
  V3 wh = half_vector(e.wo_e_l, wi_e_l, &wh_ok);
  cnt.add(kEvals);
  V3 f_e = eval_local(e.m, e.wo_e_l, wi_e_l, e.alpha, wh, wh_ok);
  if (!((f_e.x > 0.0f) || (f_e.y > 0.0f) || (f_e.z > 0.0f))) return false;
  cnt.add(kPdfs);
  V3 wi_s_l = scale(wi_e_l, g.dist);
  wh = half_vector(e.wo_s_l, wi_s_l, &wh_ok);
  float pdf_s = jmax(pdf_local(e.m, e.wo_s_l, wi_s_l, e.alpha, wh, wh_ok), kPdfOmegaFloor);

  // light side, in the frame packed with the table
  const V3 ln = mk(R[3], R[4], R[5]);
  Mtl m_l = {mk(R[9], R[10], R[11]), R[12], R[13], R[14]};
  V3 wo_t_l = mk(R[32], R[33], R[34]);
  float alpha_l = R[35];
  V3 wi_l_l = to_local(-g.wi, mk(R[26], R[27], R[28]), mk(R[29], R[30], R[31]), ln);
  V3 f_l = mk(1.f, 1.f, 1.f);
  if (!(R[15] > 0.0f)) {
    wh = half_vector(wo_t_l, wi_l_l, &wh_ok);
    cnt.add(kEvals);
    f_l = eval_local(m_l, wo_t_l, wi_l_l, alpha_l, wh, wh_ok);
    if (!((f_l.x > 0.0f) || (f_l.y > 0.0f) || (f_l.z > 0.0f))) return false;
  }
  V3 wi_t_l = scale(wi_l_l, g.dist);
  wh = half_vector(wo_t_l, wi_t_l, &wh_ok);
  cnt.add(kPdfs);
  float pdf_t = jmax(pdf_local(m_l, wo_t_l, wi_t_l, alpha_l, wh, wh_ok), kPdfOmegaFloor);
  *p2 = mk(R[0], R[1], R[2]) + scale(ln, kEps);

  float g_term = g.cos_e * g.cos_l / jmax(g.dist2, 1e-4f);
  float pdf_s_to_t = pdf_s * g.cos_l * g.dist / jmax(g.dist2, 1e-20f);
  float pdf_t_to_s = pdf_t * g.cos_e * g.dist / jmax(g.dist2, 1e-20f);
  float sum_ratios = 1.0f + pdf_t_to_s * e.eye_f + pdf_s_to_t * R[24];
  bool mis_ok = isfinite(sum_ratios) && (sum_ratios > 0.0f);
  float mis_w = mis_ok ? 1.0f / jmax(sum_ratios, 1e-30f) : 0.0f;
  if constexpr (kRgb) {
    *contrib = mul(mul(mul(e.tp, f_e), f_l), mk(R[6], R[7], R[8]));
    *gm = g_term * mis_w;
    return true;
  }
  // the shadow factor is 1 on every pair that adds
  V3 c = scale(mul(mul(mul(e.tp, f_e), f_l), mk(R[6], R[7], R[8])), g_term * mis_w);
  *ok = valid3(c);
  *contrib = *ok ? clamp3(c, clamp_val) : mk(0.f, 0.f, 0.f);
  return true;
}

// Both halves on one pair, counted (kRgb: row_eval's).
template <bool kRgb = false, class Ctr>
__device__ __forceinline__ bool connect_row(const EyeVertex& e, const float* __restrict__ R,
                                            float clamp_val, Ctr& cnt, V3* contrib, bool* ok,
                                            V3* p2, float* gm = nullptr) {
  cnt.add(kRows);
  RowGeo g;
  if (!row_gate(e.pos, e.n, R, &g)) return false;
  cnt.add(kRowsGated);
  cnt.simt(kRowLanes);
  if (!row_eval<kRgb>(e, R, g, clamp_val, cnt, contrib, ok, p2, gm)) return false;
  cnt.add(kShadowRays);
  return true;
}

// The shadow ray between the two offset endpoints of a connection.
__device__ __forceinline__ void shadow_setup(V3 p1, V3 p2, V3* srd, float* md) {
  V3 diff = p2 - p1;
  float sdist = norm3(diff);
  *srd = scale(diff, 1.0f / jmax(sdist, 1e-20f));
  *md = sdist - kMinD;
}

// ---------------------------------------------------------------------------
// persistent warps over the active lanes of a launch
// ---------------------------------------------------------------------------

// Lane indices [0, B) are handed out 32 at a time from a global counter
// (zeroed by the caller), one atomicAdd a span.  A warp's active lanes
// (act) wait in its queue q (64 ints: fewer than 32 left over and one
// span); fill() takes spans until 32 wait or the lanes run out, calling
// skip(i) for each inactive lane of a span; the warp then runs the first
// min(n, 32), lane k taking q[k], and pop()s them.  Every lane of the
// warp calls fill() and pop().
struct LaneQueue {
  int* q;
  int n;      // lanes waiting
  bool more;  // the counter may still hand out lanes
  template <class Skip>
  __device__ __forceinline__ void fill(int* work, int B, const bool* __restrict__ act, Skip skip) {
    const int lane = threadIdx.x & 31;
    while (more && n < 32) {
      int base = 0;
      if (lane == 0) base = atomicAdd(work, 32);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= B) {
        more = false;
        break;
      }
      more = base + 32 < B;
      const int i = base + lane;
      const bool a = i < B && act[i];
      if (i < B && !a) skip(i);
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a) q[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    __syncwarp();
  }
  __device__ __forceinline__ void pop(int nb) {
    __syncwarp();
    n -= nb;
    if ((int)(threadIdx.x & 31) < n) q[threadIdx.x & 31] = q[32 + (threadIdx.x & 31)];
    __syncwarp();
  }
};

// As many blocks of fn as the card holds at once (for dynamic_smem bytes
// a block), and no more than n_blocks.
template <class F>
inline cudaError_t persistent_blocks(F fn, int threads, size_t dynamic_smem, int n_blocks,
                                     int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, dynamic_smem);
  *blocks = n_blocks < sms * per_sm ? n_blocks : sms * per_sm;
  if (*blocks < 1) *blocks = 1;
  return err;
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// Five ints of kernel fn at its launch shape: resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block,
// registers and local (spill) bytes per thread, shared bytes per block
// (static and dynamic_smem).
inline cudaError_t occupancy_row(const void* fn, int threads, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, dynamic_smem);
  out[1] = threads;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = (int)a.sharedSizeBytes + dynamic_smem;
  return err;
}

// The scene tables as every entry of the libraries takes them, first, in
// ops/cuda_intersect.py::table_args's order: spheres (ns) then light balls
// (nl), triangles and their UVs, the triangle clusters (nc rows) and
// supers (nsup walked), the sphere index's clusters (nsc rows; 0: none)
// and supers (nssup walked).
#define PTK_TABLE_PARAMS                                                                        \
  const float *sph, int ns, int nl, const float *tri, const float *uv, const float *cl, int nc, \
      const float *sup, int nsup, const float *scl, int nsc, const float *ssup, int nssup
#define PTK_TABLE_ARGS sph, ns, nl, tri, uv, cl, nc, sup, nsup, scl, nsc, ssup, nssup

inline Tables make_tables(PTK_TABLE_PARAMS) {
  Tables tb;
  tb.sph = sph;
  tb.ns = ns;
  tb.nl = nl;
  tb.tri = tri;
  tb.uv = uv;
  tb.cl = cl;
  tb.nc = nc;
  tb.sup = sup;
  tb.nsup = nsup;
  tb.scl = scl;
  tb.nsc = nsc;
  tb.ssup = ssup;
  tb.nssup = nssup;
  return tb;
}

}  // namespace ptk
