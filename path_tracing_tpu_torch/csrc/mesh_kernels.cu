// Hand-written CUDA kernels for meshes above MAX_RESIDENT_TRIS (131,072
// triangles), for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use, beside the other libraries):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libmesh_kernels.so mesh_kernels.cu
//
//  6. nearest_hit_stream  replaces path_tracing_tpu/ops/pallas_intersect.py
//                         _nearest_hit_stream (_nearest_stream_kernel_vpu):
//                         the nearest hit as (t, padded index, kind).
//  7. any_blocker_stream  replaces pallas_intersect.py _any_blocker_stream
//                         (_blocker_stream_kernel_vpu): the shadow any-hit.
//
// Tables (row-major float32, ops/cuda_stream.py::pack_scene_stream): the
// sphere table of pt_device.cuh; tri (Tp, 12) [v0 e1 e2 blocks_gpu
// blocks_cpu 0] per padded triangle, zero rows for padding; cl (Mc, 16)
// [min3 max3 padded_start count | child order per octant]; sup (NS, 16)
// [min3 max3 0 count | super order per octant]; blk (NB, 8) [min3 max3 0 0]
// per 32-triangle block.
//
// The TPU kernels stream 8-block windows of the triangle table through
// VMEM by DMA, double-buffered across a super's children, and cull per
// 4096-ray tile in the tile's lane-0 octant order.  Here both walk the
// spheres, then the supers in the ray's own octant's front-to-back order,
// each entered super's children in their order, each entered cluster's
// 32-triangle blocks, and the Moller-Trumbore test (pallas_intersect.py
// _mt_from_edges) on the edges stored at pack time, so t equals #1's bit
// for bit.  Every box is culled against the ray's running best t (#7: the
// segment length, and the walk ends once the ray is blocked); culling
// never changes a result, and between two hits at exactly the same t the
// first visited wins, so on rare lanes the triangle (not t) differs from
// the TPU kernel's, whose visit order is its tile's.  Lanes at or past
// *n_live (the ray sort puts dead lanes last) write the miss and skip all
// work.
//
// The design for this card: the warp walks.  It ballots its live lanes'
// octants and walks once per octant present (sorted rays carry the octant
// in the key's top bits, so nearly every warp has one), the lanes of that
// octant together; a box is entered by the warp if any lane enters it, and
// each lane decides for itself, against its own running t (#7: its own
// segment, while unblocked), whether it tests the box's contents.  So each
// lane visits exactly the boxes and triangles of its own walk, in the same
// order: #6's t, idx and kind are the per-thread walk's bit for bit, ties
// included, and #7's verdicts; #7's warp leaves once every lane is
// blocked.  A block that some lane enters is staged once per warp into
// shared memory (32 rows of 48 bytes, one a lane, coalesced); its lanes
// then read the rows as broadcasts.  The slab test is pt_device.cuh's
// slab_hit (a box as two float4, one-instruction NaN-propagating min/max).
// Measured on an H100 (PERF.md section 6): #6 on the stream frame's first
// bounce, against the per-thread walk's 1.63 ms, the warp walk alone 1.66,
// without staging 1.81; float4 boxes and 12 blocks an SM 1.54; the
// one-instruction min/max 1.29; 10 blocks an SM (48 registers) 1.27; the
// per-thread walk with that box test 1.37.  #7 per thread with that box
// test and launch bounds 1.39 against the parent's 1.43 (the launch
// bounds alone: none), the warp walk 1.07-1.09; 24 live lanes 1.58 ms
// against 2.59: a lane's walk is a chain of dependent loads, and the warp
// shares each entered block's loads among its lanes.
// Bound on this card: operations.  A camera ray of the 327,680-triangle
// mesh tests all 128 super boxes (70% of the counted operations), 3.8
// cluster and 1.2 block boxes and 17.7 triangles; 28-40 bytes of ray in
// and 12 (#6) or 1 (#7) out, the table (17.7 MB) staying in the 50 MB L2.
// The counting builds (kCount) count the rays, the sphere tests, the
// super, cluster and block boxes, the triangles (#7: up to the first
// blocker), and the lanes testing a staged block's triangles against 32 a
// step (#6's SIMT: 0.26 on that frame, the lanes of a warp entering
// different blocks).

#include <type_traits>

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr int kTB = 32;  // triangles per block
constexpr int kStriCols = 12, kBlkCols = 8;

struct StreamTables {
  const float* __restrict__ sph;
  int ns, nl;
  const float* __restrict__ tri;
  const float* __restrict__ cl;
  int nc;
  const float* __restrict__ sup;
  int nsup;  // super rows the walk visits; 0: the flat cluster walk
  const float* __restrict__ blk;
};

// Moller-Trumbore on a stored row [v0 e1 e2 ...] (48 bytes, 16-aligned)
// held as three float4 a, b, c: triangle_t's arithmetic from the edges
// on, with t > t_lo.
__device__ __forceinline__ bool mt_row(V3 ro, V3 rd, float4 a, float4 b, float4 c, float t_lo,
                                       float* t_out) {
  V3 v0 = mk(a.x, a.y, a.z);
  V3 e1 = mk(a.w, b.x, b.y);
  V3 e2 = mk(b.z, b.w, c.x);
  V3 h = cross3(rd, e2);
  float det = dot3(e1, h);
  bool parallel = (det > -1e-6f) && (det < 1e-6f);
  float f = 1.0f / (parallel ? 1.0f : det);
  V3 s = ro - v0;
  float u = f * dot3(s, h);
  V3 q = cross3(s, e1);
  float v = f * dot3(rd, q);
  float t = f * dot3(e2, q);
  *t_out = t;
  return !parallel && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > t_lo);
}

// #6's and #7's counters (ops/cuda_stream.py::COUNT_NAMES): the live
// rays, the walk's tests, and the lanes entering a staged block against
// 32, each times the block's triangles (the triangle test's SIMT)
enum StreamCountIdx {
  kSRays, kSSpheres, kSSupers, kSClusters, kSBlocks, kSTris, kSTriLanes, kSTriSlots, kSCounts
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStreamMinBlocks = 10;  // #6's and #7's __launch_bounds__: 40 warps an SM

// The streamed walk taken by a whole warp for the lanes of one octant (#6
// and #7).  Every lane calls each member on the same box (the control
// flow is the warp's); `act` says whether the lane takes part (it entered
// the parent box), and each lane decides against its own ray (L::enters)
// whether it enters a box, so it visits exactly the boxes and triangles,
// in the same order, that its own walk visits.  A block that some lane
// enters is staged once into the warp's 32 rows of shared memory; its
// lanes then read the rows as broadcasts (L::test).  Where a lane's walk
// can end early (L::kStops: a blocked shadow ray), the warp leaves once
// every lane's has, a vote every lane reaches after each cluster.
template <class L>
struct WarpWalk {
  const StreamTables& tb;
  float4* stage;  // the warp's kTB rows of 3 float4
  int lane;
  L& l;

  __device__ __forceinline__ bool finished(bool act) const {
    if constexpr (L::kStops) return __all_sync(kFull, !act || l.done());
    return false;
  }

  __device__ void cluster(int c, bool act) {
    const float* C = tb.cl + (size_t)c * kSclCols;
    const int count = (int)C[7];
    if (count <= 0) return;
    const bool in_c = l.enters(act, C, kSClusters);
    if (!__any_sync(kFull, in_c)) return;
    const int b0 = (int)C[6] / kTB;
    const int nblk = (count + kTB - 1) / kTB;
    for (int j = 0; j < nblk; ++j) {
      const bool in_b = l.enters(in_c, tb.blk + (size_t)(b0 + j) * kBlkCols, kSBlocks);
      const unsigned mb = __ballot_sync(kFull, in_b);
      if (!mb) continue;
      const int base = (b0 + j) * kTB;
      const int n = min(kTB, count - j * kTB);  // the block's padding never hits
      // stage the block: lane l copies row l, 48 bytes in three 16-byte loads
      const float4* rows = reinterpret_cast<const float4*>(tb.tri + (size_t)base * kStriCols);
      if (lane < n) {
        stage[3 * lane] = __ldg(rows + 3 * lane);
        stage[3 * lane + 1] = __ldg(rows + 3 * lane + 1);
        stage[3 * lane + 2] = __ldg(rows + 3 * lane + 2);
      }
      __syncwarp();
      if (in_b) l.test(stage, base, n);
      if (lane == __ffs(mb) - 1) {
        l.cnt.add(kSTriLanes, (unsigned)(__popc(mb) * n));
        l.cnt.add(kSTriSlots, 32u * n);
      }
      __syncwarp();  // every lane is done with the rows before they refill
    }
  }

  // supers in octant oct's front-to-back order, each entered super's
  // children in theirs; or the clusters in table order below
  // SUPER_MIN_CLUSTERS
  __device__ void walk(int oct, bool act) {
    if (tb.nsup == 0) {
      for (int c = 0; c < tb.nc; ++c) {
        cluster(c, act);
        if (finished(act)) return;
      }
      return;
    }
    for (int si = 0; si < tb.nsup; ++si) {
      const int s = (int)tb.sup[(size_t)si * kSupCols + 8 + oct];
      const float* S = tb.sup + (size_t)s * kSupCols;
      if ((int)S[7] <= 0) continue;
      const bool in_s = l.enters(act, S, kSSupers);
      if (!__any_sync(kFull, in_s)) continue;
      const int base = s * kSuper;
      for (int k = 0; k < kSuper; ++k) {
        cluster(base + (int)tb.cl[(size_t)(base + k) * kSclCols + 8 + oct], in_s);
        if (finished(act)) return;
      }
    }
  }

  // the walk of every live lane: once per octant among the warp's live
  // lanes (sorted rays: mostly one); the flat walk's order is every
  // octant's
  __device__ void run(bool live, int oct) {
    if (tb.nsup == 0) {
      walk(0, live);
      return;
    }
    unsigned octs = __reduce_or_sync(kFull, live ? 1u << oct : 0u);
    while (octs) {
      const int o = __ffs(octs) - 1;
      octs &= octs - 1;
      walk(o, live && oct == o);
    }
  }
};

// #6's lane: boxes culled against its running nearest t, a staged block's
// triangles all tested, strictly closer wins.
template <class Ctr>
struct NearestLane {
  static constexpr bool kStops = false;
  Ctr& cnt;
  V3 ro, rd, inv;
  float t;
  int idx, kind;

  __device__ __forceinline__ bool done() const { return false; }
  __device__ __forceinline__ bool enters(bool act, const float* B, int counter) {
    if (!act) return false;
    cnt.add(counter);
    return slab_hit(B, ro, inv, kEps, t);
  }
  __device__ __forceinline__ void test(const float4* st, int base, int n) {
    cnt.add(kSTris, (unsigned)n);
    for (int k = 0; k < n; ++k) {
      float tt;
      if (mt_row(ro, rd, st[3 * k], st[3 * k + 1], st[3 * k + 2], kEps, &tt) && tt < t) {
        t = tt;
        idx = base + k;
        kind = 3;
      }
    }
  }
};

// #7's lane: boxes culled against its segment (kMinD, md) while it is
// unblocked, a staged block's can-block triangles tested in order until
// one occludes.
template <class Ctr>
struct BlockerLane {
  static constexpr bool kStops = true;
  Ctr& cnt;
  V3 ro, rd, inv;
  float md;
  int cb_col;  // 9: every triangle blocks; 10: eta <= 0 only
  bool blocked;

  __device__ __forceinline__ bool done() const { return blocked; }
  __device__ __forceinline__ bool enters(bool act, const float* B, int counter) {
    if (!act || blocked) return false;
    cnt.add(counter);
    return slab_hit(B, ro, inv, kMinD, md);
  }
  __device__ __forceinline__ void test(const float4* st, int, int n) {
    for (int k = 0; k < n && !blocked; ++k) {
      const float4 c = st[3 * k + 2];  // e2.z | blocks_gpu blocks_cpu 0
      if (!((cb_col == 9 ? c.y : c.z) > 0.0f)) continue;
      cnt.add(kSTris);
      float tt;
      if (mt_row(ro, rd, st[3 * k], st[3 * k + 1], c, kMinD, &tt) && tt < md) blocked = true;
    }
  }
};

template <bool kCount>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    nearest_hit_stream_kernel(StreamTables tb, const float* __restrict__ ro_in,
                              const float* __restrict__ rd_in, int B,
                              const int* __restrict__ n_live, float* __restrict__ t_out,
                              int* __restrict__ idx_out, int* __restrict__ kind_out,
                              unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) float4 stage[kThreads / 32][kTB * 3];
  typename std::conditional<kCount, CountN<kSCounts>, NoCount>::type cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B && i < (n_live ? *n_live : B);
  const V3 zero = mk(0.f, 0.f, 0.f);
  NearestLane<decltype(cnt)> l{cnt, zero, zero, zero, kInf, -1, 0};
  int oct = 0;
  if (live) {
    cnt.add(kSRays);
    l.ro = load3(ro_in, i);
    l.rd = load3(rd_in, i);
    // spheres, then light balls, in table order: the reference tie-break
    for (int s = 0; s < tb.ns + tb.nl; ++s) {
      const float* S = tb.sph + s * kSphCols;
      V3 oc;
      cnt.add(kSSpheres);
      const float t = sphere_t(l.ro, l.rd, S, INFINITY, &oc);
      if (t < l.t) {
        l.t = t;
        l.idx = s;
        l.kind = S[14] > 0.0f ? 2 : 1;
      }
    }
    l.inv = mk(safe_inv(l.rd.x), safe_inv(l.rd.y), safe_inv(l.rd.z));
    oct = octant(l.rd);
  }
  WarpWalk<decltype(l)> w{tb, stage[threadIdx.x >> 5], (int)(threadIdx.x & 31), l};
  w.run(live, oct);
  if (i < B) {
    t_out[i] = l.t;
    idx_out[i] = l.idx;
    kind_out[i] = l.kind;
  }
  if constexpr (kCount) cnt.flush(counts);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    any_blocker_stream_kernel(StreamTables tb, const float* __restrict__ p1_in,
                              const float* __restrict__ rd_in, const float* __restrict__ md_in,
                              int B, const int* __restrict__ n_live, int blocks_col,
                              bool* __restrict__ out, unsigned long long* __restrict__ counts) {
  __shared__ __align__(16) float4 stage[kThreads / 32][kTB * 3];
  typename std::conditional<kCount, CountN<kSCounts>, NoCount>::type cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B && i < (n_live ? *n_live : B);
  const V3 zero = mk(0.f, 0.f, 0.f);
  BlockerLane<decltype(cnt)> l{cnt, zero, zero, zero, 0.f, blocks_col + 5, false};
  int oct = 0;
  if (live) {
    cnt.add(kSRays);
    l.ro = load3(p1_in, i);
    l.rd = load3(rd_in, i);
    l.md = md_in[i];
    // spheres with their can-block flag; light balls never block
    for (int s = 0; s < tb.ns && !l.blocked; ++s) {
      const float* S = tb.sph + s * kSphCols;
      if (!(S[blocks_col] > 0.0f)) continue;
      cnt.add(kSSpheres);
      V3 oc;
      const float t = sphere_t(l.ro, l.rd, S, l.md, &oc);
      l.blocked = (t < kInf) && (t > kMinD);
    }
    l.inv = mk(safe_inv(l.rd.x), safe_inv(l.rd.y), safe_inv(l.rd.z));
    oct = octant(l.rd);
  }
  WarpWalk<decltype(l)> w{tb, stage[threadIdx.x >> 5], (int)(threadIdx.x & 31), l};
  w.run(live, oct);
  if (i < B) out[i] = l.blocked;
  if constexpr (kCount) cnt.flush(counts);
}

inline StreamTables make_stream_tables(const float* sph, int ns, int nl, const float* tri,
                                       const float* cl, int nc, const float* sup, int nsup,
                                       const float* blk) {
  StreamTables tb;
  tb.sph = sph;
  tb.ns = ns;
  tb.nl = nl;
  tb.tri = tri;
  tb.cl = cl;
  tb.nc = nc;
  tb.sup = sup;
  tb.nsup = nsup;
  tb.blk = blk;
  return tb;
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.  n_live may
// be null (every lane live).

int pt_nearest_hit_stream(const float* sph, int ns, int nl, const float* tri, const float* cl,
                          int nc, const float* sup, int nsup, const float* blk, const float* ro,
                          const float* rd, int B, const int* n_live, float* t, int* idx, int* kind,
                          void* stream) {
  nearest_hit_stream_kernel<false><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), ro, rd, B, n_live, t, idx,
      kind, nullptr);
  return (int)cudaGetLastError();
}

// The counting build of #6: the same (t, idx, kind), and the work counters
// added into counts[kSCounts] (zeroed by the caller).
int pt_nearest_hit_stream_counts(const float* sph, int ns, int nl, const float* tri,
                                 const float* cl, int nc, const float* sup, int nsup,
                                 const float* blk, const float* ro, const float* rd, int B,
                                 const int* n_live, float* t, int* idx, int* kind,
                                 unsigned long long* counts, void* stream) {
  nearest_hit_stream_kernel<true><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), ro, rd, B, n_live, t, idx,
      kind, counts);
  return (int)cudaGetLastError();
}

int pt_any_blocker_stream(const float* sph, int ns, int nl, const float* tri, const float* cl,
                          int nc, const float* sup, int nsup, const float* blk, const float* p1,
                          const float* rd, const float* max_d, int B, const int* n_live,
                          int blocks_col, bool* out, void* stream) {
  any_blocker_stream_kernel<false><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), p1, rd, max_d, B, n_live,
      blocks_col, out, nullptr);
  return (int)cudaGetLastError();
}

// The counting build of #7: the same verdicts, and the work counters (the
// first six of kSCounts) added into counts[kSCounts] (zeroed by the
// caller).
int pt_any_blocker_stream_counts(const float* sph, int ns, int nl, const float* tri,
                                 const float* cl, int nc, const float* sup, int nsup,
                                 const float* blk, const float* p1, const float* rd,
                                 const float* max_d, int B, const int* n_live, int blocks_col,
                                 bool* out, unsigned long long* counts, void* stream) {
  any_blocker_stream_kernel<true><<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), p1, rd, max_d, B, n_live,
      blocks_col, out, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
