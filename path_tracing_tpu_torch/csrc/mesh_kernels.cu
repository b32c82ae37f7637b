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
// One thread per ray.  The TPU kernel streams 8-block windows of the
// triangle table through VMEM by DMA, double-buffered across a super's
// children, and culls per 4096-ray tile in the tile's lane-0 octant order.
// Here every thread walks on its own: the spheres, then the supers in its
// own octant's front-to-back order, each entered super's children in
// their order, each entered cluster's 32-triangle blocks, and the
// Moller-Trumbore test (pallas_intersect.py _mt_from_edges) on the edges
// stored at pack time, so t equals #1's bit for bit.  Every box is culled
// against the thread's running best t (#7: the segment length, and the
// walk ends once the ray is blocked); culling never changes a result,
// and between two hits at exactly the same t the first visited wins, so
// on rare lanes the triangle (not t) differs from the TPU kernel's, whose
// visit order is its tile's.  Lanes at or past *n_live (the ray sort puts
// dead lanes last) write the miss and skip all work.
// Bound on this card: operations.  A ray tests every sphere and the 80
// super boxes of the 327,680-triangle mesh, then the clusters, blocks and
// triangles its walk enters (data-dependent), for 28-40 bytes of ray in
// and 12 (#6) or 1 (#7) out.  The rays are coherence-sorted so that
// neighbouring threads walk the same boxes and read the same rows (the
// table, 17.7 MB at that size, stays in the 50 MB L2).  Threads of a warp
// still diverge where their walks part; shared-memory staging of a warp's
// common blocks is later work.

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr int kTB = 32;      // triangles per block
constexpr int kSuper = 16;   // clusters per super
constexpr int kStriCols = 12, kSclCols = 16, kSupCols = 16, kBlkCols = 8;

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

// Moller-Trumbore on a stored row [v0 e1 e2 ...] (48 bytes, 16-aligned):
// triangle_t's arithmetic from the edges on, with t > t_lo.
__device__ __forceinline__ bool mt_edges(V3 ro, V3 rd, const float* __restrict__ T, float t_lo,
                                         float* t_out) {
  const float4* T4 = reinterpret_cast<const float4*>(T);
  const float4 a = __ldg(T4), b = __ldg(T4 + 1), c = __ldg(T4 + 2);
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

__device__ __forceinline__ int octant(V3 rd) {
  return (rd.x >= 0.0f ? 1 : 0) + (rd.y >= 0.0f ? 2 : 0) + (rd.z >= 0.0f ? 4 : 0);
}

// The blocks of cluster c the visitor enters, their triangles tested.
template <class Visit>
__device__ __forceinline__ void walk_cluster(const StreamTables& tb, int c, Visit& w) {
  const float* C = tb.cl + (size_t)c * kSclCols;
  const int count = (int)C[7];
  if (count <= 0 || !w.enters(C)) return;
  const int b0 = (int)C[6] / kTB;
  const int nblk = (count + kTB - 1) / kTB;
  for (int j = 0; j < nblk; ++j) {
    if (!w.enters(tb.blk + (size_t)(b0 + j) * kBlkCols)) continue;
    const int base = (b0 + j) * kTB;
    const int n = min(kTB, count - j * kTB);  // the block's padding never hits
    for (int k = 0; k < n; ++k) w.test(base + k, tb.tri + (size_t)(base + k) * kStriCols);
    if (w.done()) return;
  }
}

// Supers in the ray's octant order, then their children in theirs; or
// the clusters in table order below SUPER_MIN_CLUSTERS.
template <class Visit>
__device__ void stream_walk(const StreamTables& tb, int oct, Visit& w) {
  if (tb.nsup == 0) {
    for (int c = 0; c < tb.nc && !w.done(); ++c) walk_cluster(tb, c, w);
    return;
  }
  for (int si = 0; si < tb.nsup; ++si) {
    const int s = (int)tb.sup[(size_t)si * kSupCols + 8 + oct];
    const float* S = tb.sup + (size_t)s * kSupCols;
    if ((int)S[7] <= 0 || !w.enters(S)) continue;
    const int base = s * kSuper;
    for (int k = 0; k < kSuper; ++k) {
      walk_cluster(tb, base + (int)tb.cl[(size_t)(base + k) * kSclCols + 8 + oct], w);
      if (w.done()) return;
    }
  }
}

struct NearestWalk {
  V3 ro, rd, inv;
  float t;
  int idx, kind;
  __device__ bool enters(const float* B) const { return slab_hit(B, ro, inv, kEps, t); }
  __device__ bool done() const { return false; }
  __device__ void test(int i, const float* T) {
    float tt;
    if (mt_edges(ro, rd, T, kEps, &tt) && tt < t) {
      t = tt;
      idx = i;
      kind = 3;
    }
  }
};

struct BlockerWalk {
  V3 ro, rd, inv;
  float md;
  int cb_col;  // 9: every triangle blocks; 10: eta <= 0 only
  bool blocked;
  __device__ bool enters(const float* B) const {
    return !blocked && slab_hit(B, ro, inv, kMinD, md);
  }
  __device__ bool done() const { return blocked; }
  __device__ void test(int, const float* T) {
    float tt;
    if (!blocked && __ldg(T + cb_col) > 0.0f && mt_edges(ro, rd, T, kMinD, &tt) && tt < md)
      blocked = true;
  }
};

__global__ void nearest_hit_stream_kernel(StreamTables tb, const float* __restrict__ ro_in,
                                          const float* __restrict__ rd_in, int B,
                                          const int* __restrict__ n_live, float* __restrict__ t_out,
                                          int* __restrict__ idx_out, int* __restrict__ kind_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  NearestWalk w;
  w.t = kInf;
  w.idx = -1;
  w.kind = 0;
  if (i < (n_live ? *n_live : B)) {
    w.ro = load3(ro_in, i);
    w.rd = load3(rd_in, i);
    // spheres, then light balls, in table order: the reference tie-break
    for (int s = 0; s < tb.ns + tb.nl; ++s) {
      const float* S = tb.sph + s * kSphCols;
      V3 oc;
      float t = sphere_t(w.ro, w.rd, S, INFINITY, &oc);
      if (t < w.t) {
        w.t = t;
        w.idx = s;
        w.kind = S[14] > 0.0f ? 2 : 1;
      }
    }
    w.inv = mk(safe_inv(w.rd.x), safe_inv(w.rd.y), safe_inv(w.rd.z));
    stream_walk(tb, octant(w.rd), w);
  }
  t_out[i] = w.t;
  idx_out[i] = w.idx;
  kind_out[i] = w.kind;
}

__global__ void any_blocker_stream_kernel(StreamTables tb, const float* __restrict__ p1_in,
                                          const float* __restrict__ rd_in,
                                          const float* __restrict__ md_in, int B,
                                          const int* __restrict__ n_live, int blocks_col,
                                          bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bool blocked = false;
  if (i < (n_live ? *n_live : B)) {
    BlockerWalk w;
    w.ro = load3(p1_in, i);
    w.rd = load3(rd_in, i);
    w.md = md_in[i];
    w.cb_col = blocks_col + 5;
    w.blocked = false;
    // spheres with their can-block flag; light balls never block
    for (int s = 0; s < tb.ns && !w.blocked; ++s) {
      const float* S = tb.sph + s * kSphCols;
      if (!(S[blocks_col] > 0.0f)) continue;
      V3 oc;
      float t = sphere_t(w.ro, w.rd, S, w.md, &oc);
      w.blocked = (t < kInf) && (t > kMinD);
    }
    if (!w.blocked) {
      w.inv = mk(safe_inv(w.rd.x), safe_inv(w.rd.y), safe_inv(w.rd.z));
      stream_walk(tb, octant(w.rd), w);
    }
    blocked = w.blocked;
  }
  out[i] = blocked;
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
  nearest_hit_stream_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), ro, rd, B, n_live, t, idx,
      kind);
  return (int)cudaGetLastError();
}

int pt_any_blocker_stream(const float* sph, int ns, int nl, const float* tri, const float* cl,
                          int nc, const float* sup, int nsup, const float* blk, const float* p1,
                          const float* rd, const float* max_d, int B, const int* n_live,
                          int blocks_col, bool* out, void* stream) {
  any_blocker_stream_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      make_stream_tables(sph, ns, nl, tri, cl, nc, sup, nsup, blk), p1, rd, max_d, B, n_live,
      blocks_col, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
