// Hand-written CUDA kernels of BDPT (the eye pass and the light trace), for Hopper (sm_90a).
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
//              frame, every sample of a pixel in one lane.
//    bdpt_light replaces no TPU kernel: the JAX package traces the light
//              subpaths as an XLA lax.scan (path_tracing_tpu/integrators/
//              bdpt.py trace_light_paths) around nearest_hit_pallas (#1).
//              Added because in PyTorch that loop is up to 12 iterations of
//              a hundred small launches and four host reads each, which
//              kept the card idle for most of a BDPT frame's light side:
//              here the trace, its Threefry draws, the vertex rows and the
//              MIS factor are one launch.  bdpt_light_tex is its textured
//              instance.
//
// #8 has two more instances, for the routes the JAX package keeps off its
// Pallas kernels and runs through XLA (path_tracing_tpu/integrators/
// bdpt.py:503 _connect on legacy-Ks scenes, :642 _connect_sampled):
// connect_rgb, the exact sweep with the RGB shadow (each queued pair's
// tp fE fL Le times the walk's factor from pt_device.cuh::shadow_rgb_dev
// times G MIS, then checked and clamped, gated by any(factor > 0)), and
// connect_sampled, which sweeps each lane's M stratified rows vidx (B, M)
// instead of the whole table and sums them as the JAX package does: per
// chunk of mc samples (the first of 8, 4, 2, 1 that divides M), then over
// the chunks, then times n_valid / M; on legacy-Ks scenes with the RGB
// shadow too.  Both run #8's persistent warps and warp sweep, the table
// resident in shared memory when it fits (connect_sampled reads its rows
// from device memory otherwise); neither has a counting build.
//
// No float atomics: a pixel's sum is a pure function of its inputs, added
// in a fixed order (row after row, as connect_row's callers add them), so
// renders are deterministic per seed and #9 equals the per-bounce tier
// that launches #8.  Each kernel has a counting build (kCount): the same
// sums, and integer work counters (pt_device.cuh's CountIdx) summed per
// warp, with one atomicAdd a counter a warp.
//
// What bounds them on this card: operations (counted by the counting
// builds; chip_smoke.py turns the counts into a bound).  On cornell 61% of
// a connection's rows pass the geometry and cone gates and run two BSDF
// evaluations and two pdfs, 56% need a shadow ray, and a shadow ray makes
// ~31 sphere, box and triangle tests; the walks take most of the time.
//
// #8's design for this card: persistent blocks of 24 warps, one an SM,
// stage the whole table in shared memory once (the exact sweep's 813 rows
// are 130 KB; a table above the block's opt-in shared memory streams
// through per-warp chunks instead).  Each warp takes spans of 32 lanes
// from a global counter, writes 0 for the span's inactive lanes and
// queues its active ones, and sweeps 32 queued vertices at a time with
// #9's warp_sweep: a warp sweeps only active vertices (the fused tier's
// later iterations hand it 0.06-92% of the lanes) and every lane walks a
// real shadow ray.  Measured on an H100 (PERF.md section 6), every lane
// bit-equal: the fused exact frame's 48 launches 4.48 s against 10.50 s
// for one thread a lane; on the all-active 1080p primary hits 204 ms
// against 210 (their rays were already coherent).  Over the frame's
// launches: 24 warps an SM (80 registers, 58 B spilled) 11% faster than
// 16 (106 registers) and level with 32; against the resident table, rows
// read from device memory 2%, per-warp 16-row chunks 14% and block-wide
// double-buffered cp.async stages of 32 rows (16 warps an SM, 112
// registers) 17% slower (the stages were dropped).
//
// #9's design for this card: one block of 128 pixels (4 warps) reads one
// tile's table (TILE_LANES is a multiple of the block) and stages it in
// shared memory once; larger tables stream through a per-warp buffer
// kChunk rows at a time.  The scene's tables are read from device memory
// (cornell's 5 KB stay in L1; staging them bought nothing).  Each lane
// runs its own pixel's samples one after another (camera jitter, nearest
// hit, BSDF bounce, G recurrence), so a lane whose path ends starts its
// next sample at the next step instead of idling; at every step the warp sweeps its lanes'
// new eye vertices together.  In the sweep each lane gates and evaluates
// its own vertex against each row (the row a broadcast read from shared
// memory); the pairs that need a shadow ray are packed with __ballot_sync
// and a prefix count into a per-warp queue, and the warp walks them 32 at
// a time, one ray a lane, so every lane walks a real ray.  A lane then
// adds its own clear pairs of the batch in queue order, which is row
// order: the sum is one thread's row after row, add for add.  (Queuing
// the gate-passing pairs for their evaluations too raised that step's SIMT
// efficiency from 0.47 to 0.97 but made the kernel slower: PERF.md
// section 6.)
//
// bdpt_light's design for this card: one thread a light subpath, iteration
// for iteration the path's lane of the PyTorch loop (ops/cuda_bdpt_light.py
// ::light_trace_plain): nearest_hit_dev (#1's walk; the texel on a
// textured scene, as #10), the terminal light-ball vertex, the throughput
// and distance guards, bsdf_sample_dev with iteration it's draws (rows 0-2
// of fold_in(fold_in(key, 0x11F7), it) at the path's lane of a total-path
// trace), delta bounces that spend no slot, the pdf of the reverse
// direction for a stored vertex.  Its BSDF instances divide by pi as the
// loop does on the card (pt_device.cuh::over_pi<true>: PyTorch multiplies
// by the float reciprocal of a Python divisor), so the rough lobe's pdf
// and value are the loop's bit for bit; the other kernels keep IEEE
// division.  Each path owns rows [i*L, i*L + L) of
// every (P, L) field, so a stored vertex is written where it belongs (one
// writer, no atomics, no compaction); the thread then reads its own rows
// back for the loop's epilogue (validity, wo, the light-side MIS factor).
// Every row is written, so the wrapper allocates with torch.empty.  Under
// --fmad=false every value rounds as the loop's PyTorch ops round it.
// What bounds it: a frame traces a few hundred paths (4 lights x 8 x 8 on
// the main path), so the launch and its latency; the loop it replaces was
// bound by its host.

#include <type_traits>

#include "pt_device.cuh"

using namespace ptk;

namespace {

constexpr float kPdfFwdFloor = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// the connection sweep of a warp, shared by #8 and #9
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;             // rows a warp stages at a time (streamed tables)
constexpr int kQueue = 64;             // a queue holds < 32 waiting + 32 new pairs

// A warp's shadow-ray queue (structure of arrays: lane j touches word j,
// so it does not conflict on banks).
struct WarpQueue {
  float p1[3][32];      // each lane's eye vertex, offset along its normal
  float p2[3][kQueue];  // a queued pair's far endpoint
  float c[3][kQueue];   // what it adds when its ray is clear (RGB: tp fE fL Le)
  int who[kQueue];      // its vertex's lane, + 32 when it failed valid3
  unsigned mask[32];    // per lane, the entries of a batch it adds
};

// The queue of #8's RGB and sampled instances: per entry also G MIS (the
// RGB shadow's factor goes between it and c) and the sample index.
struct WarpQueueX : WarpQueue {
  float gm[kQueue];
  int sj[kQueue];
};

// A lane's connection sum: the running sum, and for the sampled sweep the
// sum of the current chunk of mc samples and its index.
struct SweepAcc {
  V3 total, part;
  int chunk;
};

__device__ __forceinline__ void copy_f4(float* __restrict__ dst, const float* __restrict__ src,
                                        int n_floats, int t, int stride) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int k = t; k < n_floats / 4; k += stride) d[k] = __ldg(s + k);
}

// The instances of #8's sweep: the binary shadow on the whole table (#8,
// #9), kRgb the RGB shadow (ks: the legacy rows), kSampled each lane's
// own M rows (vidx) summed in chunks of mc.
struct SweepRows {
  const float* __restrict__ ks;
  const int* __restrict__ vidx;  // (B, M) row indices, or null
  int M, mc;
};

// Walk the first nb queued shadow rays, one a lane, then add each lane's
// clear pairs of the batch to its sum in queue order.  kRgb: the walking
// lane turns its entry into c tr gm, checked (valid3, any(tr > 0)) and
// clamped; kSampled: a lane's entries go to its chunk sums.
template <bool kRgb = false, bool kSampled = false, int kW = kWalkAny, class Q, class Ctr>
__device__ __forceinline__ void shadow_batch(const Tables& tb, Q& q, int nb, int blocks_col,
                                             SweepAcc* acc, Ctr& cnt,
                                             const SweepRows* sr = nullptr,
                                             float clamp_val = 0.0f) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  bool add = false;
  int v = 32;
  if (lane < nb) {
    const int who = q.who[lane];
    const int u = who & 31;
    const V3 p1 = mk(q.p1[0][u], q.p1[1][u], q.p1[2][u]);
    V3 srd;
    float md;
    shadow_setup(p1, mk(q.p2[0][lane], q.p2[1][lane], q.p2[2][lane]), &srd, &md);
    cnt.simt(kShLanes);
    if constexpr (kRgb) {
      const V3 tr = shadow_rgb_dev(tb, sr->ks, p1, srd, md, cnt);
      const V3 c =
          scale(mul(mk(q.c[0][lane], q.c[1][lane], q.c[2][lane]), tr), q.gm[lane]);
      add = ((tr.x > 0.0f) || (tr.y > 0.0f) || (tr.z > 0.0f)) && valid3(c);
      const V3 cc = clamp3(c, clamp_val);
      q.c[0][lane] = cc.x;
      q.c[1][lane] = cc.y;
      q.c[2][lane] = cc.z;
    } else {
      add = !shadow_blocked_dev<kW>(tb, p1, srd, md, blocks_col, cnt) && who < 32;
    }
    if (add) v = u;
  }
  q.mask[lane] = 0u;
  __syncwarp();
  const unsigned grp = __match_any_sync(kFull, v);
  if (add && lane == __ffs(grp) - 1) q.mask[v] = grp;
  __syncwarp();
  unsigned mine = q.mask[lane];
  while (mine) {
    const int k = __ffs(mine) - 1;
    mine &= mine - 1u;
    const V3 c = mk(q.c[0][k], q.c[1][k], q.c[2][k]);
    if constexpr (kSampled) {
      const int ch = q.sj[k] / sr->mc;
      if (ch != acc->chunk) {
        acc->total = acc->total + acc->part;
        acc->part = mk(0.f, 0.f, 0.f);
        acc->chunk = ch;
      }
      acc->part = acc->part + c;
    } else {
      acc->total = acc->total + c;
    }
    cnt.add(kContribs);
  }
  __syncwarp();
}

// Queue the pairs that passed (ballot and prefix count), and walk a batch
// of 32 once 32 wait.
template <bool kRgb, bool kSampled, int kW, class Q, class Ctr>
__device__ __forceinline__ void queue_pair(const Tables& tb, Q& q, bool pass, V3 contrib, bool ok,
                                           V3 p2, float gm, int j, int& nq, int blocks_col,
                                           SweepAcc* acc, Ctr& cnt, const SweepRows* sr,
                                           float clamp_val) {
  const int lane = threadIdx.x & 31;
  const unsigned pm = __ballot_sync(kFull, pass);
  if (pass) {
    const int k = nq + __popc(pm & ((1u << lane) - 1u));
    q.p2[0][k] = p2.x;
    q.p2[1][k] = p2.y;
    q.p2[2][k] = p2.z;
    q.c[0][k] = contrib.x;
    q.c[1][k] = contrib.y;
    q.c[2][k] = contrib.z;
    q.who[k] = lane + (ok ? 0 : 32);
    if constexpr (kRgb) q.gm[k] = gm;
    if constexpr (kSampled) q.sj[k] = j;
  }
  nq += __popc(pm);
  if (nq >= 32) {
    shadow_batch<kRgb, kSampled, kW>(tb, q, 32, blocks_col, acc, cnt, sr, clamp_val);
    nq -= 32;
    if (lane < nq) {  // the rest of the queue moves to its front
      for (int d = 0; d < 3; ++d) {
        q.p2[d][lane] = q.p2[d][32 + lane];
        q.c[d][lane] = q.c[d][32 + lane];
      }
      q.who[lane] = q.who[32 + lane];
      if constexpr (kRgb) q.gm[lane] = q.gm[32 + lane];
      if constexpr (kSampled) q.sj[lane] = q.sj[32 + lane];
    }
    __syncwarp();
  }
}

// The warp's connection sweep: each lane with has_v gets the sum over rows
// [0, n_valid) of its vertex's connections (the rest get 0).  `rows` is the
// block's staged table, or with `chunk` the table to stream through that
// per-warp buffer.  Each lane gates and evaluates its own vertex against
// each row (the row a broadcast read); the pairs that need a shadow ray
// are queued with a ballot and a prefix count, row after row, and walked
// 32 at a time, one ray a lane.  kSampled: lane i sweeps its own rows
// rows + vidx[i, j] for j < M instead (a read of its own, from the staged
// table or device memory; `chunk` unused), and its sum is scaled by
// n_valid / M after the chunked sum.  Every lane of the warp calls this.
// It counts the vertices (kVertices) and the lanes that sweep one
// (kSweepLanes).
template <bool kRgb = false, bool kSampled = false, int kW = kWalkAny, class Q, class Ctr>
__device__ V3 warp_sweep(const Tables& tb, const EyeVertex& e, bool has_v,
                         const float* __restrict__ rows, float* chunk, int n_valid, Q& q,
                         float clamp_val, int blocks_col, Ctr& cnt,
                         const SweepRows* sr = nullptr, int i = 0) {
  SweepAcc acc{mk(0.f, 0.f, 0.f), mk(0.f, 0.f, 0.f), 0};
  if (!__any_sync(kFull, has_v)) return acc.total;
  const int lane = threadIdx.x & 31;
  if (has_v) {
    cnt.add(kVertices);
    cnt.simt(kSweepLanes);
    const V3 p1 = e.pos + scale(e.n, kEps);
    q.p1[0][lane] = p1.x;
    q.p1[1][lane] = p1.y;
    q.p1[2][lane] = p1.z;
  }
  int nq = 0;
  if constexpr (kSampled) {
    const int* __restrict__ vrow = sr->vidx + (size_t)i * sr->M;
    for (int j = 0; j < sr->M; ++j) {
      V3 contrib, p2;
      bool ok = false;
      float gm = 0.0f;
      const bool pass = has_v && connect_row<kRgb>(e, rows + (size_t)vrow[j] * kLvCols, clamp_val,
                                                   cnt, &contrib, &ok, &p2, &gm);
      queue_pair<kRgb, kSampled, kW>(tb, q, pass, contrib, ok, p2, gm, j, nq, blocks_col, &acc,
                                     cnt, sr, clamp_val);
    }
  } else {
    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      const int nr = chunk ? min(kChunk, n_valid - c0) : n_valid;
      const float* R0 = rows + (size_t)c0 * kLvCols;
      if (chunk) {
        __syncwarp();
        copy_f4(chunk, R0, nr * kLvCols, lane, 32);
        __syncwarp();
        R0 = chunk;
      }
      for (int r = 0; r < nr; ++r) {
        V3 contrib, p2;
        bool ok = false;
        float gm = 0.0f;
        const bool pass = has_v && connect_row<kRgb>(e, R0 + r * kLvCols, clamp_val, cnt,
                                                     &contrib, &ok, &p2, &gm);
        queue_pair<kRgb, kSampled, kW>(tb, q, pass, contrib, ok, p2, gm, r, nq, blocks_col, &acc,
                                       cnt, sr, clamp_val);
      }
      if (!chunk) break;
    }
  }
  if (nq > 0) shadow_batch<kRgb, kSampled, kW>(tb, q, nq, blocks_col, &acc, cnt, sr, clamp_val);
  if constexpr (kSampled) {
    const float nv = (float)(n_valid > 1 ? n_valid : 1);
    return scale(acc.total + acc.part, nv / (float)sr->M);
  }
  return acc.total;
}

// ---------------------------------------------------------------------------
// #8
// ---------------------------------------------------------------------------

// Where #8's block keeps the light-vertex table (connect_place picks one
// per launch): the whole table in shared memory, staged once per block, or
// per-warp kChunk-row chunks streamed through warp_sweep.
enum RowPlace { kRowsResident, kRowsChunked };

// Warps a block and __launch_bounds__ minimum blocks an SM of each
// placement (measured: PERF.md section 6).
constexpr int kResWarps = 24, kResMinBlocks = 1;
constexpr int kChunkWarps = 4, kChunkMinBlocks = 6;

__host__ __device__ constexpr int place_warps(int p) {
  return p == kRowsResident ? kResWarps : kChunkWarps;
}

__host__ __device__ constexpr int place_min_blocks(int p) {
  return p == kRowsResident ? kResMinBlocks : kChunkMinBlocks;
}

// A warp's waiting vertices: lane indices of active vertices, < 32 left
// over from a sweep and up to 32 taken from the next span.
struct VertexQueue {
  int idx[64];
};

// #8's dynamic shared memory: the table or its buffers, then each warp's
// shadow-ray and vertex queues (every part a multiple of 16 bytes).  ext:
// the RGB and sampled instances' queue (WarpQueueX); the sampled instance
// stages at least row 0 (a lane of an empty table reads it).
inline size_t connect_smem(int place, int n_valid, bool ext = false) {
  const int warps = place_warps(place);
  const int rows = place == kRowsResident ? (ext && n_valid < 1 ? 1 : n_valid) : warps * kChunk;
  return (size_t)rows * kLvCols * 4 +
         warps * ((ext ? sizeof(WarpQueueX) : sizeof(WarpQueue)) + sizeof(VertexQueue));
}

// Persistent blocks fill the card.  Each warp takes the next span of 32
// lane indices from the global counter `work` (one atomicAdd a span),
// writes 0 for the inactive lanes of the span and packs the active ones
// into its vertex queue with a ballot (LaneQueue), until 32 wait or the
// lanes run out; then it sweeps them (warp_sweep), one vertex a lane, and
// writes their sums.  Each vertex is summed by one lane in row order, so
// the output is a pure function of the inputs and equals one thread's
// sum of connect_row after connect_row.
//
// kRgb, kSampled: the RGB and sampled instances (SweepRows sr); the
// sampled instance reads each lane's rows from the staged table, or with
// kRowsChunked from device memory.
template <bool kCount, int kPlace, bool kRgb = false, bool kSampled = false>
__global__ void __launch_bounds__(32 * place_warps(kPlace), place_min_blocks(kPlace))
    connect_kernel(Tables tb, const float* __restrict__ lv, int n_valid, ConnectIn in, int B,
                   float clamp_val, int blocks_col, int* __restrict__ work,
                   float* __restrict__ out, unsigned long long* __restrict__ counts,
                   SweepRows sr) {
  constexpr int kWarps = place_warps(kPlace);
  using Q = typename std::conditional<kRgb || kSampled, WarpQueueX, WarpQueue>::type;
  extern __shared__ __align__(16) float smem[];
  typename std::conditional<kCount, Count, NoCount>::type cnt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sp = smem;
  const float* rows = lv;
  float* chunk = nullptr;
  if constexpr (kPlace == kRowsResident) {
    const int staged = kSampled && n_valid < 1 ? 1 : n_valid;
    copy_f4(sp, lv, staged * kLvCols, threadIdx.x, 32 * kWarps);
    rows = sp;
    sp += staged * kLvCols;
  } else {
    if constexpr (!kSampled) chunk = sp + warp * kChunk * kLvCols;
    sp += kWarps * kChunk * kLvCols;
  }
  Q& q = reinterpret_cast<Q*>(sp)[warp];

  LaneQueue vq{reinterpret_cast<VertexQueue*>(sp + kWarps * sizeof(Q) / 4)[warp].idx, 0, true};
  __syncthreads();
  for (;;) {
    // ---- take spans until 32 vertices wait or the lanes run out ----
    vq.fill(work, B, in.act, [&](int i) { store3(out, i, mk(0.f, 0.f, 0.f)); });
    const int nb = min(vq.n, 32);
    if (nb == 0) break;

    // ---- sweep them, one a lane ----
    const bool has_v = lane < nb;
    const int i = has_v ? vq.q[lane] : 0;
    EyeVertex e;
    if (has_v) {
      Mtl m = {load3(in.bc, i), in.rough[i], in.metal[i], in.eta[i]};
      e = make_eye_vertex(load3(in.pos, i), load3(in.n, i), load3(in.tp, i), m,
                          load3(in.wo_e, i), load3(in.wo_s, i), in.eye_f[i]);
    }
    const V3 acc = warp_sweep<kRgb, kSampled>(tb, e, has_v, rows, chunk, n_valid, q, clamp_val,
                                              blocks_col, cnt, &sr, i);
    if (has_v) store3(out, i, acc);
    vq.pop(nb);
  }
  if constexpr (kCount) cnt.flush(counts);
}

// ---------------------------------------------------------------------------
// #9
// ---------------------------------------------------------------------------

constexpr int kEyeWarps = 4;
constexpr int kEyeThreads = 32 * kEyeWarps;
constexpr int kEyeMinBlocks = 6;       // __launch_bounds__: 24 warps an SM at least
constexpr int kResidentRows = 64;      // tables up to this many rows are staged whole
constexpr int kParkFields = 24;        // a thread's parked path state, padded

struct EyeCfg {
  Key k02;                 // fold_in(key, 0x0202)
  uint32_t start, total;   // this lane is column start + i of a total-lane render
  int spp, eye_depth, max_iters;
  float clamp_val, light_hit_scale;
  int blocks_col;
  bool resident;           // the table fits kResidentRows
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

struct EyeLayout {
  bool resident;
  size_t bytes;
};

// The dynamic shared memory of an eye launch: the threads' parked path
// state, the camera, the block's table or the warps' chunk buffers, then
// the warps' queues.  Every part is a multiple of 16 bytes.
inline EyeLayout eye_layout(int n_valid) {
  EyeLayout L;
  L.resident = n_valid <= kResidentRows;
  const int table_floats = (L.resident ? n_valid : kEyeWarps * kChunk) * kLvCols;
  L.bytes = (size_t)(kParkFields * kEyeThreads + 16 + table_floats) * 4 +
            kEyeWarps * sizeof(WarpQueue);
  return L;
}

// Every sample of each lane's pixel, iteration for iteration the lane's
// column of integrators/bdpt.py::eye_sample: hit, the depth-0 light
// credit, the connection sweep (warp_sweep), the BSDF bounce and the G
// recurrence; a sample ends where that loop's lane stops changing, and the
// lane's next sample starts at the next step.  kW: kWalkIndexed for a
// scene with a sphere index, else kWalkAny (WalkKind).
template <bool kCount, int kW = kWalkAny>
__global__ void __launch_bounds__(kEyeThreads, kEyeMinBlocks)
    bdpt_eye_kernel(Tables tb, EyeTable tab, const float* __restrict__ cam_tab, EyeCfg g,
                    const int* __restrict__ px, const int* __restrict__ py, int B,
                    float* __restrict__ img_out, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  typename std::conditional<kCount, Count, NoCount>::type cnt;
  const int i = blockIdx.x * kEyeThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;

  // ---- stage this block's table ----
  float* sp = smem;
  const float* rows = tab.rows(blockIdx.x * kEyeThreads);
  float* const park = sp;
  sp += kParkFields * kEyeThreads;
  float* const cam_s = sp;  // the camera (eye, ul, dx, dy), read when needed
  if (threadIdx.x < 12) cam_s[threadIdx.x] = cam_tab[threadIdx.x];
  sp += 16;
  float* chunk = nullptr;
  if (g.resident) {
    copy_f4(sp, rows, tab.n_valid * kLvCols, threadIdx.x, kEyeThreads);
    rows = sp;
    sp += tab.n_valid * kLvCols;
  } else {
    chunk = sp + warp * kChunk * kLvCols;
    sp += kEyeWarps * kChunk * kLvCols;
  }
  WarpQueue& q = reinterpret_cast<WarpQueue*>(sp)[warp];
  __syncthreads();

  // ---- each lane's samples, one step at a time ----
  const bool in_range = i < B;
  const uint32_t lane_id = (uint32_t)i;
  int s = in_range ? 0 : g.spp;  // the lane's sample; spp when it is done
  bool fresh = true;             // sample s starts at this step
  int it = 0, dep = 0;
  Key ke = {0u, 0u};
  V3 ro, rd, last_p, prev_v, last_n;
  ro = rd = last_p = prev_v = last_n = load3(cam_s, 0);
  V3 tp = mk(1.f, 1.f, 1.f), rad = mk(0.f, 0.f, 0.f), img = mk(0.f, 0.f, 0.f);
  float eta = 1.0f, last_pdf = 1.0f, g_mis = 0.0f;
  // the path state the sweep does not read waits in this thread's column
  // of `park`, so its registers are free for the sweep
  float* const pk = park + threadIdx.x;
  auto put = [&](int f, V3 v) {
    pk[f * kEyeThreads] = v.x;
    pk[(f + 1) * kEyeThreads] = v.y;
    pk[(f + 2) * kEyeThreads] = v.z;
  };
  auto get = [&](int f) {
    return mk(pk[f * kEyeThreads], pk[(f + 1) * kEyeThreads], pk[(f + 2) * kEyeThreads]);
  };
  while (__any_sync(kFull, s < g.spp)) {
    bool has_v = false, ends = false;
    EyeVertex e;
    if (s < g.spp) {
      if (fresh) {
        cnt.add(kSamples);
        Key ks = fold_in(g.k02, (uint32_t)s);
        Key kj = fold_in(ks, 0xA11CEu);
        ke = fold_in(ks, 0xE7Eu);
        rd = primary_dir(load_cam(cam_s),
                         (float)px[i] + uniform_at(kj, 0, lane_id, g.start, g.total),
                         (float)py[i] + uniform_at(kj, 1, lane_id, g.start, g.total));
        ro = last_p = prev_v = load3(cam_s, 0);
        last_n = rd;
        tp = mk(1.f, 1.f, 1.f);
        rad = mk(0.f, 0.f, 0.f);
        eta = 1.0f;
        last_pdf = 1.0f;
        g_mis = 0.0f;
        dep = 0;
        it = 0;
        fresh = false;
      }
      if (it >= g.max_iters) {
        ends = true;
      } else {
        HitRec h = nearest_hit_dev<false, kW>(tb, ro, rd, cnt);
        if (h.flag == 0) {  // a miss ends the path
          ends = true;
        } else {
          const V3 pos = ro + scale(rd, h.t);
          if (h.flag == 2 && dep == 0) {  // the camera sees a light ball
            rad = rad + scale(h.m.bc, g.light_hit_scale);
            ends = true;
          } else {
            V3 wo_s = normalize3((dep == 0 ? load3(cam_s, 0) : prev_v) - pos);
            float eye_f =
                (dep == 0 || h.m.eta > 0.0f) ? 0.0f : (1.0f / kPdfFwdFloor) * (1.0f + g_mis);
            e = make_eye_vertex(pos, h.n, tp, h.m, -rd, wo_s, eye_f);
            has_v = true;
          }
        }
      }
    }
    put(0, rd);
    put(3, last_p);
    put(6, last_n);
    put(9, prev_v);
    put(12, rad);
    put(15, img);
    pk[18 * kEyeThreads] = eta;
    pk[19 * kEyeThreads] = last_pdf;
    pk[20 * kEyeThreads] = g_mis;
    pk[21 * kEyeThreads] = __uint_as_float(ke.k0);
    pk[22 * kEyeThreads] = __uint_as_float(ke.k1);

    // ---- connect the warp's vertices to the light vertices ----
    const V3 acc = warp_sweep<false, false, kW>(tb, e, has_v, rows, chunk, tab.n_valid, q,
                                                g.clamp_val, g.blocks_col, cnt);

    rd = get(0);
    last_p = get(3);
    last_n = get(6);
    prev_v = get(9);
    rad = get(12);
    img = get(15);
    eta = pk[18 * kEyeThreads];
    last_pdf = pk[19 * kEyeThreads];
    g_mis = pk[20 * kEyeThreads];
    ke = {__float_as_uint(pk[21 * kEyeThreads]), __float_as_uint(pk[22 * kEyeThreads])};

    // ---- bounce, from the vertex ----
    // (ro and tp are set on every path, so nothing holds them over the
    // sweep: a lane whose sample ends takes both from its next sample)
    ro = mk(0.f, 0.f, 0.f);
    tp = mk(1.f, 1.f, 1.f);
    if (has_v) {
      rad = rad + acc;
      const V3 pos = e.pos, n = e.n;
      const Mtl& m = e.m;
      const V3 wo_e = -rd;
      V3 d_vec = pos - last_p;
      float dist2 = dot3(d_vec, d_vec);
      ends = !(dist2 >= 1e-6f);
      if (!ends) {
        float cos_at_hit = fabsf(dot3(n, -rd));
        float cos_at_prev = fabsf(dot3(last_n, rd));
        float pdf_fwd = last_pdf * cos_at_hit / jmax(dist2, 1e-20f);
        Key ki = fold_in(ke, (uint32_t)it);
        BsdfSample b = bsdf_sample_dev(m, wo_e, n, uniform_at(ki, 0, lane_id, g.start, g.total),
                                       uniform_at(ki, 1, lane_id, g.start, g.total),
                                       uniform_at(ki, 2, lane_id, g.start, g.total), eta);
        ends = !((b.pdf > 0.0f) || b.is_delta);
        if (!ends) {
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
          V3 new_tp = scale(mul(e.tp, b.val), w);
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
          ++it;
          ends = !(valid3(new_tp) && (b.is_delta || dep < g.eye_depth)) || it >= g.max_iters;
        }
      }
    }
    if (ends) {
      if (valid3(rad)) img = img + rad;
      ++s;
      fresh = true;
    }
  }
  if (in_range) store3(img_out, i, img);
  if constexpr (kCount) cnt.flush(counts);
}

// The placement of #8's launch against n_valid rows: the whole table
// when it fits the block's opt-in shared memory, else per-warp chunks
// (ext: the RGB and sampled instances' layout).
inline cudaError_t connect_place(int n_valid, int* place, bool ext = false) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  *place =
      connect_smem(kRowsResident, n_valid, ext) <= (size_t)optin ? kRowsResident : kRowsChunked;
  return cudaSuccess;
}

inline const void* connect_fn(bool count, int place) {
  if (place == kRowsResident)
    return count ? (const void*)connect_kernel<true, kRowsResident>
                 : (const void*)connect_kernel<false, kRowsResident>;
  return count ? (const void*)connect_kernel<true, kRowsChunked>
               : (const void*)connect_kernel<false, kRowsChunked>;
}

// One launch of #8's instance at kPlace: as many persistent blocks as the
// card holds at once (fewer for a small B).
template <bool kCount, int kPlace, bool kRgb = false, bool kSampled = false>
cudaError_t launch_connect_at(const Tables& tb, const float* lv, int n_valid, const ConnectIn& in,
                              int B, float clamp_val, int blocks_col, int* work, float* out,
                              unsigned long long* counts, cudaStream_t stream,
                              const SweepRows& sr = SweepRows{nullptr, nullptr, 0, 1}) {
  auto* fn = connect_kernel<kCount, kPlace, kRgb, kSampled>;
  const int threads = 32 * place_warps(kPlace);
  const size_t smem = connect_smem(kPlace, n_valid, kRgb || kSampled);
  int blocks = 0;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = persistent_blocks(fn, threads, smem, (B + threads - 1) / threads, &blocks);
  if (err != cudaSuccess) return err;
  fn<<<blocks, threads, smem, stream>>>(tb, lv, n_valid, in, B, clamp_val, blocks_col, work, out,
                                        counts, sr);
  return cudaGetLastError();
}

template <bool kCount>
int launch_connect(PTK_TABLE_PARAMS, const float* lv,
                   int n_valid, const float* pos, const float* n, const float* tp,
                   const float* bc, const float* rough, const float* metal, const float* eta,
                   const float* wo_e, const float* wo_s, const float* eye_f, const bool* act,
                   int B, float clamp_val, int blocks_col, int* work, float* out,
                   unsigned long long* counts, void* stream) {
  ConnectIn in{pos, n, tp, bc, rough, metal, eta, wo_e, wo_s, eye_f, act};
  Tables tb = make_tables(PTK_TABLE_ARGS);
  int place = kRowsResident;
  cudaError_t err = connect_place(n_valid, &place);
  if (err != cudaSuccess) return (int)err;
  auto* go = place == kRowsResident ? &launch_connect_at<kCount, kRowsResident>
                                    : &launch_connect_at<kCount, kRowsChunked>;
  return (int)go(tb, lv, n_valid, in, B, clamp_val, blocks_col, work, out, counts,
                 (cudaStream_t)stream, SweepRows{nullptr, nullptr, 0, 1});
}

// #8's RGB instance (ks non-null, vidx null) or its sampled instance
// (vidx (B, M); with the RGB shadow where ks is non-null) at the
// placement that fits the table.  mc: the chunk of samples the sampled
// sum adds up first, the first of 8, 4, 2, 1 that divides M.
template <bool kRgb, bool kSampled>
int launch_connect_x(const Tables& tb, const float* ks, const float* lv, int n_valid,
                     const ConnectIn& in, const int* vidx, int M, int B, float clamp_val,
                     int blocks_col, int* work, float* out, void* stream) {
  int mc = 1;
  for (int cand = 8; cand > 1; cand /= 2)
    if (M % cand == 0) {
      mc = cand;
      break;
    }
  const SweepRows sr{ks, vidx, M, mc};
  int place = kRowsResident;
  cudaError_t err = connect_place(n_valid, &place, true);
  if (err != cudaSuccess) return (int)err;
  auto* go = place == kRowsResident ? &launch_connect_at<false, kRowsResident, kRgb, kSampled>
                                    : &launch_connect_at<false, kRowsChunked, kRgb, kSampled>;
  return (int)go(tb, lv, n_valid, in, B, clamp_val, blocks_col, work, out, nullptr,
                 (cudaStream_t)stream, sr);
}

// ---------------------------------------------------------------------------
// bdpt_light
// ---------------------------------------------------------------------------

constexpr int kLightThreads = 128;
// the loop's first last_pdf: 1 / PI in float64, rounded to float32 once
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);

struct LightCfg {
  Key k_it;               // fold_in(key, 0x11F7)
  uint32_t start, total;  // path i is row start + i of a total-path trace
  int L, iters, n_lights; // light_depth, max_light_iters, the scene's lights
};

// Each path's emission sample, and the scene's lights (path i uses light
// (start + i) % n_lights).
struct LightIn {
  const float* __restrict__ ro;       // (P, 3) emission origin
  const float* __restrict__ rd;       // (P, 3) emission direction
  const float* __restrict__ tp0;      // (P, 3) emitted throughput
  const bool* __restrict__ real;      // (P,) the path exists
  const float* __restrict__ dir;      // (n_lights, 3) light_dir
  const float* __restrict__ cutoff;   // (n_lights,) light_cutoff
  const int* __restrict__ parallel;   // (n_lights,) light_is_parallel
};

// The (P, L, ...) vertex fields; vertex (i, slot) is row i * L + slot.
struct LightOut {
  float *pos, *normal, *tp, *bc, *rough, *metal, *eta, *pdf_fwd, *pdf_rev;
  bool* is_light;
  float* cutoff;
  bool* parallel;
  float *emit_dir, *wo, *mis_a;
  bool* valid;
};

// Row r's fields but wo and mis_a, which the epilogue writes.
__device__ __forceinline__ void light_write(const LightOut& o, int r, V3 pos, V3 n, V3 tp,
                                            const Mtl& m, float pdf_fwd, float pdf_rev,
                                            bool is_light, float cutoff, bool parallel,
                                            V3 emit_dir, bool valid) {
  store3(o.pos, r, pos);
  store3(o.normal, r, n);
  store3(o.tp, r, tp);
  store3(o.bc, r, m.bc);
  o.rough[r] = m.rough;
  o.metal[r] = m.metal;
  o.eta[r] = m.eta;
  o.pdf_fwd[r] = pdf_fwd;
  o.pdf_rev[r] = pdf_rev;
  o.is_light[r] = is_light;
  o.cutoff[r] = cutoff;
  o.parallel[r] = parallel;
  store3(o.emit_dir, r, emit_dir);
  o.valid[r] = valid;
}

// Light subpath i: vertex 0 the emitter, then the bounces of the loop's
// lane i until it stops changing, then the epilogue over the path's rows
// (valid &= |throughput| >= 1e-6; wo the emission direction at slot 0,
// else toward the previous row; mis_a's recurrence).  kW: the walk (an
// instance per walk, pt_device.cuh::WalkKind); kTex: the textured instance
// (tx, the atlas).
template <int kW, bool kTex>
__global__ void __launch_bounds__(kLightThreads)
    bdpt_light_kernel(Tables tb, Tex tx, LightIn in, LightCfg g, int P, LightOut o) {
  const int i = blockIdx.x * kLightThreads + threadIdx.x;
  if (i >= P) return;
  const int L = g.L, r0 = i * L;
  const uint32_t lane = (uint32_t)i;
  const V3 z = mk(0.f, 0.f, 0.f);
  const Mtl none = {z, 0.f, 0.f, 0.f};

  // ---- vertex 0, the emitter (its normal the emission direction); the
  // other rows zero until a vertex is stored there ----
  const int li = (int)((g.start + lane) % (uint32_t)g.n_lights);
  V3 ro = load3(in.ro, i), rd = load3(in.rd, i), tp = load3(in.tp0, i);
  const bool real = in.real[i];
  light_write(o, r0, ro, rd, tp, none, 0.f, 0.f, true, in.cutoff[li], in.parallel[li] != 0,
              normalize3(load3(in.dir, li)), real);
  for (int t = 1; t < L; ++t)
    light_write(o, r0 + t, z, z, z, none, 0.f, 0.f, false, 0.f, false, z, false);

  // ---- the bounces ----
  NoCount cnt;
  float eta = 1.0f, last_pdf = kInvPi;
  V3 last_n = rd, last_p = ro;
  int slot = 1;
  bool alive = real && L > 1;
  for (int it = 0; alive && it < g.iters; ++it) {
    HitRec h = nearest_hit_dev<kTex, kW>(tb, ro, rd, cnt);
    if (kTex) {
      const int tex_id = (int)h.tex;
      if (tex_id >= 0) h.m.bc = mul(h.m.bc, sample_bilinear_dev(tx, tex_id, h.iu, h.iv));
    }
    if (h.flag == 0) break;  // a miss ends the path
    const V3 pos = ro + scale(rd, h.t);
    if (h.flag == 2) {  // a light ball: the terminal light vertex
      light_write(o, r0 + slot, pos, h.n, tp, h.m, 0.f, 0.f, true, 0.f, false, z, true);
      break;
    }
    // the throughput and distance guards come after the light-ball test
    const V3 d_vec = pos - last_p;
    const float dist2 = dot3(d_vec, d_vec);
    if (!(norm3(tp) >= 1e-4f && dist2 >= 1e-6f)) break;
    const float cos_at_hit = fabsf(dot3(h.n, -rd));
    const float cos_at_prev = fabsf(dot3(last_n, rd));
    const float pdf_fwd = last_pdf * cos_at_hit / jmax(dist2, 1e-20f);
    const V3 wo = -rd;
    const Key ki = fold_in(g.k_it, (uint32_t)it);
    const BsdfSample b =
        bsdf_sample_dev<true>(h.m, wo, h.n, uniform_at(ki, 0, lane, g.start, g.total),
                              uniform_at(ki, 1, lane, g.start, g.total),
                              uniform_at(ki, 2, lane, g.start, g.total), eta);
    if (!((b.pdf > 0.0f) || b.is_delta)) break;
    const float w = b.is_delta ? 1.0f : fabsf(dot3(h.n, b.wi)) / jmax(b.pdf, 1e-20f);
    const V3 new_tp = scale(mul(tp, b.val), w);
    if (b.is_delta) {  // spends no slot and leaves the previous vertex
      ro = pos + scale(dot3(b.wi, h.n) < 0.0f ? -h.n : h.n, kEps);
    } else {
      // pdf_rev: bsdf_pdf(m, wo = the sampled wi, wi = wo) in the hit frame
      V3 ft, fb;
      build_frame(h.n, &ft, &fb);
      const V3 wi_l = to_local(b.wi, ft, fb, h.n);
      const V3 wo_l = to_local(wo, ft, fb, h.n);
      bool wh_ok;
      const V3 wh = half_vector(wi_l, wo_l, &wh_ok);
      const float pdf_rev =
          pdf_local<true>(h.m, wi_l, wo_l, roughness_to_alpha(h.m.rough), wh, wh_ok) * cos_at_prev /
          jmax(dist2, 1e-20f);
      light_write(o, r0 + slot, pos, h.n, tp, h.m, pdf_fwd, pdf_rev, false, 0.f, false, z, true);
      ++slot;
      ro = pos + scale(h.n, kEps);
      last_n = h.n;
      last_p = pos;
      last_pdf = b.pdf;
      alive = valid3(new_tp) && slot < L;
    }
    rd = b.wi;
    tp = new_tp;
    eta = b.new_eta;
  }

  // ---- the epilogue, on the path's own rows ----
  float a = 0.0f;
  V3 prev = z;
  for (int t = 0; t < L; ++t) {
    const int r = r0 + t;
    const V3 p = load3(o.pos, r);
    o.valid[r] = o.valid[r] && norm3(load3(o.tp, r)) >= 1e-6f;
    if (t == 0) {
      store3(o.wo, r, load3(o.normal, r));
      o.mis_a[r] = 0.0f;
    } else {
      const V3 d = prev - p;
      const float len = jmax(norm3(d), 1e-20f);
      store3(o.wo, r, mk(d.x / len, d.y / len, d.z / len));
      // A: emitters 1 / pdf_fwd, dielectrics 0
      const float inv_fwd = 1.0f / jmax(o.pdf_fwd[r], kPdfFwdFloor);
      a = o.is_light[r] ? inv_fwd : (o.eta[r] > 0.0f ? 0.0f : inv_fwd * (1.0f + o.pdf_rev[r] * a));
      o.mis_a[r] = a;
    }
    prev = p;
  }
}

template <int kW, bool kTex>
int launch_light(const Tables& tb, const Tex& tx, const LightIn& in, const LightCfg& g, int P,
                 const LightOut& o, void* stream) {
  bdpt_light_kernel<kW, kTex><<<(P + kLightThreads - 1) / kLightThreads, kLightThreads, 0,
                                (cudaStream_t)stream>>>(tb, tx, in, g, P, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream and returns cudaGetLastError()
// (0 on success); the Python wrapper raises on anything else.  The scene
// tables come first (PTK_TABLE_PARAMS).

int pt_connect(PTK_TABLE_PARAMS, const float* lv, int n_valid, const float* pos,
               const float* n, const float* tp, const float* bc, const float* rough,
               const float* metal, const float* eta, const float* wo_e, const float* wo_s,
               const float* eye_f, const bool* act, int B, float clamp_val, int blocks_col,
               int* work, float* out, void* stream) {
  return launch_connect<false>(PTK_TABLE_ARGS, lv, n_valid, pos, n, tp,
                               bc, rough, metal, eta, wo_e, wo_s, eye_f, act, B, clamp_val,
                               blocks_col, work, out, nullptr, stream);
}

// The counting build of #8: the same sums, and the work counters added
// into counts[kNumCounts] (zeroed by the caller).
int pt_connect_counts(PTK_TABLE_PARAMS, const float* lv,
                      int n_valid, const float* pos, const float* n, const float* tp,
                      const float* bc, const float* rough, const float* metal, const float* eta,
                      const float* wo_e, const float* wo_s, const float* eye_f, const bool* act,
                      int B, float clamp_val, int blocks_col, int* work, float* out,
                      unsigned long long* counts, void* stream) {
  return launch_connect<true>(PTK_TABLE_ARGS, lv, n_valid, pos, n, tp,
                              bc, rough, metal, eta, wo_e, wo_s, eye_f, act, B, clamp_val,
                              blocks_col, work, out, counts, stream);
}

// #8's RGB instance: the exact sweep of pt_connect with the RGB shadow
// (ks: the legacy rows (ns + nt, 4)).
int pt_connect_rgb(PTK_TABLE_PARAMS, const float* ks,
                   const float* lv, int n_valid, const float* pos, const float* n,
                   const float* tp, const float* bc, const float* rough, const float* metal,
                   const float* eta, const float* wo_e, const float* wo_s, const float* eye_f,
                   const bool* act, int B, float clamp_val, int blocks_col, int* work, float* out,
                   void* stream) {
  ConnectIn in{pos, n, tp, bc, rough, metal, eta, wo_e, wo_s, eye_f, act};
  return launch_connect_x<true, false>(make_tables(PTK_TABLE_ARGS), ks,
                                       lv, n_valid, in, nullptr, 0, B, clamp_val, blocks_col,
                                       work, out, stream);
}

// #8's sampled instance: lane i sweeps rows vidx[i, 0..M) of the table
// (each < max(n_valid, 1)); ks non-null: with the RGB shadow.
int pt_connect_sampled(PTK_TABLE_PARAMS, const float* ks,
                       const float* lv, int n_valid, const float* pos, const float* n,
                       const float* tp, const float* bc, const float* rough, const float* metal,
                       const float* eta, const float* wo_e, const float* wo_s,
                       const float* eye_f, const bool* act, const int* vidx, int M, int B,
                       float clamp_val, int blocks_col, int* work, float* out, void* stream) {
  ConnectIn in{pos, n, tp, bc, rough, metal, eta, wo_e, wo_s, eye_f, act};
  const Tables tb = make_tables(PTK_TABLE_ARGS);
  auto* go = ks ? &launch_connect_x<true, true> : &launch_connect_x<false, true>;
  return go(tb, ks, lv, n_valid, in, vidx, M, B, clamp_val, blocks_col, work, out, stream);
}

static int launch_eye(PTK_TABLE_PARAMS, const float* lv,
                      int n_valid, int tile_lanes, long long tile_stride, const float* cam,
                      const int* px, const int* py, int B, int spp, int eye_depth, int max_iters,
                      uint32_t k0, uint32_t k1, uint32_t start, uint32_t total, float clamp_val,
                      int blocks_col, float light_hit_scale, float* img, unsigned long long* counts,
                      void* stream) {
  const EyeLayout L = eye_layout(n_valid);
  EyeTable tab{lv, n_valid, tile_lanes, tile_stride};
  EyeCfg g{{k0, k1}, start, total, spp, eye_depth, max_iters, clamp_val, light_hit_scale,
           blocks_col, L.resident};
  Tables tb = make_tables(PTK_TABLE_ARGS);
  const int blocks = (B + kEyeThreads - 1) / kEyeThreads;
  auto* fn = counts ? (nsc ? &bdpt_eye_kernel<true, kWalkIndexed> : &bdpt_eye_kernel<true>)
                    : (nsc ? &bdpt_eye_kernel<false, kWalkIndexed> : &bdpt_eye_kernel<false>);
  fn<<<blocks, kEyeThreads, L.bytes, (cudaStream_t)stream>>>(tb, tab, cam, g, px, py, B, img,
                                                             counts);
  return (int)cudaGetLastError();
}

int pt_bdpt_eye(PTK_TABLE_PARAMS, const float* lv, int n_valid,
                int tile_lanes, long long tile_stride, const float* cam, const int* px,
                const int* py, int B, int spp, int eye_depth, int max_iters, uint32_t k0,
                uint32_t k1, uint32_t start, uint32_t total, float clamp_val, int blocks_col,
                float light_hit_scale, float* img, void* stream) {
  return launch_eye(PTK_TABLE_ARGS, lv, n_valid, tile_lanes, tile_stride,
                    cam, px, py, B, spp, eye_depth, max_iters, k0, k1, start, total, clamp_val,
                    blocks_col, light_hit_scale, img, nullptr, stream);
}

// The counting build of #9: the same image, and the work counters added
// into counts[kNumCounts] (zeroed by the caller).
int pt_bdpt_eye_counts(PTK_TABLE_PARAMS, const float* lv,
                       int n_valid, int tile_lanes, long long tile_stride, const float* cam,
                       const int* px, const int* py, int B, int spp, int eye_depth, int max_iters,
                       uint32_t k0, uint32_t k1, uint32_t start, uint32_t total, float clamp_val,
                       int blocks_col, float light_hit_scale, float* img,
                       unsigned long long* counts, void* stream) {
  return launch_eye(PTK_TABLE_ARGS, lv, n_valid, tile_lanes, tile_stride,
                    cam, px, py, B, spp, eye_depth, max_iters, k0, k1, start, total, clamp_val,
                    blocks_col, light_hit_scale, img, counts, stream);
}

// occupancy_row of connect, connect_counts, bdpt_eye and bdpt_eye_counts
// in turn, for launches against n_valid table rows (connect's instance
// at the placement its launch takes).
int pt_bdpt_occupancy(int n_valid, int* out) {
  int place = kRowsResident;
  cudaError_t err = connect_place(n_valid, &place);
  if (err != cudaSuccess) return (int)err;
  const int eye_smem = (int)eye_layout(n_valid).bytes;
  const int conn_smem = (int)connect_smem(place, n_valid);
  const void* fns[4] = {connect_fn(false, place), connect_fn(true, place),
                        (const void*)bdpt_eye_kernel<false>, (const void*)bdpt_eye_kernel<true>};
  const int threads[4] = {32 * place_warps(place), 32 * place_warps(place), kEyeThreads,
                          kEyeThreads};
  const int smem[4] = {conn_smem, conn_smem, eye_smem, eye_smem};
  for (int k = 0; k < 4; ++k) {
    if (k < 2) {
      err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[k]);
      if (err != cudaSuccess) return (int)err;
    }
    err = occupancy_row(fns[k], threads[k], smem[k], out + 5 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// bdpt_light's textured instance (the atlas (n_tex, th1, tw1, 3) and its
// sizes (n_tex, 2) after the scene tables), or with a null atlas the
// untextured one: the light trace of P paths from their emission sample
// (ro, rd, tp0 (P, 3), real (P,)) and the scene's lights (light_dir
// (n_lights, 3), light_cutoff, light_is_parallel (n_lights,)), iteration
// key (k0, k1) = fold_in(key, 0x11F7), rows [start, start + P) of a
// total-path trace, L = light_depth slots a path, at most iters
// iterations; the 16 (P, L, ...) outputs in LightOut's order, every row
// written.
int pt_bdpt_light_tex(PTK_TABLE_PARAMS, const float* atlas, const int* tex_size, int n_tex,
                      int th1, int tw1, const float* ro, const float* rd, const float* tp0,
                      const bool* real, const float* ldir, const float* lcut, const int* lpar,
                      int n_lights, int P, uint32_t k0, uint32_t k1, uint32_t start,
                      uint32_t total, int L, int iters, float* pos, float* normal, float* tp,
                      float* bc, float* rough, float* metal, float* eta, float* pdf_fwd,
                      float* pdf_rev, bool* is_light, float* cutoff, bool* parallel,
                      float* emit_dir, float* wo, float* mis_a, bool* valid, void* stream) {
  const LightIn in{ro, rd, tp0, real, ldir, lcut, lpar};
  const LightCfg g{{k0, k1}, start, total, L, iters, n_lights};
  const LightOut o{pos,     normal,   tp,     bc,       rough,    metal, eta,   pdf_fwd,
                   pdf_rev, is_light, cutoff, parallel, emit_dir, wo,    mis_a, valid};
  auto* launch = atlas ? (nsc    ? &launch_light<kWalkIndexed, true>
                          : nsup ? &launch_light<kWalkSuper, true>
                                 : &launch_light<kWalkFlat, true>)
                       : (nsc    ? &launch_light<kWalkIndexed, false>
                          : nsup ? &launch_light<kWalkSuper, false>
                                 : &launch_light<kWalkFlat, false>);
  return launch(make_tables(PTK_TABLE_ARGS), Tex{atlas, tex_size, n_tex, th1, tw1}, in, g, P,
                o, stream);
}

int pt_bdpt_light(PTK_TABLE_PARAMS, const float* ro, const float* rd, const float* tp0,
                  const bool* real, const float* ldir, const float* lcut, const int* lpar,
                  int n_lights, int P, uint32_t k0, uint32_t k1, uint32_t start, uint32_t total,
                  int L, int iters, float* pos, float* normal, float* tp, float* bc, float* rough,
                  float* metal, float* eta, float* pdf_fwd, float* pdf_rev, bool* is_light,
                  float* cutoff, bool* parallel, float* emit_dir, float* wo, float* mis_a,
                  bool* valid, void* stream) {
  return pt_bdpt_light_tex(PTK_TABLE_ARGS, nullptr, nullptr, 0, 0, 0, ro, rd, tp0, real, ldir,
                           lcut, lpar, n_lights, P, k0, k1, start, total, L, iters, pos, normal,
                           tp, bc, rough, metal, eta, pdf_fwd, pdf_rev, is_light, cutoff,
                           parallel, emit_dir, wo, mis_a, valid, stream);
}

// occupancy_row of each bdpt_light instance in turn: the flat, super and
// indexed walks' untextured, then textured.
int pt_bdpt_light_occupancy(int* out) {
  const void* fns[6] = {(const void*)bdpt_light_kernel<kWalkFlat, false>,
                        (const void*)bdpt_light_kernel<kWalkSuper, false>,
                        (const void*)bdpt_light_kernel<kWalkIndexed, false>,
                        (const void*)bdpt_light_kernel<kWalkFlat, true>,
                        (const void*)bdpt_light_kernel<kWalkSuper, true>,
                        (const void*)bdpt_light_kernel<kWalkIndexed, true>};
  for (int k = 0; k < 6; ++k) {
    const cudaError_t err = occupancy_row(fns[k], kLightThreads, 0, out + 5 * k);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
