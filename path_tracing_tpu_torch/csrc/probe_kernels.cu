// Hand-written CUDA kernel of the texture-fetch probe, for Hopper (sm_90a).
//
// Build (ops/_kernels.py does this at first use, beside the other libraries):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libprobe_kernels.so probe_kernels.cu
//
// 12. onehot_fetch  replaces path_tracing_tpu/ops/probes.py onehot_fetch
//                   (_onehot_fetch_kernel): out[r*12 + j, l] = tab[j, idx[r, l]]
//                   for a (12, D) table and (rows, 128) flat indices.
//
// The TPU has no per-lane gather inside a kernel, so its probe builds a
// one-hot (D, 128) matrix per row and contracts it on the MXU: D times the
// work of the fetch.  The card gathers directly.  One block per row r and
// one thread per lane l: the thread reads its index once (the warp reads
// 32 consecutive indices), issues its 12 table loads together through the
// read-only path, and makes 12 stores, each warp-coalesced (32 consecutive
// floats of out row r*12 + j).  No division: r and l are the block and the
// thread.  An index outside [0, D) gives 0, as the one-hot product does.
// Bound on this card: bytes.  12 * D * 4 bytes of table (read once, it
// stays in L2), rows * 128 * 4 of indices and rows * 12 * 128 * 4 of
// output: 3.9 MB at rows 128, D 66,048, about 1.2 us at 3.35 TB/s; a
// launch costs more than that, so the host's enqueue decides the time of
// a single call (ops/probes.py keeps it short).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128, kCols = 12;

__global__ void __launch_bounds__(kLanes) onehot_fetch_kernel(const float* __restrict__ tab, int D,
                                                              const int* __restrict__ idx,
                                                              float* __restrict__ out) {
  const int r = blockIdx.x, l = threadIdx.x;
  const int k = __ldg(idx + r * kLanes + l);
  const bool in = k >= 0 && k < D;
  float v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) v[j] = in ? __ldg(tab + (size_t)j * D + k) : 0.0f;
  float* o = out + (size_t)r * kCols * kLanes + l;
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j * kLanes] = v[j];
}

}  // namespace

extern "C" {

// Launches on the caller's stream and returns cudaGetLastError().
int pt_onehot_fetch(const float* tab, int D, const int* idx, int rows, float* out,
                    void* stream) {
  if (rows > 0)
    onehot_fetch_kernel<<<rows, kLanes, 0, (cudaStream_t)stream>>>(tab, D, idx, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
