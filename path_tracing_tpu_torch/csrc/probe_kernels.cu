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
// work of the fetch.  The card gathers directly: one thread per output
// element reads its lane's index (a warp reads 32 consecutive indices) and
// loads one table element, and the warp writes 32 consecutive floats.  An
// index outside [0, D) gives 0, as the one-hot product does.
// Bound on this card: bytes.  12 * D * 4 bytes of table (read once, it
// stays in L2), rows * 128 * 4 of indices and rows * 12 * 128 * 4 of
// output: 3.9 MB at rows 128, D 66,048, about 1.2 us at 3.35 TB/s; a
// launch costs more than that.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128, kCols = 12, kThreads = 256;

__global__ void onehot_fetch_kernel(const float* __restrict__ tab, int D,
                                    const int* __restrict__ idx, int rows,
                                    float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)rows * kCols * kLanes) return;
  const int l = (int)(e % kLanes);
  const long long rj = e / kLanes;
  const int j = (int)(rj % kCols);
  const long long r = rj / kCols;
  const int k = __ldg(idx + r * kLanes + l);
  out[e] = (k >= 0 && k < D) ? __ldg(tab + (size_t)j * D + k) : 0.0f;
}

}  // namespace

extern "C" {

// Launches on the caller's stream and returns cudaGetLastError().
int pt_onehot_fetch(const float* tab, int D, const int* idx, int rows, float* out,
                    void* stream) {
  const long long n = (long long)rows * kCols * kLanes;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  if (blocks > 0)
    onehot_fetch_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(tab, D, idx, rows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
