// Weighted bag reduce for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (kernels/embedding_bag/kernel.py).
//
// The kernel launches on the caller's stream, allocates nothing, and the
// entry point returns cudaGetLastError() so a refused launch is reported
// where it happened. The Python wrapper allocates the output and checks
// device, dtype, shape and contiguity before any pointer reaches this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// bag_reduce
//
// Replaces the TPU kernel _bag_kernel, launched by bag_reduce_pallas
// (src/repro/kernels/embedding_bag/kernel.py:30 and :43):
// out[b, d] = sum over l of float(w[b, l]) * float(rows[b, l, d]), summed in
// fp32 and written in the rows' type (float or bfloat16; w has the same).
//
// Bound: bytes. Each row element is read once (B*L*D), each weight once
// (B*L) and each output written once (B*D); there are two operations per
// row element, far below the card's rate for either type. The TPU tiled
// (128, L, 128) slabs through VMEM and contracted over L on the MXU, which
// needed B and D padded to its tiles. Here a CTA of 256 threads owns a
// tile of `by` bags by `dx` columns (dx = D rounded up to a warp, at most
// 256; by = 256 / dx). One thread owns one output (b, d) and neighbouring
// threads own neighbouring d, so each step in l is one coalesced read of a
// row segment. The loop over l runs in ascending order in chunks of dx:
// the CTA stages its bags' weights for the chunk in shared memory (each
// weight read once per CTA, as fp32), then every thread walks the chunk.
// Ragged edges (b >= B, d >= D) are masked; such threads still stage
// weights and meet every barrier. Nothing is padded, L == 0 writes zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_reduce_kernel(const T* __restrict__ rows, const T* __restrict__ w,
                  int64_t B, int64_t L, int64_t D, T* __restrict__ out) {
  __shared__ float w_s[kThreads];
  const int dx = blockDim.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + ty;
  const int64_t d = (int64_t)blockIdx.y * dx + tx;
  const bool live = b < B && d < D;
  float* w_row = w_s + ty * dx;
  const T* r = rows + b * L * D + d;

  float acc = 0.f;
  for (int64_t l0 = 0; l0 < L; l0 += dx) {
    const int64_t l = l0 + tx;
    __syncthreads();  // the previous chunk is consumed
    w_row[tx] = (b < B && l < L) ? to_float(w[b * L + l]) : 0.f;
    __syncthreads();
    if (live) {
      const int n = (int)(L - l0 < dx ? L - l0 : dx);
      const T* rl = r + l0 * D;
      for (int j = 0; j < n; ++j) {
        acc = fmaf(w_row[j], to_float(rl[(int64_t)j * D]), acc);
      }
    }
  }
  if (live) out[b * D + d] = from_float<T>(acc);
}

template <typename T>
int launch(const void* rows, const void* w, int64_t B, int64_t L, int64_t D,
           void* out, cudaStream_t stream) {
  int dx = (int)((D + 31) / 32 * 32);
  if (dx > kThreads) dx = kThreads;
  const int by = kThreads / dx;
  const int64_t grid_x = (B + by - 1) / by;
  const int64_t grid_y = (D + dx - 1) / dx;
  if (grid_x > INT32_MAX || grid_y > kMaxGridY) return (int)cudaErrorInvalidValue;
  bag_reduce_kernel<T><<<dim3((unsigned)grid_x, (unsigned)grid_y),
                         dim3(dx, by), 0, stream>>>(
      (const T*)rows, (const T*)w, B, L, D, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* eb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16 (rows, w and out alike).
int eb_bag_reduce(const void* rows, const void* w, int64_t B, int64_t L,
                  int64_t D, void* out, int dtype, void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(rows, w, B, L, D, out, s);
    case 1: return launch<__nv_bfloat16>(rows, w, B, L, D, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
