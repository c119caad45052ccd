// LBJF (Euler) posterior log-probabilities for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ctdd_tpu/ops/pallas_kernels.py::_euler_kernel
// (reached through euler_posterior_pallas, pallas_call at
// pallas_kernels.py:137). Per row r of the (rows, S) reverse rates:
//
//   post0 = rev[r] * (1 - onehot(x[r]))
//   diag  = max(1 - h * sum(post0), 0)
//   post  = h * post0 + diag * onehot(x[r])
//   out[r] = log(post / sum(post) + 1e-35)
//
// x is read as int32 (no one-hot input), rows need no padding. Built without
// fast-math and without flush-to-zero: 1e-35 is a normal float32 and the
// quotient below it may be subnormal.
//
// Bound on the H100 (3.35 TB/s HBM): one (rows, S) f32 array read and one
// written; at rows = 16 * 784, S = 256 that is ~25.7 MB, ~8 us. Two row sums
// and one logf per entry are far below the f32 rate, so bytes bound it.
//
// Design: one warp per row, the row held in registers (lane owns
// s = lane + 32 * j, so loads and stores are coalesced), two warp-shuffle
// sums. Every byte is touched once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows per block
constexpr int kMaxS = 256;
constexpr int kPerLane = kMaxS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
euler_posterior_kernel(const float* __restrict__ rev,
                       const int* __restrict__ x, float* __restrict__ out,
                       int rows, int S, float h) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int xr = x[row];
  const size_t base = (size_t)row * S;

  float p[kPerLane];
  float off = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    p[j] = s < S ? rev[base + s] * (s == xr ? 0.f : 1.f) : 0.f;
    off += p[j];
  }
  off = warp_sum(off);
  // product and difference rounded separately, as the plain version does
  const float diag = fmaxf(1.f - __fmul_rn(h, off), 0.f);
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    p[j] = s == xr ? diag : __fmul_rn(p[j], h);
    tot += s < S ? p[j] : 0.f;
  }
  tot = warp_sum(tot);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    if (s < S) out[base + s] = logf(p[j] / tot + 1e-35f);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `stream` is a
// cudaStream_t.
extern "C" int euler_posterior_launch(const float* rev, const int* x,
                                      float* out, int rows, int S, float h,
                                      void* stream) {
  if (S < 2 || S > kMaxS || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  euler_posterior_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rev, x, out, rows, S, h);
  return (int)cudaGetLastError();
}
