// Reverse rates of the p0t path for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ctdd_tpu/ops/pallas_kernels.py::_rev_rates_kernel
// (reached through reverse_rates_pallas, pallas_call at pallas_kernels.py:81).
// Per row r = (n, d) of the (N, D, S) inputs it computes, in float32,
//
//   p      = softmax(logits[r])
//   a      = p / qt0_cols[r]                  qt0_cols already holds + eps
//   ratio  = a @ qt0[n]                       f32 products, f32 accumulation
//   out[r] = rate_cols[r] * ratio, and exactly 0 at x[r]
//
// `qt0` is one (S, S) table per sample; `qt0_stride` is the distance between
// two samples' tables in floats, 0 when the whole batch shares one table.
// x is read as int32 (no one-hot input) and the ragged last tile of D is
// masked in the kernel (no padding).
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor cores)
// at the serving shape N = 16, D = 784, S = 256: three (N, D, S) f32 inputs
// and one output, 12.85 MB each, plus x and the table: ~51.6 MB, ~15 us. The
// product is 2 * N * D * S * S = 1.64 GFLOP; it stays f32 (this is the
// higher-precision kernel, so the bf16 tensor-core rate does not apply):
// ~25 us at the f32 rate. The function is bound by operations there.
//
// Design (simple first):
// - A block takes kRows rows of ONE sample, so all its rows use one table.
// - Phase 1, one warp per row: softmax and the division; `a` goes to a
//   (kRows, S) tile in shared memory (32 KB).
// - Phase 2, one thread per output column k: kRows accumulators in
//   registers, s ascending. a[i][s] is a shared-memory broadcast (float4
//   over s); qt0[s][k] is a coalesced load. The f32 table (256 KB at S=256)
//   does not fit in shared memory beside the tile; it is read through L2,
//   where one table (or a batch of them, up to 50 MB) stays resident.
// - Phase 3: multiply by rate_cols, zero the entry at x, coalesced store.
// - Any S in [2, 256], any D; for S < 256 the threads past column S idle in
//   phases 2 and 3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per output column
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // rows of one sample per block
constexpr int kMaxS = 256;
constexpr int kPerLane = kMaxS / 32;
static_assert(kThreads == kMaxS, "one thread per output column");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
reverse_rates_kernel(const float* __restrict__ logits,
                     const float* __restrict__ qcols,
                     const float* __restrict__ qt0,
                     const float* __restrict__ rcols,
                     const int* __restrict__ x, float* __restrict__ out,
                     int D, int S, int tiles_per_sample,
                     long long qt0_stride) {
  __shared__ __align__(16) float a_tile[kRows * kMaxS];
  __shared__ int x_tile[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x / tiles_per_sample;
  const int d0 = (blockIdx.x % tiles_per_sample) * kRows;
  const int Sp = (S + 3) & ~3;  // tile row pitch: the float4 step over s

  // 1. a = softmax(logits) / qt0_cols; lane owns s = lane + 32 * j
  for (int r = warp; r < kRows; r += kWarps) {
    const int d = d0 + r;
    float* a_row = a_tile + r * Sp;
    if (d >= D) {
      for (int s = lane; s < Sp; s += 32) a_row[s] = 0.f;
      if (lane == 0) x_tile[r] = -1;
      continue;
    }
    const size_t base = ((size_t)n * D + d) * S;
    float e[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      e[j] = s < S ? logits[base + s] : -INFINITY;
      m = fmaxf(m, e[j]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      e[j] = s < S ? expf(e[j] - m) : 0.f;
      sum += e[j];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      if (s < S) {
        a_row[s] = (e[j] / sum) / qcols[base + s];
      } else if (s < Sp) {
        a_row[s] = 0.f;
      }
    }
    if (lane == 0) x_tile[r] = x[(size_t)n * D + d];
  }
  __syncthreads();

  // 2. ratio[i][k] = sum_s a[i][s] * qt0[n][s][k], s ascending
  const int k = tid;
  if (k >= S) return;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  const float* q = qt0 + (size_t)n * qt0_stride + k;
  int s0 = 0;
  for (; s0 + 3 < S; s0 += 4) {
    const float q0 = q[(size_t)(s0 + 0) * S];
    const float q1 = q[(size_t)(s0 + 1) * S];
    const float q2 = q[(size_t)(s0 + 2) * S];
    const float q3 = q[(size_t)(s0 + 3) * S];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_tile + i * Sp + s0);
      acc[i] = fmaf(a4.x, q0, acc[i]);
      acc[i] = fmaf(a4.y, q1, acc[i]);
      acc[i] = fmaf(a4.z, q2, acc[i]);
      acc[i] = fmaf(a4.w, q3, acc[i]);
    }
  }
  for (; s0 < S; ++s0) {
    const float qv = q[(size_t)s0 * S];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc[i] = fmaf(a_tile[i * Sp + s0], qv, acc[i]);
  }

  // 3. out = rate_cols * ratio, zero at x
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int d = d0 + i;
    if (d >= D) break;
    const size_t idx = ((size_t)n * D + d) * S + k;
    out[idx] = k == x_tile[i] ? 0.f : rcols[idx] * acc[i];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `stream` is a
// cudaStream_t; `qt0_stride` is S * S for per-sample tables, 0 for a shared
// one.
extern "C" int reverse_rates_launch(const float* logits, const float* qcols,
                                    const float* qt0, const float* rcols,
                                    const int* x, float* out, int N, int D,
                                    int S, long long qt0_stride,
                                    void* stream) {
  if (S < 2 || S > kMaxS || N < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return 0;
  const int tiles_per_sample = (D + kRows - 1) / kRows;
  const long long blocks = (long long)N * tiles_per_sample;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  reverse_rates_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      logits, qcols, qt0, rcols, x, out, D, S, tiles_per_sample, qt0_stride);
  return (int)cudaGetLastError();
}
