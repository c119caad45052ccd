// Fused tau-leap sampler update for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ctdd_tpu/ops/fused_update.py::_update_kernel
// (reached through fused_tau_leap_update, pallas_call at fused_update.py:170).
// Per row r of the (rows, S) logits it computes
//
//   p      = softmax(logits[r])
//   a      = bf16(p / (qt0[:, xg[r]] + eps))        tables rounded to bf16
//   ratio  = a @ qt0                                  f32 accumulation
//   rev    = rate[:, xg[r]] * ratio, zero at xg[r]
//   poisson:  n_s ~ Poisson(rev_s * h) by 12-term CDF inversion,
//             rejected rows (non-ordinal, sum n > 1) keep their state,
//             jump = sum_s n_s * (s - xg[r])
//   expected: jump = rint(h * sum_s rev_s * (s - xg[r]))
//   out[r] = clip(xb[r] + jump, 0, S - 1)
//
// and writes only the (rows,) int32 state.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense) at the flagship
// bench shape rows = 256 * 784, S = 256: the kernel must read the f32 logits
// (205.5 MB) plus the states and tables (~1.9 MB), about 208 MB, which is
// ~62 us; the ratio product is 2 * rows * S * S = 26.3 GFLOP, ~27 us at the
// bf16 tensor-core rate. So the function is memory-bound, ~62 us.
//
// Design (simple first; the tensor-core version comes later):
// - Gathers are indexed loads. The wrapper passes bf16 qt0^T and rate^T, so
//   column xg[r] of each table is a contiguous row, read from L2.
// - qt0 (bf16, S*S*2 bytes = 128 KB at S=256) stays in dynamic shared memory
//   for the life of a persistent block; blocks walk row tiles of kRows rows.
//   That leaves room for one block per SM, so the block has 1024 threads
//   (32 warps) to hide load and instruction latency.
// - The product runs on the CUDA cores in f32: four thread groups split a
//   tile's rows, one thread per output column with kRowsPerThread
//   accumulators, k in ascending order; wgmma is later work. This makes the
//   kernel bound by shared-memory and FMA throughput, not by HBM.
// - Uniforms come from Philox4x32-10 keyed by the 64-bit seed's two words,
//   with counter (row, s / 4): independent words, so no (seed, tile) sums
//   alias across steps. With `u` non-null the kernel reads (rows, S) f32
//   uniforms instead (the injected-randomness hook used to hold the kernel
//   against its plain version).
// - Any S in [2, 256]; the last row tile is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // 32 warps: the one block an SM holds
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;          // rows per tile
constexpr int kMaxS = 256;         // one thread per output column
constexpr int kColGroups = kThreads / kMaxS;  // thread groups splitting a tile's rows
constexpr int kRowsPerThread = kRows / kColGroups;
static_assert(kThreads % kMaxS == 0 && kRows % kColGroups == 0, "tile shape");
constexpr int kGroups = kMaxS / 128;  // 4-wide column groups per lane
constexpr int kMaxPoissonK = 12;   // ops/fused_update.py MAX_POISSON_K

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

// Philox4x32-10 (Salmon et al., SC'11), key bumped after every round.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// u in [0, 1) from the top 24 bits.
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// N = #{k : u > P(Poisson(lam) <= k)}, the same unrolled series and the same
// operation order as ops/fused_update.py::_poisson_inversion_from_u.
__device__ __forceinline__ float poisson_inversion(float u, float lam) {
  float pmf = expf(-lam);
  float cdf = pmf;
  float n = 0.f;
#pragma unroll
  for (int k = 1; k <= kMaxPoissonK; ++k) {
    n += (u > cdf) ? 1.f : 0.f;
    pmf = pmf * lam / (float)k;
    cdf = cdf + pmf;
  }
  return n;
}

__device__ __forceinline__ int clamp_state(int x, int S) {
  return x < 0 ? 0 : (x > S - 1 ? S - 1 : x);
}

// Lane `lane` of a warp owns columns s = 128 * g + 4 * lane + c, c in 0..3:
// one Philox counter (row, s / 4) feeds the lane's four columns of a group.
__global__ void __launch_bounds__(kThreads)
fused_tau_leap_kernel(const float* __restrict__ logits,
                      const int* __restrict__ xg, const int* __restrict__ xb,
                      const __nv_bfloat16* __restrict__ qt0,
                      const __nv_bfloat16* __restrict__ qt0T,
                      const __nv_bfloat16* __restrict__ rateT,
                      const float* __restrict__ u, int* __restrict__ out,
                      int rows, int S, float h, float eps, uint32_t key0,
                      uint32_t key1, int expected_mode, int is_ordinal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sp = (S + 3) & ~3;  // K padded to the float4 step, zero-filled
  float* tile = reinterpret_cast<float*>(smem);  // kRows x Sp: a, then ratio
  __nv_bfloat16* tab =
      reinterpret_cast<__nv_bfloat16*>(tile + kRows * Sp);  // Sp x S: qt0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < Sp * S; i += kThreads)
    tab[i] = i < S * S ? qt0[i] : __float2bfloat16(0.f);

  const int num_tiles = (rows + kRows - 1) / kRows;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int row0 = t * kRows;

    // 1. softmax and a = bf16(p / (qd + eps)); one warp per row
    for (int r = warp; r < kRows; r += kWarps) {
      const int row = row0 + r;
      float* a_row = tile + r * Sp;
      if (row >= rows) {
        for (int s = lane; s < Sp; s += 32) a_row[s] = 0.f;
        continue;
      }
      const float* lrow = logits + (size_t)row * S;
      float e[kGroups][4];
      float m = -INFINITY;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = 128 * g + 4 * lane + c;
          e[g][c] = s < S ? lrow[s] : -INFINITY;
          m = fmaxf(m, e[g][c]);
        }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = 128 * g + 4 * lane + c;
          e[g][c] = s < S ? expf(e[g][c] - m) : 0.f;
          sum += e[g][c];
        }
      sum = warp_sum(sum);
      const __nv_bfloat16* qd = qt0T + (size_t)clamp_state(xg[row], S) * S;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = 128 * g + 4 * lane + c;
          if (s < S) {
            const float p = e[g][c] / sum;
            const float a = p / (__bfloat162float(qd[s]) + eps);
            a_row[s] = __bfloat162float(__float2bfloat16(a));
          } else if (s < Sp) {
            a_row[s] = 0.f;
          }
        }
    }
    __syncthreads();

    // 2. ratio[r][s] = sum_k a[r][k] * qt0[k][s], k ascending; thread
    //    (group, s) owns column s of rows group * kRowsPerThread + i
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    const int s_col = tid % kMaxS;
    const float* a_rows = tile + (tid / kMaxS) * kRowsPerThread * Sp;
    if (s_col < S) {
      for (int k = 0; k < Sp; k += 4) {
        const float q0 = __bfloat162float(tab[(k + 0) * S + s_col]);
        const float q1 = __bfloat162float(tab[(k + 1) * S + s_col]);
        const float q2 = __bfloat162float(tab[(k + 2) * S + s_col]);
        const float q3 = __bfloat162float(tab[(k + 3) * S + s_col]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(a_rows + i * Sp + k);
          acc[i] = fmaf(a4.x, q0, acc[i]);
          acc[i] = fmaf(a4.y, q1, acc[i]);
          acc[i] = fmaf(a4.z, q2, acc[i]);
          acc[i] = fmaf(a4.w, q3, acc[i]);
        }
      }
    }
    __syncthreads();
    if (s_col < S) {
      float* r_rows = tile + (tid / kMaxS) * kRowsPerThread * Sp;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) r_rows[i * Sp + s_col] = acc[i];
    }
    __syncthreads();

    // 3. reverse rates, jump, new state; one warp per row
    for (int r = warp; r < kRows; r += kWarps) {
      const int row = row0 + r;
      if (row >= rows) continue;
      const int x = clamp_state(xg[row], S);
      const __nv_bfloat16* fwd = rateT + (size_t)x * S;
      const float* ratio = tile + r * Sp;
      float total = 0.f;  // poisson: sum n; expected: unused
      float moved = 0.f;  // poisson: sum n * (s - x); expected: sum rev * (s - x)
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int s0 = 128 * g + 4 * lane;
        if (s0 >= S) continue;
        float uu[4] = {0.f, 0.f, 0.f, 0.f};
        if (!expected_mode) {
          if (u != nullptr) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (s0 + c < S) uu[c] = u[(size_t)row * S + s0 + c];
          } else {
            const uint4 bits = philox4x32_10(
                make_uint4((uint32_t)row, (uint32_t)(s0 >> 2), 0u, 0u), key0,
                key1);
            uu[0] = to_unit(bits.x);
            uu[1] = to_unit(bits.y);
            uu[2] = to_unit(bits.z);
            uu[3] = to_unit(bits.w);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = s0 + c;
          if (s >= S) continue;
          const float rev = s == x ? 0.f : __bfloat162float(fwd[s]) * ratio[s];
          const float diff = (float)(s - x);
          if (expected_mode) {
            moved += rev * diff;
          } else {
            const float n = poisson_inversion(uu[c], rev * h);
            total += n;
            moved += n * diff;
          }
        }
      }
      total = warp_sum(total);
      moved = warp_sum(moved);
      if (lane == 0) {
        float jump;
        if (expected_mode) {
          jump = rintf(h * moved);
        } else {
          jump = (!is_ordinal && total > 1.f) ? 0.f : moved;
        }
        // |jump| > S clips to the same state; bounding it keeps the int sum
        // from overflowing
        jump = fminf(fmaxf(jump, (float)-S), (float)S);
        out[row] = clamp_state(xb[row] + (int)jump, S);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `stream` is a
// cudaStream_t; `seed` gives the Philox key words (low, high 32 bits).
extern "C" int fused_tau_leap_launch(const float* logits, const int* xg,
                                     const int* xb, const void* qt0,
                                     const void* qt0T, const void* rateT,
                                     const float* u, int* out, int rows, int S,
                                     float h, float eps,
                                     unsigned long long seed,
                                     int expected_mode, int is_ordinal,
                                     void* stream) {
  if (S < 2 || S > kMaxS || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int Sp = (S + 3) & ~3;
  const size_t smem = (size_t)kRows * Sp * sizeof(float) +
                      (size_t)Sp * S * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_tau_leap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_tau_leap_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int tiles = (rows + kRows - 1) / kRows;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  fused_tau_leap_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      logits, xg, xb, static_cast<const __nv_bfloat16*>(qt0),
      static_cast<const __nv_bfloat16*>(qt0T),
      static_cast<const __nv_bfloat16*>(rateT), u, out, rows, S, h, eps,
      (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32), expected_mode,
      is_ordinal);
  return (int)cudaGetLastError();
}
