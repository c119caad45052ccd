// LBJF (Euler) posterior and its categorical draw for Hopper (sm_90a), plain
// C interface.
//
// Replaces the TPU kernel ctdd_tpu/ops/pallas_kernels.py::_euler_kernel
// (pallas_kernels.py:111-149, reached through euler_posterior_pallas,
// pallas_call at pallas_kernels.py:137). Per row r of the (rows, S) reverse
// rates:
//
//   post0 = rev[r] * (1 - onehot(x[r]))
//   diag  = max(1 - h * sum(post0), 0)
//   post  = h * post0 + diag * onehot(x[r])
//   logp  = log(post / sum(post) + 1e-35)
//
// Two outputs, chosen per launch:
// - log-prob mode writes logp, (rows, S) f32: the TPU kernel's function.
// - draw mode writes x_new[r] = argmax_s(logp[s] + g[s]), (rows,) int32, and
//   no (rows, S) array; ties go to the lowest index and NaN counts as the
//   largest value, as torch.argmax. The Gumbel noise g is read from a
//   (rows, S) f32 input (injected), or made here: Philox4x32-10 keyed by the
//   64-bit seed's two words, one counter per row and chunk of 4 columns,
//   (row, chunk, substep, row >> 32), whose 4 words go to the chunk's
//   columns; u = top 24 bits / 2^24, clamped to FLT_MIN, g = -log(-log(u)),
//   as utils/math.py::gumbel_noise (ops/rate_kernels.py::philox_gumbel is
//   the same stream in PyTorch). The inner log is logf, exact near u = 1;
//   the outer one __logf, within ~6e-6 of logf over its range [6e-8, 87.4],
//   which moves a draw only where two values of logp + g lie that close.
//   Both noise sources run the same posterior and argmax code.
//
// x is read as int32 (no one-hot input), rows need no padding. Built without
// fast-math and without flush-to-zero: 1e-35 is a normal float32 and the
// quotient below it may be subnormal. Products and differences are rounded
// separately (__fmul_rn), as the plain version rounds them; post / sum is
// post * (1 / sum), within an ulp of the quotient (sum >= 1 up to rounding:
// it is h * sum(post0) or 1), a true division only where sum > 1e37.
//
// Bound on the H100 (3.35 TB/s HBM). Draw mode: the rates read once, x read
// and the state written, 4 * (rows * S + 2 * rows) bytes (plus rows * S * 4
// with injected g); at rows = 256 * 784, S = 256 that is 207.1 MB, 61.8 us,
// and 12.95 MB, 3.9 us, at rows = 16 * 784. Log-prob mode: one (rows, S)
// array read and one written, twice that. The chain this mode replaces
// (log-probs written, then noise, add, argmax, cast as separate passes)
// moved ~17 (rows, S) arrays. What stands between the keyed draw and its
// bound is instructions, not bytes: per entry three logs (the posterior's
// and the noise's two) and a quarter of a 10-round Philox block.
//
// Design:
// - A row takes only the lanes its S needs: G = the least power of two with
//   4 * G chunks of 4 columns >= S, so 1 lane at S <= 16, 2 at S = 21, 16 at
//   S > 128; a warp carries 32 / G rows, and a lane owns chunks
//   c = lane % G + G * j (j < 4), columns 4c..4c+3. The row sums and the
//   argmax are segmented xor shuffles inside the G lanes (identical
//   results on every lane of the group: each level combines two values in
//   either order).
// - 16-byte loads and stores where S % 4 == 0 and every pointer is 16-byte
//   aligned (every row is then aligned), else 4 scalar loads per chunk.
// - The row stays in registers from the load to the argmax; every byte of
//   the rates (and of g) is read once. Group lane 0 writes the state.
// - One counter per chunk: one Philox call gives a chunk's 4 uniforms, so
//   the draws do not depend on the load path.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 256;
constexpr int kChunks = 4;          // chunks of 4 columns per lane
constexpr int kPer = 4 * kChunks;   // entries per lane

enum Mode { kLogProb = 0, kDrawInjected = 1, kDrawPhilox = 2 };

// Philox4x32-10 (Salmon et al., SC'11), key bumped after every round; the
// same generator as csrc/fused_tau_leap.cu.
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

// Standard Gumbel from 32 random bits: u in [0, 1) from the top 24 bits,
// clamped to float32's tiny, -log(-log(u)).
__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = fmaxf((float)(bits >> 8) * (1.0f / 16777216.0f), FLT_MIN);
  return -__logf(-logf(u));
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, i) before (w, j) in torch.argmax's order: NaN above every number,
// then the larger value, then the lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  if (v != v) return w == w || i < j;
  if (w != w) return false;
  return v > w || (v == w && i < j);
}

// Loads 4 columns of a chunk (zeros past S).
__device__ __forceinline__ void load_chunk(const float* __restrict__ row,
                                           int c, int S, bool vec, float* d) {
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row) + c);
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = 4 * c + k < S ? __ldg(row + 4 * c + k) : 0.f;
  }
}

template <int G, int kMode>
__global__ void __launch_bounds__(kThreads)
euler_posterior_kernel(const float* __restrict__ rev,
                       const int* __restrict__ x,
                       const float* __restrict__ gin, float* __restrict__ logp,
                       int* __restrict__ draw, long long rows, int S, float h,
                       int vec, uint32_t k0, uint32_t k1, uint32_t substep) {
  const int g = threadIdx.x & (G - 1);
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  // a dead lane still takes part in the shuffles of its warp
  const bool live = row < rows;
  const int chunks = (S + 3) >> 2;
  const size_t base = (size_t)(live ? row : 0) * S;
  const int xr = live ? __ldg(x + row) : -1;

  float p[kPer];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = g + G * j;
    if (live && c < chunks) {
      load_chunk(rev + base, c, S, vec, p + 4 * j);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) p[4 * j + k] = 0.f;
    }
  }

  float off = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int s = 4 * (g + G * (e >> 2)) + (e & 3);
    p[e] = p[e] * (s == xr ? 0.f : 1.f);
    off += p[e];
  }
  off = group_sum<G>(off);
  const float diag = fmaxf(1.f - __fmul_rn(h, off), 0.f);
  float tot = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int s = 4 * (g + G * (e >> 2)) + (e & 3);
    p[e] = s == xr ? diag : __fmul_rn(p[e], h);
    tot += s < S ? p[e] : 0.f;
  }
  tot = group_sum<G>(tot);
  const float inv = 1.f / tot;
  const bool huge = tot > 1e37f;  // 1 / tot would be subnormal
  // p becomes post / sum(post) + 1e-35, the argument of the log
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    p[e] = (huge ? __fdiv_rn(p[e], tot) : __fmul_rn(p[e], inv)) + 1e-35f;

  if constexpr (kMode == kLogProb) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = g + G * j;
      if (c >= chunks) continue;
      float o4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o4[k] = logf(p[4 * j + k]);
      float* o = logp + base + 4 * c;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(o4[0], o4[1], o4[2], o4[3]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * c + k < S) o[k] = o4[k];
      }
    }
  } else {
    // argmax of logp + g, a lane's entries in increasing column order
    float best = __int_as_float(0xff800000);  // -inf
    int best_s = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = g + G * j;
      if (!(live && c < chunks)) continue;
      float n[4];
      if constexpr (kMode == kDrawInjected) {
        load_chunk(gin + base, c, S, vec, n);
      } else {
        const uint4 b = philox4x32_10(
            make_uint4((uint32_t)row, (uint32_t)c, substep,
                       (uint32_t)((unsigned long long)row >> 32)), k0, k1);
        n[0] = gumbel(b.x); n[1] = gumbel(b.y); n[2] = gumbel(b.z); n[3] = gumbel(b.w);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * c + k;
        if (s >= S) break;
        const float v = logf(p[4 * j + k]) + n[k];
        if (beats(v, s, best, best_s)) {
          best = v;
          best_s = s;
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, best, o);
      const int ws = __shfl_xor_sync(0xffffffffu, best_s, o);
      if (beats(w, ws, best, best_s)) {
        best = w;
        best_s = ws;
      }
    }
    if (live && g == 0) draw[row] = best_s;
  }
}

template <int kMode>
cudaError_t launch_mode(int G, const float* rev, const int* x, const float* g,
                        float* logp, int* draw, long long rows, int S, float h,
                        int vec, uint32_t k0, uint32_t k1, uint32_t substep,
                        cudaStream_t stream) {
  const long long blocks = (rows * G + kThreads - 1) / kThreads;
#define EULER_LAUNCH(GG)                                                      \
  euler_posterior_kernel<GG, kMode><<<(unsigned)blocks, kThreads, 0, stream>>>( \
      rev, x, g, logp, draw, rows, S, h, vec, k0, k1, substep)
  switch (G) {
    case 1: EULER_LAUNCH(1); break;
    case 2: EULER_LAUNCH(2); break;
    case 4: EULER_LAUNCH(4); break;
    case 8: EULER_LAUNCH(8); break;
    default: EULER_LAUNCH(16); break;
  }
#undef EULER_LAUNCH
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

// One launch of the posterior over `rows` rows of S reverse rates. Exactly
// one of `logp` ((rows, S) f32: log-prob mode) and `draw` ((rows,) int32:
// draw mode) is non-null. In draw mode `g` ((rows, S) f32) injects the
// Gumbel noise, or is null for the in-kernel Philox stream keyed by `seed`
// (low word, high word) and `substep`. Returns the cudaError_t of the launch
// (0 on success). `stream` is a cudaStream_t.
extern "C" int euler_posterior_launch(const float* rev, const int* x,
                                      const float* g, float* logp, int* draw,
                                      long long rows, int S, float h,
                                      unsigned long long seed,
                                      unsigned int substep, void* stream) {
  if (S < 2 || S > kMaxS || rows < 0 || (logp == nullptr) == (draw == nullptr) ||
      (logp != nullptr && g != nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int G = 1;
  while (kChunks * G * 4 < S) G *= 2;
  const int vec = S % 4 == 0 && aligned16(rev) && aligned16(g) && aligned16(logp);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  const cudaStream_t st = (cudaStream_t)stream;
  if (logp != nullptr)
    return (int)launch_mode<kLogProb>(G, rev, x, g, logp, draw, rows, S, h, vec,
                                      k0, k1, substep, st);
  if (g != nullptr)
    return (int)launch_mode<kDrawInjected>(G, rev, x, g, logp, draw, rows, S, h,
                                           vec, k0, k1, substep, st);
  return (int)launch_mode<kDrawPhilox>(G, rev, x, g, logp, draw, rows, S, h, vec,
                                       k0, k1, substep, st);
}
