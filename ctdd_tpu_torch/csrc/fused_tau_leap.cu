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
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense) at rows =
// 256 * 784, S = 256: the f32 logits (205.5 MB) plus states and tables are
// ~208 MB, ~62 us; the ratio product is 26.3 GFLOP, ~27 us on the tensor
// cores. The function is memory-bound. What a block does per entry beside
// the product (the softmax, a quarter of a Philox block, a compare, and the
// series for the entries that may jump) runs on the CUDA cores with 6 warps
// per SM to hide its latencies, and is what the kernel's time is made of.
//
// Design:
// - One persistent block of 6 warps per SM; a tile is 96 rows, 16 per warp.
//   The serving shape (16 * 784 = 12,544 rows) is 131 tiles: one wave over
//   the 132 SMs. A warp owns its 16 rows from the load to the store, so the
//   tile loop has no block-wide barrier; warps drift apart and one warp's
//   loads and epilogue overlap another's product.
// - Shared memory (S = 256): the bf16 table qt0^T, [n][k], 128 KB, resident
//   for the block's life, 16-byte chunks XOR-swizzled by (n & 7) so that
//   ldmatrix reads hit 8 different bank groups; and a 96 KB f32 staging area,
//   16 rows x 1 KB per warp, swizzled the same way. 229,376 bytes in all.
// - Loads overlapped: as soon as a warp has turned its staged logits into
//   A fragments (registers), it starts cp.async copies of its 16 rows of the
//   block's NEXT tile into the same staging rows; they land while the warp
//   runs the product and the epilogue. Up to 96 KB are in flight per SM.
// - Softmax in the MMA's own layout: thread (g = lane / 4, q = lane % 4)
//   reads rows g and g + 8, columns 16 ks + 2 q + {0, 1, 8, 9}, which is the
//   m16n8k16 A fragment, so `a` never goes back to shared memory: max, sum
//   (exp stored in place), then a = bf16(e / sum / (qd + eps)) packed into 64
//   registers. qd = qt0[:, x] is row x of the shared-memory table. The
//   exponential and the divisions are the fast intrinsics: their few ulps of
//   f32 vanish in the rounding of `a` to bf16.
// - Product on the tensor cores: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32
//   (each product exact in f32), B fragments by ldmatrix.x4 from the table.
//   A warp runs its 16 x 256 output in four passes of 64 columns (32 f32
//   accumulators, which leaves registers to overlap the epilogue's chains),
//   carrying the row sums across.
// - Epilogue from the accumulator fragments: a thread holds, per 8-column
//   block, columns 2 q, 2 q + 1 of rows g and g + 8. The row sums (`total`,
//   `moved`) finish with two quad shuffles.
// - The Poisson count stops when it is decided: the CDF only grows, so the
//   series of ops/fused_update.py::_poisson_inversion_from_u (same operation
//   order) ends at the first comparison that fails. u < 1 - lam - 1e-6 decides
//   a count of 0 without the exponential, and a thread none of whose four
//   entries can jump skips the series and the sums. A thread takes its
//   entries that may jump one per turn of a loop, so the warp runs the series
//   once where each thread has at most one, the usual case.
// - Uniforms: Philox4x32-10 keyed by the 64-bit seed's two words. One counter
//   per thread and 8-column block: counter = (row, col, 0, 0) with row = the
//   thread's first row (16 * (row / 16) + g, g < 8) and col = 8 nb + 2 q; its
//   four words go to (row, col), (row, col + 1), (row + 8, col) and
//   (row + 8, col + 1), the top 24 bits of each that entry's own uniform.
//   With `u` non-null the kernel reads (rows, S) f32 uniforms instead (the
//   injected-randomness hook).
// - Any S in [2, 256]: the host pads both tables with zeros to Sp = S rounded
//   up to 32 (ops/fused_update.py::pack_tables_t); padded columns take no part
//   in the softmax, have ratio 0 and rate 0, hence count 0. Ragged last tile
//   masked by row.
// - Budget: 192 threads and one block per SM leave up to 255 registers a
//   thread: 64 of A fragments, 32 accumulators, 16 of prefetched rates, the
//   rest for the epilogue's chains. ptxas -v (CUDA 12.8, sm_90a): 255
//   registers for the S = 256 instantiations, 148-175 for the general ones,
//   no spills, no static shared memory; 229,376 bytes dynamic at S = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 6;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;               // one m16 block per warp
constexpr int kRows = kWarps * kWarpRows;   // rows per tile
constexpr int kMaxS = 256;
constexpr int kMaxKSteps = kMaxS / 16;      // k16 steps
constexpr int kPassBlocks = 8;              // 8-column blocks per pass
constexpr int kMaxPoissonK = 12;            // ops/fused_update.py MAX_POISSON_K

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

// exp(-lam) >= 1 - lam, so u < 1 - lam - 1e-6 decides N = 0 without the
// exponential. The margin is 8 ulps of 1, above the rounding of the
// subtraction and of expf, so the count equals the full series' count.
__device__ __forceinline__ bool poisson_maybe_positive(float u, float lam) {
  return !(u < 0.999999f - lam);
}

// N = #{k : u > P(Poisson(lam) <= k)}: the series of
// ops/fused_update.py::_poisson_inversion_from_u with the same operation
// order. The CDF is non-decreasing (lam >= 0), so the first comparison that
// fails ends the count: every later one would fail too.
__device__ __forceinline__ float poisson_inversion(float u, float lam) {
  float pmf = expf(-lam);
  float cdf = pmf;
  if (!(u > cdf)) return 0.f;
  pmf = pmf * lam;  // k = 1: x / 1 is x
  cdf = cdf + pmf;
  if (!(u > cdf)) return 1.f;
  pmf = pmf * lam * 0.5f;  // k = 2: x / 2 and x * 0.5 round alike
  cdf = cdf + pmf;
  float n = 2.f;
#pragma unroll 1
  for (int k = 3; k <= kMaxPoissonK; ++k) {
    if (!(u > cdf)) break;
    n += 1.f;
    pmf = pmf * lam / (float)k;
    cdf = cdf + pmf;
  }
  return n;
}

// The counts of a thread's four entries. Only an entry that may jump runs its
// series, and a thread takes its such entries one per turn of the loop, so
// the warp runs the series once where each thread has at most one (the usual
// case) instead of once per entry slot. Out of line, reached only by threads
// with an entry that may jump.
__device__ __noinline__ float4 poisson_inversion4(float u0, float u1, float u2,
                                                  float u3, float l0, float l1,
                                                  float l2, float l3) {
  float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned todo = (poisson_maybe_positive(u0, l0) ? 1u : 0u) |
                  (poisson_maybe_positive(u1, l1) ? 2u : 0u) |
                  (poisson_maybe_positive(u2, l2) ? 4u : 0u) |
                  (poisson_maybe_positive(u3, l3) ? 8u : 0u);
  while (todo) {
    const unsigned bit = todo & (0u - todo);  // lowest entry still to do
    todo ^= bit;
    const float u = bit == 1u ? u0 : bit == 2u ? u1 : bit == 4u ? u2 : u3;
    const float lam = bit == 1u ? l0 : bit == 2u ? l1 : bit == 4u ? l2 : l3;
    const float count = poisson_inversion(u, lam);
    if (bit == 1u) n.x = count;
    if (bit == 2u) n.y = count;
    if (bit == 4u) n.z = count;
    if (bit == 8u) n.w = count;
  }
  return n;
}

__device__ __forceinline__ int clamp_state(int x, int S) {
  return x < 0 ? 0 : (x > S - 1 ? S - 1 : x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Float offset of element (r, col) in a warp's staging rows: row pitch Sp,
// 16-byte chunks swizzled by (r & 7). Sp is a multiple of 32, so a row has a
// multiple of 8 chunks and the XOR stays inside the row.
__device__ __forceinline__ int stage_off(int r, int col, int Sp) {
  return r * Sp + ((((col >> 2) ^ (r & 7)) << 2) | (col & 3));
}

// bf16 offset of element (n, k) of the table: row pitch Sp, 16-byte chunks of
// 8 values swizzled by (n & mask); mask is 7 where a row has a multiple of 8
// chunks (Sp % 64 == 0), else 3.
__device__ __forceinline__ int tab_off(int n, int k, int Sp, int mask) {
  return n * Sp + ((((k >> 3) ^ (n & mask)) << 3) | (k & 7));
}

// Start the copy of up to 16 rows of logits, beginning at `row0`, into a
// warp's staging rows. `vec`: rows are whole 16-byte chunks at 16-byte
// aligned addresses (S % 4 == 0, aligned base), copied by cp.async; else
// plain loads and stores.
__device__ __forceinline__ void stage_rows(float* stage,
                                           const float* __restrict__ logits,
                                           int row0, int rows, int S, int Sp,
                                           int lane, bool vec) {
  const int valid = min(kWarpRows, rows - row0);
  if (valid > 0) {
    const float* src = logits + (size_t)row0 * S;
    if (vec) {
      const int per_row = S >> 2;
      const int total = valid * per_row;
      for (int i = lane; i < total; i += 32) {
        const int r = i / per_row, c = i - r * per_row;
        cp_async16(stage + r * Sp + ((c ^ (r & 7)) << 2),
                   src + (size_t)r * S + 4 * c);
      }
    } else {
      const int total = valid * S;
      for (int i = lane; i < total; i += 32) {
        const int r = i / S, col = i - r * S;
        stage[stage_off(r, col, Sp)] = src[i];
      }
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// kFull: S == 256, the flagship's state space. Every bound of the unrolled
// loops is then a constant, so the product and the epilogue are straight-line
// code that the compiler can schedule across iterations.
// kMode: which epilogue, so it has no branch on the mode either.
enum Mode { kPoissonPhilox = 0, kPoissonInjected = 1, kExpected = 2 };

template <bool kFull, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
fused_tau_leap_kernel(const float* __restrict__ logits,
                      const int* __restrict__ xg, const int* __restrict__ xb,
                      const __nv_bfloat16* __restrict__ qt0T,
                      const __nv_bfloat16* __restrict__ rateT,
                      const float* __restrict__ u, int* __restrict__ out,
                      int rows, int S, int Sp, int vec, float h, float eps,
                      uint32_t key0, uint32_t key1, int is_ordinal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem);  // Sp x Sp
  float* stage_all =
      reinterpret_cast<float*>(smem + (size_t)Sp * Sp * sizeof(__nv_bfloat16));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and g + 8)
  const int q = lane & 3;   // fragment column pair
  float* stage = stage_all + warp * kWarpRows * Sp;
  const int tab_mask = (Sp % 64 == 0) ? 7 : 3;
  const int ksteps = kFull ? kMaxKSteps : Sp >> 4;
  const int num_tiles = (rows + kRows - 1) / kRows;

  int t = blockIdx.x;
  stage_rows(stage, logits, t * kRows + warp * kWarpRows, rows, S, Sp, lane,
             vec != 0);

  // the table, swizzled; 16-byte chunks
  {
    const int per_row = Sp >> 3;
    const uint4* src = reinterpret_cast<const uint4*>(qt0T);
    uint4* dst = reinterpret_cast<uint4*>(tab);
    for (int i = tid; i < Sp * per_row; i += kThreads) {
      const int n = i / per_row, c = i - n * per_row;
      dst[n * per_row + (c ^ (n & tab_mask))] = src[i];
    }
  }
  __syncthreads();

  // ldmatrix.x4 brings the B fragments of two 8-column blocks for one k16
  // step: lane l addresses row (l & 7) of matrix (l >> 3), which is table row
  // n0 + 8 (l >> 4) + (l & 7), 16-byte chunk 2 ks + ((l >> 3) & 1)
  const int ld_swz = lane & 7 & tab_mask;
  const int ld_half = (lane >> 3) & 1;
  const uint32_t ld_base =
      smem_addr(tab) + (uint32_t)((8 * (lane >> 4) + (lane & 7)) * Sp) * 2u;

  for (; t < num_tiles; t += gridDim.x) {
    const int row0 = t * kRows + warp * kWarpRows;
    const int rg = row0 + g, rh = rg + 8;
    const bool valid_g = rg < rows, valid_h = rh < rows;
    cp_async_wait_all();
    __syncwarp();

    // 1. row maxima, in the A fragment's layout
    float mg = -INFINITY, mh = -INFINITY;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * ks + 8 * half + 2 * q;
        const float2 vg =
            *reinterpret_cast<const float2*>(stage + stage_off(g, col, Sp));
        const float2 vh =
            *reinterpret_cast<const float2*>(stage + stage_off(g + 8, col, Sp));
        if (kFull || col < S) {
          mg = fmaxf(mg, vg.x);
          mh = fmaxf(mh, vh.x);
        }
        if (kFull || col + 1 < S) {
          mg = fmaxf(mg, vg.y);
          mh = fmaxf(mh, vh.y);
        }
      }
    }
    mg = quad_max(mg);
    mh = quad_max(mh);

    // 2. e = exp(v - max), kept in place; row sums
    float sg = 0.f, sh = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * ks + 8 * half + 2 * q;
        float2* pg = reinterpret_cast<float2*>(stage + stage_off(g, col, Sp));
        float2* ph =
            reinterpret_cast<float2*>(stage + stage_off(g + 8, col, Sp));
        float2 vg = *pg, vh = *ph;
        // __expf and, below, one reciprocal per row and __fdividef: a few
        // ulps of f32 on values that are then rounded to bf16's 8 bits
        vg.x = (kFull || col < S) ? __expf(vg.x - mg) : 0.f;
        vh.x = (kFull || col < S) ? __expf(vh.x - mh) : 0.f;
        vg.y = (kFull || col + 1 < S) ? __expf(vg.y - mg) : 0.f;
        vh.y = (kFull || col + 1 < S) ? __expf(vh.y - mh) : 0.f;
        sg += vg.x + vg.y;
        sh += vh.x + vh.y;
        *pg = vg;
        *ph = vh;
      }
    }
    const float inv_sg = 1.f / quad_sum(sg);
    const float inv_sh = 1.f / quad_sum(sh);

    // 3. a = bf16(e / sum / (qd + eps)) as A fragments; qd = table row x
    const int x_g = valid_g ? clamp_state(xg[rg], S) : 0;
    const int x_h = valid_h ? clamp_state(xg[rh], S) : 0;
    uint32_t afrag[kMaxKSteps][4];
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ag0 = 0.f, ag1 = 0.f, ah0 = 0.f, ah1 = 0.f;
        if (kFull || ks < ksteps) {
          const int col = 16 * ks + 8 * half + 2 * q;
          const float2 eg =
              *reinterpret_cast<const float2*>(stage + stage_off(g, col, Sp));
          const float2 eh = *reinterpret_cast<const float2*>(
              stage + stage_off(g + 8, col, Sp));
          const __nv_bfloat162 qg = *reinterpret_cast<const __nv_bfloat162*>(
              tab + tab_off(x_g, col, Sp, tab_mask));
          const __nv_bfloat162 qh = *reinterpret_cast<const __nv_bfloat162*>(
              tab + tab_off(x_h, col, Sp, tab_mask));
          ag0 = __fdividef(eg.x * inv_sg, __low2float(qg) + eps);
          ag1 = __fdividef(eg.y * inv_sg, __high2float(qg) + eps);
          ah0 = __fdividef(eh.x * inv_sh, __low2float(qh) + eps);
          ah1 = __fdividef(eh.y * inv_sh, __high2float(qh) + eps);
          if (!valid_g) ag0 = ag1 = 0.f;
          if (!valid_h) ah0 = ah1 = 0.f;
          if (!kFull && col >= S) ag0 = ah0 = 0.f;  // 0 / 0 where eps = 0
          if (!kFull && col + 1 >= S) ag1 = ah1 = 0.f;
        }
        afrag[ks][2 * half + 0] = pack_bf16(ag0, ag1);
        afrag[ks][2 * half + 1] = pack_bf16(ah0, ah1);
      }
    }

    // the staging rows are free: start the next tile's copy
    __syncwarp();
    const int t_next = t + (int)gridDim.x;  // past the end: nothing to copy
    stage_rows(stage, logits, t_next * kRows + warp * kWarpRows,
               t_next < num_tiles ? rows : 0, S, Sp, lane, vec != 0);

    // 4. ratio = a @ qt0 on the tensor cores, 64 columns per pass, and the
    //    epilogue straight from the accumulators
    const __nv_bfloat16* fwd_g = rateT + (size_t)x_g * Sp;
    const __nv_bfloat16* fwd_h = rateT + (size_t)x_h * Sp;
    float total_g = 0.f, total_h = 0.f;  // poisson: sum n
    float moved_g = 0.f, moved_h = 0.f;  // sum n * (s - x) or sum rev * (s - x)
    for (int n_pass = 0; n_pass * 8 * kPassBlocks < Sp; ++n_pass) {
      const int pass0 = n_pass * 8 * kPassBlocks;
      float acc[kPassBlocks][4];
      // rate[:, x] for this pass's columns, asked for ahead of the product
      // (row x of rate^T through L2); padded columns hold 0
      __nv_bfloat162 fwd[kPassBlocks][2];
#pragma unroll
      for (int nb = 0; nb < kPassBlocks; ++nb) {
        acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
        const int col = pass0 + 8 * nb + 2 * q;
        if (kFull || pass0 + 8 * nb < Sp) {
          fwd[nb][0] = *reinterpret_cast<const __nv_bfloat162*>(fwd_g + col);
          fwd[nb][1] = *reinterpret_cast<const __nv_bfloat162*>(fwd_h + col);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks) {
        if (kFull || ks < ksteps) {
          const uint32_t k_off = (uint32_t)(((2 * ks + ld_half) ^ ld_swz) << 3);
#pragma unroll
          for (int nbp = 0; nbp < kPassBlocks / 2; ++nbp) {
            const int n0 = pass0 + 16 * nbp;  // Sp % 32 == 0: whole pairs
            if (kFull || n0 < Sp) {
              uint32_t b0, b1, b2, b3;
              ldmatrix_x4(b0, b1, b2, b3,
                          ld_base + ((uint32_t)(n0 * Sp) + k_off) * 2u);
              mma_bf16(acc[2 * nbp], afrag[ks], b0, b1);
              mma_bf16(acc[2 * nbp + 1], afrag[ks], b2, b3);
            }
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < kPassBlocks; ++nb) {
        const int col = pass0 + 8 * nb + 2 * q;
        if (!kFull && pass0 + 8 * nb >= Sp) continue;
        // padded columns: rate 0 and ratio 0, so rev = 0 and the count is 0
        const __nv_bfloat162 fg = fwd[nb][0], fh = fwd[nb][1];
        const float rev[4] = {
            col == x_g ? 0.f : __low2float(fg) * acc[nb][0],
            col + 1 == x_g ? 0.f : __high2float(fg) * acc[nb][1],
            col == x_h ? 0.f : __low2float(fh) * acc[nb][2],
            col + 1 == x_h ? 0.f : __high2float(fh) * acc[nb][3]};
        const float dg = (float)(col - x_g), dh = (float)(col - x_h);
        if (kMode == kExpected) {
          moved_g += rev[0] * dg;
          moved_g += rev[1] * (dg + 1.f);
          moved_h += rev[2] * dh;
          moved_h += rev[3] * (dh + 1.f);
          continue;
        }
        float uu[4] = {0.f, 0.f, 0.f, 0.f};
        if (kMode == kPoissonInjected) {
          const bool in0 = kFull || col < S, in1 = kFull || col + 1 < S;
          const float* ug = u + (size_t)rg * S + col;
          const float* uh = u + (size_t)rh * S + col;
          if (valid_g && in0) uu[0] = ug[0];
          if (valid_g && in1) uu[1] = ug[1];
          if (valid_h && in0) uu[2] = uh[0];
          if (valid_h && in1) uu[3] = uh[1];
        } else {
          const uint4 bits = philox4x32_10(
              make_uint4((uint32_t)rg, (uint32_t)col, 0u, 0u), key0, key1);
          uu[0] = to_unit(bits.x);
          uu[1] = to_unit(bits.y);
          uu[2] = to_unit(bits.z);
          uu[3] = to_unit(bits.w);
        }
        const float lam[4] = {rev[0] * h, rev[1] * h, rev[2] * h, rev[3] * h};
        const bool maybe = poisson_maybe_positive(uu[0], lam[0]) ||
                           poisson_maybe_positive(uu[1], lam[1]) ||
                           poisson_maybe_positive(uu[2], lam[2]) ||
                           poisson_maybe_positive(uu[3], lam[3]);
        // almost every entry counts 0 and adds nothing to the sums
        if (maybe) {
          const float4 n = poisson_inversion4(uu[0], uu[1], uu[2], uu[3],
                                              lam[0], lam[1], lam[2], lam[3]);
          total_g += n.x;
          moved_g += n.x * dg;
          total_g += n.y;
          moved_g += n.y * (dg + 1.f);
          total_h += n.z;
          moved_h += n.z * dh;
          total_h += n.w;
          moved_h += n.w * (dh + 1.f);
        }
      }
    }
    total_g = quad_sum(total_g);
    moved_g = quad_sum(moved_g);
    total_h = quad_sum(total_h);
    moved_h = quad_sum(moved_h);
    if (q == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? rh : rg;
        if (row >= rows) continue;
        const float total = i ? total_h : total_g;
        const float moved = i ? moved_h : moved_g;
        float jump;
        if (kMode == kExpected) {
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
  }
  cp_async_wait_all();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `qt0T` and `rateT`
// are the bf16 tables transposed and zero-padded to (Sp, Sp), Sp = S rounded
// up to 32. `stream` is a cudaStream_t; `seed` gives the Philox key words
// (low, high 32 bits).
extern "C" int fused_tau_leap_launch(const float* logits, const int* xg,
                                     const int* xb, const void* qt0T,
                                     const void* rateT, const float* u,
                                     int* out, int rows, int S, int Sp,
                                     float h, float eps,
                                     unsigned long long seed,
                                     int expected_mode, int is_ordinal,
                                     void* stream) {
  if (S < 2 || S > kMaxS || rows < 0 || Sp != ((S + 31) & ~31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t smem = (size_t)Sp * Sp * sizeof(__nv_bfloat16) +
                      (size_t)kRows * Sp * sizeof(float);
  const bool full = S == kMaxS;
  auto kernel =
      expected_mode
          ? (full ? fused_tau_leap_kernel<true, kExpected>
                  : fused_tau_leap_kernel<false, kExpected>)
          : u != nullptr
                ? (full ? fused_tau_leap_kernel<true, kPoissonInjected>
                        : fused_tau_leap_kernel<false, kPoissonInjected>)
                : (full ? fused_tau_leap_kernel<true, kPoissonPhilox>
                        : fused_tau_leap_kernel<false, kPoissonPhilox>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (rows + kRows - 1) / kRows;
  const int grid = tiles < sms ? tiles : sms;
  const int vec = (S % 4 == 0) && ((uintptr_t)logits % 16 == 0);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      logits, xg, xb, static_cast<const __nv_bfloat16*>(qt0T),
      static_cast<const __nv_bfloat16*>(rateT), u, out, rows, S, Sp, vec, h,
      eps, (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32),
      is_ordinal);
  return (int)cudaGetLastError();
}
