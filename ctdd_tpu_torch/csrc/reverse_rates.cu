// Reverse rates of the p0t path for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ctdd_tpu/ops/pallas_kernels.py::_rev_rates_kernel
// (reached through reverse_rates_pallas, pallas_call at pallas_kernels.py:81).
// Per row r = (n, d) of the (N, D, S) inputs it computes, at float32 accuracy,
//
//   p      = softmax(logits[r])
//   a      = p / qt0_cols[r]                  qt0_cols already holds + eps
//   ratio  = a @ qt0[n]
//   out[r] = rate_cols[r] * ratio, and exactly 0 at x[r]
//
// `qt0` is one (S, S) table per sample; `qt0_stride` is the distance between
// two samples' tables in floats, 0 when the whole batch shares one table.
// x is read as int32 (no one-hot input) and the ragged last tile of D is
// masked in the kernel (no padding of the inputs).
//
// Bound on the H100 (3.35 TB/s HBM, 495 TFLOP/s TF32 dense). The product
// keeps f32 accuracy on the tensor cores as three TF32 MMAs (below), 3 * 2 *
// N * D * S * S operations. At N = 16, D = 784, S = 256 that is 4.9 GFLOP,
// ~10 us, against 51.6 MB (three f32 inputs, one output, x, the table),
// ~15.4 us: the function is bound by bytes (N = 256: 822 MB, ~245 us).
//
// Design:
// - A block takes 64 rows of ONE sample, so all its rows use one table and
//   per-sample tables need no copies; two blocks fit on an SM (100,608 bytes
//   of shared memory each, <= 128 registers), so one block's loads and
//   softmax overlap the other's product. The table is re-read from L2 once
//   per block: 256 KB per 64 rows, as many bytes as the HBM traffic of those
//   rows (four f32 arrays of 64 KB).
// - Phase 1, one warp per row, 16-byte loads: softmax and the division; `a`
//   goes to a (64, S) f32 tile in shared memory, row pitch 260 floats so the
//   A-fragment reads (row = lane / 4, k = lane % 4) hit 32 banks.
// - Phase 2: the table streams through a 2-slot cp.async ring of 16-row slabs
//   (two k8 steps each; the next slab, 16 KB, is in flight while this one is
//   multiplied), row pitch 264 floats so the B-fragment reads (k = lane % 4,
//   n = lane / 4) hit 32 banks. 8 warps as 2 x 4: a warp owns 32 rows x 64
//   columns, 64 f32 accumulators. One block-wide barrier per slab.
// - 3xTF32: every operand is split in registers, big = tf32(v), small =
//   tf32(v - big), and each k8 step accumulates small*big + big*small, then
//   big*big (mma.sync.aligned.m16n8k8 tf32, f32 accumulate). Only the
//   small*small term (2^-22 relative) is dropped. The rounding to TF32 is
//   cvt.rna's (nearest, ties away) written as an integer add and mask.
// - Phase 3: the accumulators go back through the tile, then one warp per row
//   multiplies by rate_cols, writes a literal 0 at x and stores 16 bytes per
//   lane.
// - Any S in [2, 256], any D. The columns are padded with zeros to a multiple
//   of 8 and K to whole slabs inside shared memory; warps whose columns lie
//   past S idle in phase 2. Rows that are not whole 16-byte chunks
//   (S % 4 != 0, or a table with S % 16 != 0) take plain loads.
// - ptxas -v (CUDA 12.8, sm_90a): 128 registers (the cap for two blocks of
//   256 threads per SM), at most 24 bytes spilled, no static shared memory;
//   100,608 bytes dynamic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;            // rows of one sample per block
constexpr int kMaxS = 256;
constexpr int kAPitch = kMaxS + 4;   // floats per row of the `a` tile
constexpr int kBPitch = kMaxS + 8;   // floats per row of a table slab
constexpr int kSlabK = 16;           // table rows per slab: two k8 steps
constexpr int kStages = 2;           // slabs in the ring
constexpr int kWarpCols = 64;        // a warp's columns: 8 n8 blocks
constexpr int kColWarps = kMaxS / kWarpCols;
constexpr int kPerLane = kMaxS / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // phases 1 and 3
constexpr int kBatch = 4;            // rows a warp loads together
static_assert(kRowsPerWarp % kBatch == 0, "whole batches");
static_assert(kWarps == 2 * kColWarps && kRows == 64, "2 x 4 warps of 32 x 64");

constexpr size_t kSmemBytes =
    sizeof(float) * (kRows * kAPitch + kStages * kSlabK * kBPitch) +
    sizeof(int) * kRows;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for finite values, as two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small + O(2^-22 |v|), both representable in TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's 8 entries of a row: columns 128 j + 4 lane + i, so a group of four
// is one 16-byte access when the row allows it (`vec`).
__device__ __forceinline__ void load_row(const float* __restrict__ p, int S,
                                         int lane, bool vec, float fill,
                                         float (&v)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane / 4; ++j) {
    const int c = 128 * j + 4 * lane;
    if (vec && c + 3 < S) {
      const float4 f = *reinterpret_cast<const float4*>(p + c);
      v[4 * j + 0] = f.x;
      v[4 * j + 1] = f.y;
      v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * j + i] = c + i < S ? p[c + i] : fill;
    }
  }
}

// Slab `sl` (table rows kSlabK sl .. + kSlabK - 1) into its ring slot; rows and
// columns past S are zero. Always commits a group, so the ring's accounting
// does not depend on how many slabs are left.
__device__ __forceinline__ void load_slab(float* slabs,
                                          const float* __restrict__ q, int sl,
                                          int nslabs, int S, int Sp, int tid,
                                          bool tabvec) {
  if (sl < nslabs) {
    float* dst = slabs + (sl % kStages) * kSlabK * kBPitch;
    const int k0 = sl * kSlabK;
    if (tabvec) {  // S % kSlabK == 0: whole slabs, whole 16-byte chunks
      const int per_row = S >> 2;
      for (int i = tid; i < kSlabK * per_row; i += kThreads) {
        const int r = i / per_row, c = i - r * per_row;
        cp_async16(dst + r * kBPitch + 4 * c,
                   q + (size_t)(k0 + r) * S + 4 * c);
      }
    } else {
      for (int i = tid; i < kSlabK * Sp; i += kThreads) {
        const int r = i / Sp, c = i - r * Sp;
        dst[r * kBPitch + c] =
            (k0 + r < S && c < S) ? q[(size_t)(k0 + r) * S + c] : 0.f;
      }
    }
  }
  cp_async_commit();
}

// kFull: S == 256; the column blocks of a warp are then all live and the
// product is straight-line code.
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
reverse_rates_kernel(const float* __restrict__ logits,
                     const float* __restrict__ qcols,
                     const float* __restrict__ qt0,
                     const float* __restrict__ rcols,
                     const int* __restrict__ x, float* __restrict__ out,
                     int D, int S, int tiles_per_sample, long long qt0_stride,
                     int vec_flag, int tabvec_flag) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_tile = reinterpret_cast<float*>(smem);   // kRows x kAPitch
  float* slabs = a_tile + kRows * kAPitch;  // kStages x kSlabK x kBPitch
  int* x_tile = reinterpret_cast<int*>(slabs + kStages * kSlabK * kBPitch);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x / tiles_per_sample;
  const int d0 = (blockIdx.x % tiles_per_sample) * kRows;
  const int Sp = (S + 7) & ~7;
  const int nslabs = (Sp + kSlabK - 1) / kSlabK;
  const int Kp = nslabs * kSlabK;  // K as the slabs cover it
  const bool vec = vec_flag != 0, tabvec = tabvec_flag != 0;
  const float* q = qt0 + (size_t)n * qt0_stride;

  for (int sl = 0; sl < kStages - 1; ++sl)
    load_slab(slabs, q, sl, nslabs, S, Sp, tid, tabvec);

  // 1. a = softmax(logits) / qt0_cols, one warp per row; a warp asks for
  //    kBatch rows at once so their loads are in flight together
  for (int rb = warp * kRowsPerWarp; rb < (warp + 1) * kRowsPerWarp;
       rb += kBatch) {
    float e[kBatch][kPerLane], qc[kBatch][kPerLane];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int d = d0 + rb + b;
      if (d < D) {
        const size_t base = ((size_t)n * D + d) * S;
        load_row(logits + base, S, lane, vec, -INFINITY, e[b]);
        load_row(qcols + base, S, lane, vec, 1.f, qc[b]);
        if (lane == 0) x_tile[rb + b] = x[(size_t)n * D + d];
      } else if (lane == 0) {
        x_tile[rb + b] = -1;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (d0 + rb + b < D) {
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) m = fmaxf(m, e[b][i]);
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          e[b][i] = expf(e[b][i] - m);  // exp(-inf) = 0 past S
          sum += e[b][i];
        }
        const float inv_sum = 1.f / warp_sum(sum);  // one division per row
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          e[b][i] = (e[b][i] * inv_sum) / qc[b][i];
      } else {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) e[b][i] = 0.f;
      }
      float* a_row = a_tile + (rb + b) * kAPitch;
#pragma unroll
      for (int j = 0; j < kPerLane / 4; ++j) {
        const int c = 128 * j + 4 * lane;
        if (c < Kp)  // Kp % 4 == 0: whole groups; zeros past S
          *reinterpret_cast<float4*>(a_row + c) = make_float4(
              e[b][4 * j], e[b][4 * j + 1], e[b][4 * j + 2], e[b][4 * j + 3]);
      }
    }
  }

  // 2. ratio = a @ qt0[n] as 3xTF32; warp (wr, wc) owns rows 32 wr .. + 31,
  //    columns 64 wc .. + 63
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int col0 = wc * kWarpCols;
  int nblk = (Sp - col0) / 8;
  nblk = kFull ? 8 : (nblk < 0 ? 0 : (nblk > 8 ? 8 : nblk));
  float acc[2][8][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      acc[mb][nb][0] = acc[mb][nb][1] = acc[mb][nb][2] = acc[mb][nb][3] = 0.f;

  for (int sl = 0; sl < nslabs; ++sl) {
    cp_async_wait<kStages - 2>();  // slab sl has landed
    __syncthreads();               // ... for everyone; slab sl - 1 is consumed
    load_slab(slabs, q, sl + kStages - 1, nslabs, S, Sp, tid, tabvec);
    if (nblk == 0) continue;
#pragma unroll
    for (int kk = 0; kk < kSlabK / 8; ++kk) {  // the slab's k8 steps
      const float* a_frag =
          a_tile + (32 * wr + g) * kAPitch + kSlabK * sl + 8 * kk + t4;
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const float* p = a_frag + 16 * mb * kAPitch;
        split_tf32(p[0], a_big[mb][0], a_small[mb][0]);
        split_tf32(p[8 * kAPitch], a_big[mb][1], a_small[mb][1]);
        split_tf32(p[4], a_big[mb][2], a_small[mb][2]);
        split_tf32(p[8 * kAPitch + 4], a_big[mb][3], a_small[mb][3]);
      }
      const float* b_frag = slabs + (sl % kStages) * kSlabK * kBPitch +
                            (8 * kk + t4) * kBPitch + col0 + g;
      // four column blocks at a time: each of the three rounds issues 8 MMAs
      // into 8 different accumulators, so no MMA waits for the one before it
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {
        uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nb = 4 * nq + j;
          const bool live = kFull || nb < nblk;
          split_tf32(live ? b_frag[8 * nb] : 0.f, b_big[j][0], b_small[j][0]);
          split_tf32(live ? b_frag[4 * kBPitch + 8 * nb] : 0.f, b_big[j][1],
                     b_small[j][1]);
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[mb][4 * nq + j], a_small[mb], b_big[j][0],
                     b_big[j][1]);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[mb][4 * nq + j], a_big[mb], b_small[j][0],
                     b_small[j][1]);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_tf32(acc[mb][4 * nq + j], a_big[mb], b_big[j][0], b_big[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done reading `a`

  // 3. the ratio goes back through the tile; out = rate_cols * ratio, 0 at x
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      if (nb < nblk) {
        float* p = a_tile + (32 * wr + 16 * mb + g) * kAPitch + col0 + 8 * nb +
                   2 * t4;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mb][nb][0], acc[mb][nb][1]);
        *reinterpret_cast<float2*>(p + 8 * kAPitch) =
            make_float2(acc[mb][nb][2], acc[mb][nb][3]);
      }
  __syncthreads();
  for (int rb = warp * kRowsPerWarp; rb < (warp + 1) * kRowsPerWarp;
       rb += kBatch) {
    float rc[kBatch][kPerLane];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (d0 + rb + b < D)
        load_row(rcols + ((size_t)n * D + d0 + rb + b) * S, S, lane, vec, 0.f,
                 rc[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int d = d0 + rb + b;
      if (d >= D) continue;
      const size_t base = ((size_t)n * D + d) * S;
      const float* ratio = a_tile + (rb + b) * kAPitch;
      const int xr = x_tile[rb + b];
#pragma unroll
      for (int j = 0; j < kPerLane / 4; ++j) {
        const int c = 128 * j + 4 * lane;
        if (c >= S) continue;
        const float4 rt = *reinterpret_cast<const float4*>(ratio + c);
        float o[4] = {rc[b][4 * j] * rt.x, rc[b][4 * j + 1] * rt.y,
                      rc[b][4 * j + 2] * rt.z, rc[b][4 * j + 3] * rt.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i == xr) o[i] = 0.f;
        if (vec && c + 3 < S) {
          *reinterpret_cast<float4*>(out + base + c) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < S) out[base + c + i] = o[i];
        }
      }
    }
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
  auto kernel =
      S == kMaxS ? reverse_rates_kernel<true> : reverse_rates_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t rows_or = (uintptr_t)logits | (uintptr_t)qcols |
                            (uintptr_t)rcols | (uintptr_t)out;
  const int vec = (S % 4 == 0) && (rows_or % 16 == 0);
  const int tabvec = (S % kSlabK == 0) && ((uintptr_t)qt0 % 16 == 0);
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      logits, qcols, qt0, rcols, x, out, D, S, tiles_per_sample, qt0_stride,
      vec, tabvec);
  return (int)cudaGetLastError();
}
