// float32 matrix products on the H100's tensor cores at float32 accuracy
// (3xTF32), for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves its dense products to XLA.
// It runs SDAR's dense products (ctdd_tpu_torch/ops/tf32x3_gemm.py): the
// head's forward and the gradients of the head and of the projections:
// C (M, N) = A (M, K) @ B (K, N), row-major C, where A is K-major (its rows
// hold K) or MN-major (stored as the (K, M) transpose), and so is B (stored
// as (N, K), K-major, or as (K, N), MN-major). A linear layer's forward
// x @ w.T takes both K-major, its input gradient g @ w a K-major A and an
// MN-major B, its weight gradient g.T @ x both MN-major: no transposed copy
// of w, g or x is made in device memory.
//
// Bound on the H100 SXM: the tensor cores' TF32 rate, 494.7 TFLOP/s dense,
// over the three TF32 products a float32 product takes here: 164.9 TFLOP/s
// at float32 accuracy (the CUDA cores' FFMA peak is 66.9). At SDAR's shapes
// (K = 2048 to 32768) every product is bound by its operations, not bytes.
//
// Design:
// - 3xTF32: every operand is split, hi = TF32 of v rounded to nearest
//   (cvt.rna.tf32.f32's rounding, as an integer add and mask) and lo = TF32
//   of (v - hi), and each k8 step accumulates lo*hi, then hi*lo, then hi*hi;
//   only lo*lo (2^-22 of the product) is dropped.
// - The tensor cores add into their float32 accumulator with truncation, so
//   its error grows with the sum's length (measured with one accumulator:
//   20x float32's at K = 2048, 160x at K = 32768, as bad as one TF32
//   product). So every kPromote tile steps (64 of K) the wgmmas start a
//   fresh sum, which the CUDA cores then add, rounded to nearest, into a
//   second set of registers: 0.4-1.1x cuBLAS float32's error at SDAR's
//   shapes (every step: 0.4-1.2x and ~4% slower; every four: up to 1.8x).
// - One persistent block a SM walks 128 x 160 output tiles (8 tiles of M
//   together, so their B tiles share L2). 384 threads: warp 0 of warpgroup
//   0 issues TMA loads of raw float32 tiles (A 128 x 32, B 160 x 32, 36 KB)
//   into a ring of 3 stages in shared memory (128-byte swizzle; an MN-major
//   operand as 32 x 32 boxes), ahead of the math and across tiles, so one
//   tile's epilogue overlaps the next one's loads; warpgroups 1 and 2 do
//   the math, 64 rows of the tile each (setmaxnreg moves registers to them:
//   two sets of 80 accumulators a thread; at 192 columns the transposed
//   forms spilled 228 bytes a thread and ran at 60 TFLOP/s).
// - tf32 wgmma reads both operands K-major. B goes through shared memory:
//   the two math warpgroups split each raw B tile into hi and lo tiles in
//   the K-major 128-byte-swizzled layout wgmma reads (the same offsets for a
//   K-major tile; a transpose for an MN-major one), two buffers deep, then
//   fence the async proxy. A goes through registers: each thread loads its
//   fragment of a k8 step from the raw tile (either major), splits it and
//   hands hi and lo to wgmma m64n160k8 as register operands, two k8 steps
//   deep, so the shared memory the tensor cores read is B alone (62.5 bytes
//   a clock at the TF32 rate, of 128).
// - A k8 step's three wgmmas are one commit group; the next k8 step's A
//   fragment is loaded and split while the group before it runs
//   (wgmma.wait_group 1), and the next tile step's B split and first A
//   fragment while the last group runs. One barrier of the math threads a
//   tile step makes the split visible and frees the buffer it replaces.
// - Ragged edges: TMA fills what lies outside the matrices with zeros (K
//   need not be a multiple of 32, nor M and N of the tile); the epilogue
//   stores only rows < M and columns < N, two columns a store (N % 4 == 0).
// - Each output is summed by one block in one order: a product repeats bit
//   for bit. No split-K: SDAR's outputs hold 416 to 15232 tiles (o's weight
//   gradient, 416 tiles of K = 32768, fills 3.15 waves of 132 blocks).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 160, kBK = 32;  // tile; kBK floats = 128 bytes
constexpr int kStages = 3;                     // raw tiles in flight
constexpr int kThreads = 384;                  // producer + two math warpgroups
constexpr int kMath = 256;                     // math threads
constexpr int kGroupM = 8;                     // tiles of M walked together
constexpr int kPromote = 2;                    // tile steps the tensor cores sum alone
constexpr int kABytes = kBM * kBK * 4;         // 16 KB
constexpr int kBBytes = kBN * kBK * 4;         // 20 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSplitBytes = 2 * kBBytes;       // B hi and lo
constexpr int kBarOffset = kStages * kStageBytes + 2 * kSplitBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A box of a 2-D tensor map (inner coordinate first) into shared memory;
// its bytes count on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void math_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMath) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Keeps the compiler from moving accesses of a register across wgmma's
// asynchronous reads and writes of it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Round to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32 for
// finite values).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The descriptor of a K-major operand under the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart; a k8 step starts 32 bytes on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte offset of (row, col) in a tile of 128-byte rows under the 128-byte
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)).
__device__ __forceinline__ uint32_t sw128(uint32_t row, uint32_t col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// Byte offset of element (r, k) of a raw operand tile whose rows r are
// outer: K-major, rows of 32 k; MN-major, boxes of 32 r (outer) x 32 k rows.
template <bool kKMajor>
__device__ __forceinline__ uint32_t raw_offset(uint32_t r, uint32_t k) {
  if (kKMajor) return sw128(r, k);
  return (r >> 5) * 4096 + sw128(k, r & 31);
}

// d (64 x kBN f32, the accumulator layout) = a (64 x 8 tf32, registers) *
// b (8 x kBN tf32, K-major in shared memory under the descriptor), plus d
// where `accumulate` is 1.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kBN / 2], const uint32_t* a, uint64_t desc,
                                           int accumulate) {
  static_assert(kBN == 160, "the operand list below is written for m64n160k8");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The origin of tile t: groups of kGroupM tile rows, walked column by column.
__device__ __forceinline__ void tile_origin(int t, int tm, int tn, int& m0, int& n0) {
  const int per_group = kGroupM * tn;
  const int first = (t / per_group) * kGroupM;
  const int size = min(tm - first, kGroupM);
  const int in = t % per_group;
  m0 = (first + in % size) * kBM;
  n0 = (in / size) * kBN;
}

// A thread's A fragment of k8 step kk of a raw tile, split: hi in f[0..3],
// lo in f[4..7] (rows r and r + 8, columns 8 kk + q and 8 kk + q + 4).
template <bool kKMajor>
__device__ __forceinline__ void load_a(uint32_t raw_a, int r, int q, int kk, uint32_t (&f)[8]) {
  const int c = 8 * kk + q;
  split(lds(raw_a + raw_offset<kKMajor>(r, c)), f[0], f[4]);
  split(lds(raw_a + raw_offset<kKMajor>(r + 8, c)), f[1], f[5]);
  split(lds(raw_a + raw_offset<kKMajor>(r, c + 4)), f[2], f[6]);
  split(lds(raw_a + raw_offset<kKMajor>(r + 8, c + 4)), f[3], f[7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) fence_operand(f[i]);
}

// The math threads' share of a raw B tile, split into hi and lo tiles in the
// K-major swizzled layout: 16-byte units of 4 k of one row.
template <bool kKMajor>
__device__ __forceinline__ void split_b(uint32_t raw_b, uint32_t hi, uint32_t lo, int mt) {
#pragma unroll
  for (int i = 0; i < kBN * kBK / 4 / kMath; ++i) {
    const int u = mt + kMath * i;
    float v[4];
    uint32_t off;
    if (kKMajor) {
      off = 16 * u;  // the raw tile is already in the K-major swizzled layout
      const float4 f = lds4(raw_b + off);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const int n = u % kBN, c = u / kBN;
      off = sw128(n, 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = lds(raw_b + raw_offset<false>(n, 4 * c + j));
    }
    uint4 vh, vl;
    split(v[0], vh.x, vl.x);
    split(v[1], vh.y, vl.y);
    split(v[2], vh.z, vl.z);
    split(v[3], vh.w, vl.w);
    sts4(hi + off, vh);
    sts4(lo + off, vl);
  }
  // wgmma reads the split tiles through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool kAKMajor, bool kBKMajor>
__global__ void __launch_bounds__(kThreads, 1)
    tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, float* __restrict__ C, int M,
                       int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + kBarOffset;     // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;  // empty[s] at empty + 8 s
  const int tm = (M + kBM - 1) / kBM, tn = (N + kBN - 1) / kBN, tiles = tm * tn;
  const int ksteps = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kMath);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring of raw tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, tm, tn, m0, n0);
        for (int k = 0; k < ksteps; ++k) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes);
          const uint32_t a = base + s * kStageBytes, b = a + kABytes;
          const int k0 = k * kBK;
          if (kAKMajor) {
            tma_load(a, &map_a, bar, k0, m0);
          } else {
#pragma unroll
            for (int j = 0; j < kBM / 32; ++j) tma_load(a + 4096 * j, &map_a, bar, m0 + 32 * j, k0);
          }
          if (kBKMajor) {
            tma_load(b, &map_b, bar, k0, n0);
          } else {
#pragma unroll
            for (int j = 0; j < kBN / 32; ++j) tma_load(b + 4096 * j, &map_b, bar, n0 + 32 * j, k0);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the math: warpgroup mw (0, 1) owns rows [64 mw, 64 mw + 64) of a tile;
  // the whole sequence of (tile, tile step) pairs of this block is one loop,
  // as the producer walks it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int mt = threadIdx.x - 128;
  const int mw = mt >> 7, warp = (mt >> 5) & 3, lane = mt & 31;
  const int r = 64 * mw + 16 * warp + (lane >> 2), q = lane & 3;
  const uint32_t split_base = base + kStages * kStageBytes;
  const int steps = (blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * ksteps;
  if (steps == 0) return;

  float acc[kBN / 2];  // the tensor cores' sum of kPromote tile steps
  float sum[kBN / 2];  // the tile's sum, rounded to nearest
  uint32_t frag[2][8];  // A fragments of two k8 steps

  // the first tile step's B split and first A fragment
  mbar_wait(full, 0);
  split_b<kBKMajor>(base + kABytes, split_base, split_base + kBBytes, mt);
  load_a<kAKMajor>(base, r, q, 0, frag[0]);
  math_barrier();

  int s = 0, kstep = 0, t = blockIdx.x;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    const uint32_t raw_a = base + s * kStageBytes;
    const uint32_t hi = split_base + (it & 1) * kSplitBytes, lo = hi + kBBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t(&f)[8] = frag[kk & 1];
      if (kk > 0) {
        wgmma_wait<1>();  // the group that read these registers is done
        load_a<kAKMajor>(raw_a, r, q, kk, f);
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
      const uint64_t dh = sw128_desc(hi + 32 * kk), dl = sw128_desc(lo + 32 * kk);
      // lo * hi (starting a new sum every kPromote tile steps), hi * lo, hi * hi
      wgmma_tf32(acc, f + 4, dh, kk > 0 || kstep % kPromote);
      wgmma_tf32(acc, f, dl, 1);
      wgmma_tf32(acc, f, dh, 1);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
    }
    int s_next = s + 1;
    uint32_t phase_next = phase;
    if (s_next == kStages) {
      s_next = 0;
      phase_next ^= 1;
    }
    if (it + 1 < steps) {
      // the next tile step's B split and first A fragment, while this one's
      // last group runs (its buffer was read two tile steps back)
      const uint32_t raw_next = base + s_next * kStageBytes;
      const uint32_t hi_next = split_base + ((it + 1) & 1) * kSplitBytes;
      mbar_wait(full + 8 * s_next, phase_next);
      split_b<kBKMajor>(raw_next + kABytes, hi_next, hi_next + kBBytes, mt);
      wgmma_wait<1>();
      load_a<kAKMajor>(raw_next, r, q, 0, frag[0]);
    }
    mbar_arrive(empty + 8 * s);  // this thread is done with the raw tile
    s = s_next;
    phase = phase_next;
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
    if ((kstep + 1) % kPromote == 0 || kstep + 1 == ksteps) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] = kstep < kPromote ? acc[i] : sum[i] + acc[i];
    }
    if (++kstep == ksteps) {
      int m0, n0;
      tile_origin(t, tm, tn, m0, n0);
      const int row = m0 + r;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (col < N) {
          if (row < M)
            *reinterpret_cast<float2*>(C + static_cast<size_t>(row) * N + col) =
                make_float2(sum[4 * j], sum[4 * j + 1]);
          if (row + 8 < M)
            *reinterpret_cast<float2*>(C + static_cast<size_t>(row + 8) * N + col) =
                make_float2(sum[4 * j + 2], sum[4 * j + 3]);
        }
      }
      kstep = 0;
      t += gridDim.x;
    }
    // the next split is visible, and both warpgroups are done with this one
    math_barrier();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (rows, cols) row-major matrix of `pitch` floats a row, read
// in boxes of 32 columns (128 bytes, swizzled) x `box_rows` rows; what lies
// outside reads as zeros.
int make_map(CUtensorMap* map, const float* ptr, int rows, int cols, int pitch, int box_rows) {
  EncodeTiled encode = encoder();
  if (!encode) return 901;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

template <bool kAKMajor, bool kBKMajor>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, float* C, int M, int N, int K,
           cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(tf32x3_gemm_kernel<kAKMajor, kBKMajor>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  tf32x3_gemm_kernel<kAKMajor, kBKMajor>
      <<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (M, N) = A @ B at float32 accuracy. a_rows: A is stored (M, K) row-major
// (else as its (K, M) transpose); b_rows: B is stored (K, N) row-major (else
// as its (N, K) transpose); a linear layer's three products need every pair
// but a transposed A with a transposed B, which is not built. Row pitches are the stored rows' lengths; all
// pitches and pointers whole 16-byte units, N % 4 == 0. Returns 0 or a CUDA
// error (1000 + a driver error where a tensor map was refused).
extern "C" int tf32x3_gemm_launch(const float* A, const float* B, float* C, int M, int N, int K,
                                  int a_rows, int b_rows, void* stream) {
  CUtensorMap map_a, map_b;
  const bool a_k = a_rows != 0, b_k = b_rows == 0;
  int err = a_k ? make_map(&map_a, A, M, K, K, kBM) : make_map(&map_a, A, K, M, M, 32);
  if (err) return err;
  err = b_k ? make_map(&map_b, B, N, K, K, kBN) : make_map(&map_b, B, K, N, N, 32);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_k && b_k) return launch<true, true>(map_a, map_b, C, M, N, K, s);
  if (a_k) return launch<true, false>(map_a, map_b, C, M, N, K, s);
  if (!b_k) return launch<false, false>(map_a, map_b, C, M, N, K, s);
  return static_cast<int>(cudaErrorNotSupported);  // MN-major A with K-major B: not built
}
