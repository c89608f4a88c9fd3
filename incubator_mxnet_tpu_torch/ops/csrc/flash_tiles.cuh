// Tiles and warp fragment products shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) on the tensor cores.
//
// A block of kWarps warps owns kRows rows of one (BH, T, d) operand, 16 per
// warp, and steps over tiles of another in shared memory.  Products:
//   * bf16 and f16: mma.sync m16n8k16, 16-bit tiles in shared memory,
//     fragments by ldmatrix (.trans for a row-major B operand);
//   * f32: the 3xTF32 split (mma_sm90.cuh) on m16n8k8; tf32 fragments load
//     with 32-bit shared loads (ldmatrix moves 16-bit elements).
// The accumulator of a 16 x N product (rows lane/4 and lane/4 + 8, columns
// 2*(lane%4) + {0, 1} of each 8-wide tile) becomes the A operand of the next
// product in place (product_cn): in 16 bits two tiles pack into one k16 step;
// in tf32 each tile is one k8 step whose k positions t and t + 4 are the
// columns 2t and 2t + 1, and the B operand is read in that order.
#pragma once
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: query rows (fwd, dQ), key rows (dK/dV)
constexpr int kKeyTile = 64;        // key rows per step of the forward and dQ kernels

// shared-memory row stride in elements: rows of 16-byte multiples, padded so
// that 8 rows read together fall in distinct banks
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}

// rows [row0, row0 + R) of a (seq, D) matrix into a tile of stride
// row_stride<T, D>, rows at or past `seq` as zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int seq) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kPer;     // chunks per row
  constexpr int LD = row_stride<T, D>();
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = row0 + r < seq;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// R values of a (seq,) f32 row statistic from row0, 0 at or past `seq`
template <int R>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int seq) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool ok = row0 + i < seq;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// ---- bf16 and f16 ---------------------------------------------------------------

// acc (16 x N) += A B^T: A the warp's 16 rows of a (., D) tile, B the N rows
// of another; the pattern of S = Q K^T.  H is bf16 or f16.
template <int D, int N, typename H>
__device__ __forceinline__ void product_nt16(float (&acc)[N / 8][4], const H* a, const H* b) {
  constexpr int LD = row_stride<H, D>();
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t af[4];  // 8x8 matrices: rows 0-7 / 8-15 x cols k0 / k0 + 8
    ldmatrix_x4(af, a + ((lm & 1) * 8 + lr) * LD + k0 + (lm >> 1) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];  // rows n0 / n0 + 8 x cols k0 / k0 + 8: b0, b1 of two n tiles
      ldmatrix_x4(bf, b + (n0 + (lm >> 1) * 8 + lr) * LD + k0 + (lm & 1) * 8);
      mma16(acc[n0 / 8], af, bf[0], bf[1], H());
      mma16(acc[n0 / 8 + 1], af, bf[2], bf[3], H());
    }
  }
}

template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4], const bf16* a,
                                           const bf16* b) {
  product_nt16<D, N>(acc, a, b);
}

template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4], const f16* a, const f16* b) {
  product_nt16<D, N>(acc, a, b);
}

// out (16 x D) += P B: P (16 x N) in accumulator layout, rounded to H here;
// B the N rows of a (., D) tile; the pattern of dQ = dS K and O = P V.
// kFold is the f32 overload's (below); in 16 bits one accumulator takes
// every k step, whose drift stays far below the rounding of the outputs.
template <int D, int N, typename H>
__device__ __forceinline__ void product_cn16(float (&out)[D / 8][4], const float (&p)[N / 8][4],
                                             const H* b) {
  constexpr int LD = row_stride<H, D>();
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack16(p[2 * kk][0], p[2 * kk][1], H());
    af[1] = pack16(p[2 * kk][2], p[2 * kk][3], H());
    af[2] = pack16(p[2 * kk + 1][0], p[2 * kk + 1][1], H());
    af[3] = pack16(p[2 * kk + 1][2], p[2 * kk + 1][3], H());
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t bf[4];  // rows kk*16 / + 8 x cols n0 / n0 + 8, transposed
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lm & 1) * 8 + lr) * LD + n0 + (lm >> 1) * 8);
      mma16(out[n0 / 8], af, bf[0], bf[1], H());
      mma16(out[n0 / 8 + 1], af, bf[2], bf[3], H());
    }
  }
}

template <int D, int N, bool kFold = false>
__device__ __forceinline__ void product_cn(float (&out)[D / 8][4], const float (&p)[N / 8][4],
                                           const bf16* b) {
  product_cn16<D, N>(out, p, b);
}

template <int D, int N, bool kFold = false>
__device__ __forceinline__ void product_cn(float (&out)[D / 8][4], const float (&p)[N / 8][4],
                                           const f16* b) {
  product_cn16<D, N>(out, p, b);
}

// ---- f32: 3xTF32 -----------------------------------------------------------------

// acc (16 x N) += A B^T (S = Q K^T, dP = dO V^T and their transposes).  The
// tensor cores round each mma's f32 sum toward zero, so an accumulator that
// takes all three products of every k step drifts toward zero by up to an ulp
// of itself per mma.  That drift is one-sided: it shifts every P = exp(S -
// lse) and dP of a row the same way, so the rows of P no longer sum to 1 and
// those of dS = P (dP - D) no longer to 0, and gradients that rest on that
// cancellation (the key projection's) lose it.  So big.big goes to acc and
// the two small terms, 2^-11 of it, to an accumulator of their own, where the
// drift is 2^-11 smaller; the two meet once, in an f32 add that rounds to
// nearest.
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4], const float* a,
                                           const float* b) {
  constexpr int LD = row_stride<float, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float lo[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    uint32_t ab[4], as[4];  // rows g, g + 8 x cols k0 + t, k0 + t + 4
    split(a[g * LD + k0 + t], ab[0], as[0]);
    split(a[(g + 8) * LD + k0 + t], ab[1], as[1]);
    split(a[g * LD + k0 + t + 4], ab[2], as[2]);
    split(a[(g + 8) * LD + k0 + t + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t bb0, bs0, bb1, bs1;  // B[k][n] = b[n][k]: n = j*8 + g, k = k0 + t, k0 + t + 4
      split(b[(j * 8 + g) * LD + k0 + t], bb0, bs0);
      split(b[(j * 8 + g) * LD + k0 + t + 4], bb1, bs1);
      mma_tf32(lo[j], as, bb0, bb1);
      mma_tf32(lo[j], ab, bs0, bs1);
      mma_tf32(acc[j], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
}

// kFold: each k8 step's three products go to a zeroed fragment that is then
// added to out with an ordinary f32 add (round to nearest).  An mma rounds
// its sum toward zero, by half an ulp of that sum on average, so an
// accumulator fed back into all 3 N / 8 mmas of every tile shrinks by about
// half an ulp of itself per mma, one way in every row: 3 T / 8 times over
// the forward's O.  The backward's D = rowsum(dO O) then no longer matches
// rowsum(P dP), and the query and key projections' gradients, which rest on
// that cancellation, moved by up to 8.9e-3 of their scale in a BERT-base
// step (chip_smoke.py's train phase, H100; TRAIN_TOL is 1e-3).  Folded, O
// shrinks by half an ulp once (tests/test_torch_kernels_emulated.py).
template <int D, int N, bool kFold = false>
__device__ __forceinline__ void product_cn(float (&out)[D / 8][4], const float (&p)[N / 8][4],
                                           const float* b) {
  constexpr int LD = row_stride<float, D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    // one k8 step per accumulator tile: k positions t and t + 4 are its
    // columns 2t and 2t + 1
    uint32_t ab[4], as[4];
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const float* brow = b + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split(brow[n * 8], bb0, bs0);
      split(brow[LD + n * 8], bb1, bs1);
      if (kFold) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(t, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] += t[e];
      } else {
        mma_3xtf32(out[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// ---- every dtype -------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

// (x, y) to two adjacent elements
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(f16* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// rows r and r + 8 of a (16 x D) accumulator to a (seq, D) matrix
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[D / 8][4],
                                           int r, int seq) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r < seq) store_pair(dst + (size_t)r * D + n * 8 + 2 * t, acc[n][0], acc[n][1]);
    if (r + 8 < seq) store_pair(dst + (size_t)(r + 8) * D + n * 8 + 2 * t, acc[n][2], acc[n][3]);
  }
}

// opts a kernel into more than the default 48 KB of dynamic shared memory
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

}  // namespace
