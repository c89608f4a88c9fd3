// Flash-attention backward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernels `_dq_kernel` (incubator_mxnet_tpu/ops/
// attention.py:232) and `_dkv_kernel` (:278), launched by `_flash_bwd_pallas`.
// From the forward's residuals (q, k, v, out and lse = m + log l per query row)
// and the output gradient dO it computes, with P = exp(S - lse),
// S = q k^T * scale:
//   D  = rowsum(dO * O)                         per query row, f32
//   dP = dO V^T,   dS = P * (dP - D) * scale
//   dQ = dS K,     dK = dS^T Q,     dV = P^T dO
// for q, k, v, out, dO of shape (BH, T, d), row-major and contiguous, in f32 or
// bf16.  Scores, P, dP, dS and the accumulators are f32.  In bf16 the kernels
// round where the TPU kernels cast: P to dO's dtype before dV, dS to k's dtype
// before dQ and to q's dtype before dK.
//
// Bounds at the BERT-base training shape (BH = 8*12, T = 512, d = 64): the dQ
// kernel does 6*BH*T^2*d = 9.7 GFLOP (S, dP, dQ) and the dK/dV kernel
// 8*BH*T^2*d = 12.9 GFLOP (S, dP, dV, dK).  f32-accurate products have two
// routes on an H100 SXM: the 3xTF32 split below on the tensor cores
// (495 / 3 = 165 TFLOP/s: 0.059 ms and 0.078 ms) and scalar FMAs on the CUDA
// cores (67 TFLOP/s: 0.144 ms and 0.192 ms); the faster route bounds f32.  In
// bf16 (989 TFLOP/s) the dQ kernel is bound by its bytes (q, k, v, dO, O, lse
// in; dQ, D out: 0.011 ms at 3.35 TB/s) and the dK/dV kernel by operations
// (0.013 ms).
//
// Design, the TPU's two-kernel split:
//   * dQ kernel: grid (BH, ceil(T / 64)); a block of 4 warps owns 64 query
//     rows, 16 per warp, and loops over key tiles of 64 rows (the TPU's
//     sequential k axis).  Per tile each warp computes S = Q K^T and
//     dP = dO V^T (16 x 64 each, in mma accumulators), turns them into dS in
//     registers and accumulates dQ += dS K (16 x d).  It first writes
//     D = rowsum(dO * O) of its rows to a (BH, T) f32 scratch that the
//     wrapper allocates.
//   * dK/dV kernel: grid (BH, ceil(T / 64)); a block owns 64 key rows, 16 per
//     warp, and loops over query tiles of 64 rows (32 at d = 128).  It works
//     on S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are already in the
//     warp's registers in the layout of an mma A operand, and accumulates
//     dV += P^T dO and dK += dS^T Q.  lse and D of the query tile come from
//     device memory (D from the dQ kernel, which runs first on the same
//     stream, so D is not recomputed per tile as the TPU kernel does).
//   * Every output element has one owner: no atomics, and the result is the
//     same bits from launch to launch.
//   * Products: mma.sync on the tensor cores.  bf16 runs m16n8k16 with bf16
//     operands and f32 accumulators; tiles stay bf16 in shared memory and
//     fragments load with ldmatrix (.trans for the row-major B operands K, dO
//     and Q of dQ, dV and dK).  f32 runs the 3xTF32 split on m16n8k8.tf32:
//     a = big + small with big = a rounded to tf32 and small = a - big, read
//     as tf32 (truncated) by the mma, a.b ~ big.big + big.small + small.big,
//     the route of CUTLASS's OpMultiplyAddFastF32; the dropped small.small
//     term and the truncation of small are near 2^-21 of each product, well
//     inside f32 parity.  The mma rounds its f32 sum toward zero (9 sums in
//     10 on the card), so in the S and dP products the small terms keep an
//     accumulator of their own (see product_nt).  With one accumulator the
//     worst gradient of a BERT-base batch-1 step against its CPU copy read
//     7.4e-4 and 1.0e-3 of its scale on two inputs, with two 4.9e-4 and
//     7.1e-4, with the plain backward 4.3e-4 and 5.9e-4
//     (bwd_precision_study.py, H100 80GB HBM3, 700 W).  The split is
//     integer and f32 arithmetic, not cvt.rna.tf32.f32: with conversions
//     the f32 kernels ran at 3.6x (dQ) and 4.1x (dK/dV) their bf16 time at
//     the BERT shape (chip_smoke.py, H100 80GB HBM3, 700 W).  tf32 fragments
//     load with 32-bit shared loads (ldmatrix moves 16-bit elements).  The
//     accumulator of S^T or dS (rows lane/4 and lane/4 + 8, columns
//     2*(lane%4) + {0, 1} of each 8-wide tile) becomes the A operand of the
//     next product in place: in bf16 two tiles pack into one k16 step; in
//     tf32 each tile is one k8 step whose k positions t and t + 4 are the
//     columns 2t and 2t + 1, and the B operand is read in that order.
//   * Loads: cp.async, 16 bytes per thread, with the next K/V tile (dQ) or
//     Q/dO tile (dK/dV) in flight during the current tile's products (two
//     buffers).  Rows are padded (4 floats, 8 bf16) so that fragment loads
//     hit distinct banks.  Shared memory per block: dQ 104 KB (f32) / 55 KB
//     (bf16) at d = 64, so at least 2 blocks per SM at d <= 64; 203 KB for
//     f32 dQ at d = 128, above the 48 KB default and so opted into.
//   * The ragged last tile (any T) is masked: rows past T load as zeros and
//     are never written, and their P is 0.  Causal: the dQ kernel stops at the
//     key tile that holds its last row, the dK/dV kernel starts at the query
//     tile that holds its first key row (the tiles the TPU kernels skip), and
//     the diagonal tile is masked element by element.
// What it leaves for later: wgmma and TMA (mma.sync reaches only part of the
// tensor cores' rate on Hopper), warp specialisation, a fused single-pass
// backward, and pre-split tf32 tiles (each warp splits the operands it reads).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: query rows (dQ), key rows (dK/dV)
constexpr int kKeyTile = 64;        // key rows per step of the dQ kernel

// query rows per step of the dK/dV kernel: 32 at d = 128 keeps the dK and dV
// accumulators (d/2 floats each per thread) and S^T, dP^T in registers
template <int D> __host__ __device__ constexpr int query_tile() { return D == 128 ? 32 : 64; }

// shared-memory row stride in elements: rows of 16-byte multiples, padded so
// that 8 rows read together fall in distinct banks
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or 0.f when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// ---- bf16: mma.sync m16n8k16, fragments by ldmatrix ------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to bf16 (nearest even, as astype does), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// acc (16 x N) += A B^T: A the warp's 16 rows of a (., D) tile, B the N rows
// of another; the pattern of S = Q K^T
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4], const bf16* a,
                                           const bf16* b) {
  constexpr int LD = row_stride<bf16, D>();
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t af[4];  // 8x8 matrices: rows 0-7 / 8-15 x cols k0 / k0 + 8
    ldmatrix_x4(af, a + ((lm & 1) * 8 + lr) * LD + k0 + (lm >> 1) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];  // rows n0 / n0 + 8 x cols k0 / k0 + 8: b0, b1 of two n tiles
      ldmatrix_x4(bf, b + (n0 + (lm >> 1) * 8 + lr) * LD + k0 + (lm & 1) * 8);
      mma_bf16(acc[n0 / 8], af, bf[0], bf[1]);
      mma_bf16(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 x D) += P B: P (16 x N) in accumulator layout, rounded to bf16 here;
// B the N rows of a (., D) tile; the pattern of dQ = dS K
template <int D, int N>
__device__ __forceinline__ void product_cn(float (&out)[D / 8][4], const float (&p)[N / 8][4],
                                           const bf16* b) {
  constexpr int LD = row_stride<bf16, D>();
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    af[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    af[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    af[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t bf[4];  // rows kk*16 / + 8 x cols n0 / n0 + 8, transposed
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lm & 1) * 8 + lr) * LD + n0 + (lm >> 1) * 8);
      mma_bf16(out[n0 / 8], af, bf[0], bf[1]);
      mma_bf16(out[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// ---- f32: 3xTF32 on mma.sync m16n8k8 ---------------------------------------

// x = big + small.  big is x rounded to tf32 (nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds) by two integer ops: add half a tf32 ulp, clear
// the 13 low bits.  small = x - big is exact in f32 and goes to the mma as it
// is: a tf32 operand is read from its top 19 bits, so small is truncated to
// tf32 there.  No conversion instruction: those run at a fraction of the
// integer and f32 rate, and three of them per operand pair bounded the f32
// kernels.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the two small terms first, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

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

template <int D, int N>
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
      mma_3xtf32(out[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// ---- both dtypes ------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// (x, y) to two adjacent elements
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO (kRows rows), two K and two V tiles (kKeyTile rows), D of the rows
  return sizeof(T) * (size_t)row_stride<T, D>() * (2 * kRows + 4 * kKeyTile) +
         sizeof(float) * kRows;
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // K, V (kRows rows), two Q and two dO tiles, two lse and two D vectors
  return sizeof(T) * (size_t)row_stride<T, D>() * (2 * kRows + 4 * query_tile<D>()) +
         sizeof(float) * 4 * query_tile<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int seq, float scale, int causal) {
  constexpr int LD = row_stride<T, D>();
  constexpr int N = kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // kRows x LD
  T* dos = qs + kRows * LD;            // kRows x LD
  T* ks = dos + kRows * LD;            // 2 x N x LD
  T* vs = ks + 2 * N * LD;             // 2 x N x LD
  float* dels = reinterpret_cast<float*>(vs + 2 * N * LD);  // kRows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * kRows;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t rbase = (size_t)blockIdx.x * seq;
  const int kend = causal ? min(seq, q0 + kRows) : seq;
  const int tiles = (kend + N - 1) / N;

  load_tile<T, D, kRows>(qs, q + base, q0, seq);
  load_tile<T, D, kRows>(dos, dout + base, q0, seq);
  load_tile<T, D, N>(ks, k + base, 0, seq);
  load_tile<T, D, N>(vs, v + base, 0, seq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // D = rowsum(dO * O): two threads per row, half the columns each
  {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    const int row = q0 + r;
    float part = 0.f;
    if (row < seq) {
      const T* orow = o + base + (size_t)row * D;
#pragma unroll 8
      for (int c = c0; c < c0 + D / 2; ++c) part = fmaf(to_f32(dos[r * LD + c]), to_f32(orow[c]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((threadIdx.x & 1) == 0) {
      dels[r] = part;
      if (row < seq) delta[rbase + row] = part;
    }
  }
  __syncthreads();

  // this thread's rows of S, dP and dQ: r_a and r_a + 8
  const int ra = warp * 16 + (lane >> 2);
  const int row_a = q0 + ra, row_b = row_a + 8;
  const float lse_a = row_a < seq ? lse[rbase + row_a] : 0.f;
  const float lse_b = row_b < seq ? lse[rbase + row_b] : 0.f;
  const float del_a = dels[ra], del_b = dels[ra + 8];
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;
  const int tq = 2 * (lane & 3);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {  // the next K/V tile loads during this one's products
      load_tile<T, D, N>(ks + (buf ^ 1) * N * LD, k + base, (it + 1) * N, seq);
      load_tile<T, D, N>(vs + (buf ^ 1) * N * LD, v + base, (it + 1) * N, seq);
      cp_async_commit();
    }
    const T* kt = ks + buf * N * LD;
    const T* vt = vs + buf * N * LD;
    const int k0 = it * N;

    float s[N / 8][4], dp[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    product_nt<D, N>(s, qw, kt);
    product_nt<D, N>(dp, dow, vt);

    // dS = P (dP - D) scale in place of dP; rounded to k's dtype in product_cn
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int col = k0 + j * 8 + tq + (e & 1);
        const bool ok = row < seq && col < seq && (!causal || col <= row);
        const float p = ok ? expf(s[j][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? del_a : del_b)) * scale;
      }
    product_cn<D, N>(acc, dp, kt);

    if (it + 1 < tiles) cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one's buffers are free
  }
  store_rows<T, D>(dq + base, acc, row_a, seq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int seq, float scale, int causal) {
  constexpr int LD = row_stride<T, D>();
  constexpr int N = query_tile<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // kRows x LD
  T* vs = ks + kRows * LD;             // kRows x LD
  T* qs = vs + kRows * LD;             // 2 x N x LD
  T* dos = qs + 2 * N * LD;            // 2 x N x LD
  float* lses = reinterpret_cast<float*>(dos + 2 * N * LD);  // 2 x N
  float* dels = lses + 2 * N;                                // 2 x N

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.y * kRows;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t rbase = (size_t)blockIdx.x * seq;
  // causal: query tiles wholly above this block's first key row are skipped
  const int qstart = causal ? k0 : 0;
  const int tiles = (seq - qstart + N - 1) / N;

  load_tile<T, D, kRows>(ks, k + base, k0, seq);
  load_tile<T, D, kRows>(vs, v + base, k0, seq);
  load_tile<T, D, N>(qs, q + base, qstart, seq);
  load_tile<T, D, N>(dos, dout + base, qstart, seq);
  load_rows<N>(lses, lse + rbase, qstart, seq);
  load_rows<N>(dels, delta + rbase, qstart, seq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's key rows of S^T, dK and dV: row_a and row_a + 8
  const int row_a = k0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;
  const int tq = 2 * (lane & 3);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    const int qt0 = qstart + it * N;
    if (it + 1 < tiles) {  // the next Q/dO tile loads during this one's products
      load_tile<T, D, N>(qs + (buf ^ 1) * N * LD, q + base, qt0 + N, seq);
      load_tile<T, D, N>(dos + (buf ^ 1) * N * LD, dout + base, qt0 + N, seq);
      load_rows<N>(lses + (buf ^ 1) * N, lse + rbase, qt0 + N, seq);
      load_rows<N>(dels + (buf ^ 1) * N, delta + rbase, qt0 + N, seq);
      cp_async_commit();
    }
    const T* qt = qs + buf * N * LD;
    const T* dot = dos + buf * N * LD;
    const float* lt = lses + buf * N;
    const float* dt = dels + buf * N;

    // P^T = exp(S^T scale - lse) in place of S^T
    float pt[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[j][e] = 0.f;
    product_nt<D, N>(pt, kw, qt);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int krow = e < 2 ? row_a : row_b;
        const int qc = j * 8 + tq + (e & 1);
        const int qcol = qt0 + qc;
        const bool ok = krow < seq && qcol < seq && (!causal || krow <= qcol);
        pt[j][e] = ok ? expf(pt[j][e] * scale - lt[qc]) : 0.f;
      }
    // dV += P^T dO, P rounded to dO's dtype in product_cn
    product_cn<D, N>(acc_dv, pt, dot);

    // dS^T = P^T (dP^T - D) scale, dP^T = V dO^T
    float dst[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[j][e] = 0.f;
    product_nt<D, N>(dst, vw, dot);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tq + (e & 1);
        dst[j][e] = pt[j][e] * (dst[j][e] - dt[qc]) * scale;
      }
    // dK += dS^T Q, dS rounded to q's dtype in product_cn
    product_cn<D, N>(acc_dk, dst, qt);

    if (it + 1 < tiles) cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one's buffers are free
  }
  store_rows<T, D>(dk + base, acc_dk, row_a, seq);
  store_rows<T, D>(dv + base, acc_dv, row_a, seq);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int bh, int seq, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  dim3 grid(bh, (seq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta,
      seq, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int bh, int seq,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  dim3 grid(bh, (seq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(int d, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, float* delta, int bh, int seq,
                float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<T, 16>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 32: return launch_dq<T, 32>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 128: return launch_dq<T, 128>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(int d, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int bh, int seq,
                 float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns 0 or the CUDA error code of
// the launch (cudaErrorInvalidValue for a head dim or dtype without an
// instance).  The dQ kernel writes D = rowsum(dO * O) to `delta` (BH, T) f32;
// the dK/dV kernel reads it, so it must run after the dQ kernel on its stream.
// The (BH, T, d) operands must start on 16-byte boundaries (cp.async).
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const float* lse,
                                          void* dq, float* delta, int bh, int seq, int d,
                                          float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(d, q, k, v, out, dout, lse, dq, delta, bh, seq, scale, causal, s);
  if (dtype == 1)
    return dispatch_dq<bf16>(d, q, k, v, out, dout, lse, dq, delta, bh, seq, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dk, void* dv, int bh,
                                           int seq, int d, float scale, int causal, int dtype,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(d, q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
  if (dtype == 1)
    return dispatch_dkv<bf16>(d, q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
