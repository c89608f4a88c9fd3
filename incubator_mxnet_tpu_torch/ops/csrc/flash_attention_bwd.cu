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
// Design, the TPU's two-kernel split (tiles and fragment products in
// flash_tiles.cuh, shared with the forward):
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
#include "flash_tiles.cuh"

namespace {

// query rows per step of the dK/dV kernel: 32 at d = 128 keeps the dK and dV
// accumulators (d/2 floats each per thread) and S^T, dP^T in registers
template <int D> __host__ __device__ constexpr int query_tile() { return D == 128 ? 32 : 64; }

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
