// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (launched by `_flash_fwd`) in
// incubator_mxnet_tpu/ops/attention.py.  It computes the same function:
//   out = softmax(q k^T * scale [causal mask]) v      in the operand dtype
//   lse = m + log(l)                                   per query row, f32
// for q, k, v of shape (BH, T, d), row-major and contiguous, in f32 or bf16.
// Scores and the online-softmax state (m, l, acc) are f32; P is rounded to
// the operand dtype before P.V, as the TPU kernel casts it before its second
// matmul.
//
// Bound at the BERT-base shape (BH = 8*12, T = 512, d = 64): one call does
// 4*BH*T^2*d = 6.4 GFLOP and must move q, k, v and out once (50 MB in f32,
// 25 MB in bf16).  f32-accurate products: 0.039 ms as 3xTF32 on the tensor
// cores (495 / 3 TFLOP/s), 0.096 ms as FMAs on the CUDA cores; bf16: 0.008 ms
// of memory traffic at 3.35 TB/s against 0.007 ms of tensor-core work.
//
// Design, modelled on the dQ kernel of flash_attention_bwd.cu (tiles and
// products in flash_tiles.cuh):
//   * grid (BH, ceil(T / 64)); a block of 4 warps owns 64 query rows, 16 per
//     warp, and loops over key tiles of 64 rows (the TPU's sequential k axis),
//     the next K/V tile in flight by cp.async during the current one's
//     products (two buffers).  Q stays in shared memory and is re-read by
//     every tile's S product, so that at d = 128 in f32 the 16 x 128
//     accumulator, S and the small terms' accumulator stay in registers
//     (255 of them there, with 4 bytes of spill stores; 169 at d = 64).
//   * S = Q K^T on mma.sync: bf16 m16n8k16 with ldmatrix; f32 as 3xTF32 on
//     m16n8k8 with the small terms in an accumulator of their own (the mma
//     rounds its sums toward zero; product_nt).
//   * The online softmax runs in f32 registers on S's accumulator fragments:
//     a row's values sit in the 4 lanes of a quad, so the row max and row sum
//     are two shuffles each.
//   * O += P V, with P's accumulator fragment used in place as the A operand
//     (product_cn): in bf16 P is rounded to bf16 there, in f32 it is split
//     for 3xTF32 in registers, and each k8 step's sum is added to O with an
//     f32 add that rounds to nearest, so that the mma's rounding toward zero
//     does not shrink O one way (product_cn's kFold).
//   * The ragged last tile (any T) is masked: rows past T load as zeros and
//     are never written, columns past T get probability 0.  Causal: key
//     tiles wholly above the diagonal are skipped, the diagonal tile is masked
//     element by element.
//   * Every output element has one owner: the same bits on every launch.
// What it leaves for later: wgmma and TMA, warp specialisation, head dims
// above 128, and reading q, k, v in their (B, T, H, d) layout.
#include "flash_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  // Q (kRows rows), two K and two V tiles (kKeyTile rows)
  return sizeof(T) * (size_t)row_stride<T, D>() * (kRows + 4 * kKeyTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int seq, float scale,
                 int causal) {
  constexpr int LD = row_stride<T, D>();
  constexpr int N = kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // kRows x LD
  T* ks = qs + kRows * LD;             // 2 x N x LD
  T* vs = ks + 2 * N * LD;             // 2 x N x LD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * kRows;
  const size_t base = (size_t)blockIdx.x * seq * D;
  const int kend = causal ? min(seq, q0 + kRows) : seq;
  const int tiles = (kend + N - 1) / N;

  load_tile<T, D, kRows>(qs, q + base, q0, seq);
  load_tile<T, D, N>(ks, k + base, 0, seq);
  load_tile<T, D, N>(vs, v + base, 0, seq);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this thread's rows of S and O: row_a and row_a + 8
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const T* qw = qs + warp * 16 * LD;
  const int tq = 2 * (lane & 3);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

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

    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    product_nt<D, N>(s, qw, kt);

    // scaled and masked scores, and the tile's row maxima
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int col = k0 + j * 8 + tq + (e & 1);
        const bool ok = col < seq && (!causal || col <= row);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        if (e < 2) mx_a = fmaxf(mx_a, s[j][e]);
        else mx_b = fmaxf(mx_b, s[j][e]);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);

    // P = exp(S - m) in place of S, 0 where masked; row sums of the
    // unrounded P
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - (e < 2 ? mn_a : mn_b));
        s[j][e] = p;
        if (e < 2) rs_a += p;
        else rs_b += p;
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
      rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha_a;
      acc[n][1] *= alpha_a;
      acc[n][2] *= alpha_b;
      acc[n][3] *= alpha_b;
    }
    // O += P V, P rounded to the operand dtype in product_cn; in f32 each
    // k step's sum is folded into acc with a rounding f32 add
    product_cn<D, N, true>(acc, s, vt);

    if (it + 1 < tiles) cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one's buffers are free
  }

  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= inv_a;
    acc[n][1] *= inv_a;
    acc[n][2] *= inv_b;
    acc[n][3] *= inv_b;
  }
  store_rows<T, D>(out + base, acc, row_a, seq);
  if ((lane & 3) == 0) {
    const size_t rbase = (size_t)blockIdx.x * seq;
    if (row_a < seq) lse[rbase + row_a] = m_a + logf(l_a);
    if (row_b < seq) lse[rbase + row_b] = m_b + logf(l_b);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int seq,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  auto kernel = flash_fwd_kernel<T, D>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  dim3 grid(bh, (seq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, seq, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out, float* lse,
               int bh, int seq, float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, seq, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, seq, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, seq, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, seq, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or the CUDA error code of the
// launch (cudaErrorInvalidValue for a head dim or dtype without an instance).
// The (BH, T, d) operands must start on 16-byte boundaries (cp.async).
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* out, float* lse, int bh, int seq, int d,
                                       float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, out, lse, bh, seq, scale, causal, s);
  if (dtype == 1) return dispatch_d<bf16>(d, q, k, v, out, lse, bh, seq, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
