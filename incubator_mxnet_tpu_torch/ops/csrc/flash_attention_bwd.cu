// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` (launched by
// `_flash_bwd_pallas`) in incubator_mxnet_tpu/ops/attention.py.  From the
// forward's residuals (q, k, v, out and lse = m + log l per query row) and the
// output gradient dO it computes, with P = exp(S - lse), S = q k^T * scale:
//   D  = rowsum(dO * O)                         per query row, f32
//   dP = dO V^T,   dS = P * (dP - D) * scale
//   dQ = dS K,     dK = dS^T Q,     dV = P^T dO
// for q, k, v, out, dO of shape (BH, T, d), row-major and contiguous, in f32 or
// bf16.  Scores, P, dP, dS and the accumulators are f32.  In bf16 the kernels
// round where the TPU kernels cast: P to dO's dtype before dV, dS to k's dtype
// before dQ and to q's dtype before dK.
//
// Design (simple and correct first), the TPU's two-kernel split:
//   * dQ kernel: grid (BH, ceil(T / 64)); one block of 256 threads owns 64 query
//     rows and loops over key tiles of 64 rows (the TPU's sequential k axis).
//     Each thread owns 4 query rows x 4 key columns of S and dP, and 4 rows x
//     d/16 columns of the dQ accumulator.  It also computes D for its rows (a
//     row's 16 owners are 16 consecutive lanes, so the row sum is a warp
//     shuffle) and writes D to a (BH, T) f32 scratch that the wrapper
//     allocates.
//   * dK/dV kernel: grid (BH, ceil(T / 64)); one block owns 64 key rows and
//     loops over query tiles.  It works on S^T and dP^T (4 key rows x 4 query
//     columns per thread), reads lse and D of the query tile from device memory
//     (D from the dQ kernel, which runs first on the same stream, so D is not
//     recomputed per tile as the TPU kernel does), and keeps f32 dK and dV
//     accumulators of 4 key rows x d/16 columns per thread.  No atomics: every
//     output element has one owner, so the result is deterministic.
//   * Tiles are 64 x 64 for every head dim, staged in shared memory as f32 with
//     rows padded by one float against bank conflicts.  The largest footprint,
//     dK/dV at d = 128, is 166 KB (K, V, Q, dO tiles, a P^T and a dS^T tile,
//     lse and D of the query tile), so the kernels opt into dynamic shared
//     memory above 48 KB (227 KB max).
//   * The ragged last tile (any T) is masked in the kernels: rows past T are
//     loaded as zeros and never written, and their P is 0.
//   * Causal: the dQ kernel stops at the key tile that holds its last row, the
//     dK/dV kernel starts at the query tile that holds its first key row (the
//     tiles the TPU kernels skip), and the diagonal tile is masked element by
//     element.
//
// Bound at the BERT-base training shape (BH = 8*12, T = 512, d = 64, f32): the
// dQ kernel does 6*BH*T^2*d = 9.7 GFLOP (S, dP, dQ) and the dK/dV kernel
// 8*BH*T^2*d = 12.9 GFLOP (S, dP, dV, dK); in exact f32 on CUDA cores
// (67 TFLOP/s) that is 0.144 ms and 0.192 ms, bound by operations.  Their bytes
// (q, k, v, dO, O or D, lse in; dQ or dK, dV out) take 0.023 ms and 0.026 ms at
// 3.35 TB/s.  In bf16 on tensor cores both would be near 0.01-0.013 ms.
// What this design leaves on the table: every product is a scalar FMA on CUDA
// cores (no mma/wgmma), shared-memory operands are read with scalar loads at
// 2 FMAs per load, tiles are loaded synchronously (no cp.async/TMA double
// buffering), and bf16 is widened to f32 in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB = 64;         // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTM = 4;         // tile rows per thread
constexpr int kTN = 4;         // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename scalar_t> __device__ __forceinline__ scalar_t from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to scalar_t and widened back: the TPU kernels' cast before a product
template <typename scalar_t>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<scalar_t>(x)); }

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kB * (D + 1) + kB * (kB + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// Loads rows [row0, row0 + kB) of a (T, D) matrix into a padded f32 tile,
// zero-filling rows at or past `seq`.  Consecutive threads read consecutive
// elements.
template <typename scalar_t, int D>
__device__ __forceinline__ void load_tile(float* dst, const scalar_t* __restrict__ src,
                                          int row0, int seq) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (row0 + r < seq) ? to_f32(src[(size_t)row0 * D + i]) : 0.f;
  }
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                    const scalar_t* __restrict__ v, const scalar_t* __restrict__ o,
                    const scalar_t* __restrict__ dout, const float* __restrict__ lse,
                    scalar_t* __restrict__ dq, float* __restrict__ delta, int seq,
                    float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int BP = kB + 1;
  constexpr int DN = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // kB x DP
  float* dos = qs + kB * DP;   // kB x DP
  float* ks = dos + kB * DP;   // kB x DP
  float* vs = ks + kB * DP;    // kB x DP
  float* dss = vs + kB * DP;   // kB x BP

  const int q0 = blockIdx.y * kB;
  const int tx = threadIdx.x % 16;  // score / output column group
  const int ty = threadIdx.x / 16;  // query row group
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t rbase = (size_t)blockIdx.x * seq;

  load_tile<scalar_t, D>(qs, q + base, q0, seq);
  load_tile<scalar_t, D>(dos, dout + base, q0, seq);
  __syncthreads();

  // D = rowsum(dO * O) and lse for this thread's 4 rows
  float lse_r[kTM], del_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    const int row = q0 + r;
    float part = 0.f;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int c = tx + 16 * j;
        part = fmaf(dos[r * DP + c], to_f32(o[base + (size_t)row * D + c]), part);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    del_r[i] = part;
    lse_r[i] = row < seq ? lse[rbase + row] : 0.f;
    if (tx == 0 && row < seq) delta[rbase + row] = part;
  }

  float acc[kTM][DN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(seq, q0 + kB) : seq;
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous tile's ks/dss reads are done
    load_tile<scalar_t, D>(ks, k + base, k0, seq);
    load_tile<scalar_t, D>(vs, v + base, k0, seq);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 rows x 4 columns
    float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[kTM], da[kTM], kb[kTN], vb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        qa[i] = qs[(ty * kTM + i) * DP + c];
        da[i] = dos[(ty * kTM + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        kb[j] = ks[(tx + 16 * j) * DP + c];
        vb[j] = vs[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }

    // dS = P (dP - D) scale, rounded to k's dtype before dQ += dS K
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + ty * kTM + i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < seq && col < seq && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(ty * kTM + i) * BP + tx + 16 * j] =
            round_to<scalar_t>(p * (dp[i][j] - del_r[i]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float sa[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) sa[i] = dss[(ty * kTM + i) * BP + kk];
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float kb = ks[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i) acc[i][j] = fmaf(sa[i], kb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty * kTM + i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      dq[base + (size_t)row * D + tx + 16 * j] = from_f32<scalar_t>(acc[i][j]);
  }
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
                     const scalar_t* __restrict__ v, const scalar_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     scalar_t* __restrict__ dk, scalar_t* __restrict__ dv, int seq,
                     float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int BP = kB + 1;
  constexpr int DN = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // kB x DP
  float* vs = ks + kB * DP;     // kB x DP
  float* qs = vs + kB * DP;     // kB x DP
  float* dos = qs + kB * DP;    // kB x DP
  float* pts = dos + kB * DP;   // kB x BP: P^T, key rows x query columns
  float* dsts = pts + kB * BP;  // kB x BP: dS^T
  float* lses = dsts + kB * BP; // kB
  float* dels = lses + kB;      // kB

  const int k0 = blockIdx.y * kB;
  const int tx = threadIdx.x % 16;  // query column / output column group
  const int ty = threadIdx.x / 16;  // key row group
  const size_t base = (size_t)blockIdx.x * seq * D;
  const size_t rbase = (size_t)blockIdx.x * seq;

  load_tile<scalar_t, D>(ks, k + base, k0, seq);
  load_tile<scalar_t, D>(vs, v + base, k0, seq);

  float acc_dk[kTM][DN], acc_dv[kTM][DN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // causal: query tiles wholly above this key tile's first row are skipped
  const int qstart = causal ? k0 : 0;
  for (int q0 = qstart; q0 < seq; q0 += kB) {
    __syncthreads();  // the previous tile's qs/dos/pts/dsts reads are done
    load_tile<scalar_t, D>(qs, q + base, q0, seq);
    load_tile<scalar_t, D>(dos, dout + base, q0, seq);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool in = q0 + i < seq;
      lses[i] = in ? lse[rbase + q0 + i] : 0.f;
      dels[i] = in ? delta[rbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 4 key rows x 4 query columns
    float st[kTM][kTN], dpt[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float ka[kTM], va[kTM], qb[kTN], db[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        ka[i] = ks[(ty * kTM + i) * DP + c];
        va[i] = vs[(ty * kTM + i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        qb[j] = qs[(tx + 16 * j) * DP + c];
        db[j] = dos[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
        }
    }

    // P^T rounded to dO's dtype for dV; dS^T rounded to q's dtype for dK
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int krow = k0 + ty * kTM + i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int qc = tx + 16 * j;
        const int qcol = q0 + qc;
        const bool ok = krow < seq && qcol < seq && (!causal || krow <= qcol);
        const float p = ok ? expf(st[i][j] * scale - lses[qc]) : 0.f;
        pts[(ty * kTM + i) * BP + qc] = round_to<scalar_t>(p);
        dsts[(ty * kTM + i) * BP + qc] =
            round_to<scalar_t>(p * (dpt[i][j] - dels[qc]) * scale);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for 4 key rows x d/16 columns
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float pa[kTM], sa[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        pa[i] = pts[(ty * kTM + i) * BP + kk];
        sa[i] = dsts[(ty * kTM + i) * BP + kk];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const float dob = dos[kk * DP + tx + 16 * j];
        const float qb = qs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          acc_dv[i][j] = fmaf(pa[i], dob, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(sa[i], qb, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int krow = k0 + ty * kTM + i;
    if (krow >= seq) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const size_t at = base + (size_t)krow * D + tx + 16 * j;
      dk[at] = from_f32<scalar_t>(acc_dk[i][j]);
      dv[at] = from_f32<scalar_t>(acc_dv[i][j]);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename scalar_t, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int bh, int seq, float scale,
              int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<scalar_t, D>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  dim3 grid(bh, (seq + kB - 1) / kB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(o),
      static_cast<const scalar_t*>(dout), lse, static_cast<scalar_t*>(dq), delta, seq,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int bh, int seq,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<scalar_t, D>;
  const int err = prepare(kernel, smem);
  if (err) return err;
  dim3 grid(bh, (seq + kB - 1) / kB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(dout), lse, delta,
      static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv), seq, scale, causal);
  return (int)cudaGetLastError();
}

template <typename scalar_t>
int dispatch_dq(int d, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, float* delta, int bh, int seq,
                float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<scalar_t, 16>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 32: return launch_dq<scalar_t, 32>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 64: return launch_dq<scalar_t, 64>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    case 128: return launch_dq<scalar_t, 128>(q, k, v, o, dout, lse, dq, delta, bh, seq, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename scalar_t>
int dispatch_dkv(int d, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dk, void* dv, int bh, int seq,
                 float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<scalar_t, 16>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 32: return launch_dkv<scalar_t, 32>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 64: return launch_dkv<scalar_t, 64>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    case 128: return launch_dkv<scalar_t, 128>(q, k, v, dout, lse, delta, dk, dv, bh, seq, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns 0 or the CUDA error code of
// the launch (cudaErrorInvalidValue for a head dim or dtype without an
// instance).  The dQ kernel writes D = rowsum(dO * O) to `delta` (BH, T) f32;
// the dK/dV kernel reads it, so it must run after the dQ kernel on its stream.
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const float* lse,
                                          void* dq, float* delta, int bh, int seq, int d,
                                          float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(d, q, k, v, out, dout, lse, dq, delta, bh, seq, scale, causal, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(d, q, k, v, out, dout, lse, dq, delta, bh, seq, scale,
                                      causal, s);
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
    return dispatch_dkv<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv, bh, seq, scale,
                                       causal, s);
  return (int)cudaErrorInvalidValue;
}
