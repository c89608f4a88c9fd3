// Fused 1x1 convolution + BatchNorm statistics for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_conv1x1_stats` (inner `kernel`) of
// tools/conv_stats_pallas_experiment.py.  For x (N, C, HW) and w (O, C):
//
//   y[n, o, p] = sum_c w[o, c] * x[n, c, p]      (f32 accumulation, y in T)
//   s1[o]      = sum_{n, p} y32[n, o, p]          (f32)
//   s2[o]      = sum_{n, p} y32[n, o, p]^2        (f32)
//
// where y32 is the f32 accumulator before it is rounded to T, as the
// Pallas kernel sums `yt` before its cast.  s1 and s2 are the one-pass
// statistics a training BatchNorm after the convolution needs, so it
// skips one full read of y.
//
// What bounds it: in bf16 every shape of a ResNet-50 step moves more
// bytes than the tensor cores need time for (x read, y written), so it
// is memory-bound; this first design runs scalar f32 FMAs on the CUDA
// cores, so it is held by the f32 FMA rate instead (tensor cores and TMA
// are later work).
//
// Design.  The TPU carries s1/s2 across its sequential (n, hw) grid in a
// VMEM-resident output block.  Here blocks run in parallel, so:
//   * the (n, hw) columns are flattened to N*HW columns and cut into
//     tiles of 64; one block owns 64 output channels x 64 columns, loops
//     over C in stages of 16 through shared memory (f32), and keeps a
//     4 x 4 f32 accumulator per thread in registers;
//   * it writes y and, per output channel, the partial sums over its 64
//     columns (a 16-lane shuffle tree) into an f32 scratch (2, O, tiles)
//     that the caller allocates -- every scratch element has one owner;
//   * a second launch reduces each scratch row in a fixed order, so the
//     sums do not depend on the order the blocks ran in (deterministic).
// Ragged N*HW, C and O are masked in the kernel: any shape is taken.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTO = 64;        // output channels per block
constexpr int kTP = 64;        // flattened (n, hw) columns per block
constexpr int kKC = 16;        // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWStride = kTO + 4;   // padded row of the w tile
constexpr int kRedThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ part, int C,
                     int HW, int O, long long cols, int o_tiles,
                     long long tiles) {
  __shared__ __align__(16) float ws[kKC][kWStride];  // ws[c][o]
  __shared__ __align__(16) float xs[kKC][kTP];       // xs[c][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // output channels ty*4 .. ty*4+3
  // o tiles vary fastest, so the blocks that read one x tile run together
  const int o_tile = (int)(blockIdx.x % (unsigned)o_tiles);
  const long long tile = blockIdx.x / (unsigned)o_tiles;
  const int o0 = o_tile * kTO;
  const long long col0 = tile * kTP;

  // x loads: one column per thread, channels lc, lc+4, lc+8, lc+12
  const int lcol = tid & (kTP - 1);
  const int lc = tid >> 6;
  const long long gcol = col0 + lcol;
  const bool col_ok = gcol < cols;
  long long xbase = 0;
  if (col_ok) {
    const long long n = gcol / HW;
    xbase = n * (long long)C * HW + (gcol - n * HW);
  }
  // w loads: consecutive threads read consecutive c of one row of w
  const int wc = tid & (kKC - 1);
  const int wo = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kKC) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + lc + 4 * r;
      xs[lc + 4 * r][lcol] =
          (col_ok && c < C) ? load_f32(x + xbase + (long long)c * HW) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = o0 + wo + 16 * r;
      const int c = c0 + wc;
      ws[wc][wo + 16 * r] =
          (o < O && c < C) ? load_f32(w + (long long)o * C + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // y offsets of this thread's 4 columns (-1: past the last column)
  long long ybase[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long col = col0 + tx * 4 + j;
    if (col < cols) {
      const long long n = col / HW;
      ybase[j] = n * (long long)O * HW + (col - n * HW);
    } else {
      ybase[j] = -1;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a masked column or channel loaded zeros: its acc is 0
      if (o < O && ybase[j] >= 0)
        store_t(y + ybase[j] + (long long)o * HW, acc[i][j]);
      p1 += acc[i][j];
      p2 += acc[i][j] * acc[i][j];
    }
    // sum over the 16 lanes of this channel row (lane bits 0-3 = tx)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      p2 += __shfl_xor_sync(0xffffffffu, p2, off);
    }
    if (tx == 0 && o < O) {
      part[(long long)o * tiles + tile] = p1;
      part[((long long)O + o) * tiles + tile] = p2;
    }
  }
}

// s[which][o] = sum over the tiles of part[which][o][:], in a fixed order
__global__ void __launch_bounds__(kRedThreads)
stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ s1,
                    float* __restrict__ s2, int O, long long tiles) {
  __shared__ float sh[kRedThreads];
  const int o = blockIdx.x;
  const int which = blockIdx.y;
  const float* row = part + ((long long)which * O + o) * tiles;
  float s = 0.f;
  for (long long t = threadIdx.x; t < tiles; t += kRedThreads) s += row[t];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int step = kRedThreads / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) sh[threadIdx.x] += sh[threadIdx.x + step];
    __syncthreads();
  }
  if (threadIdx.x == 0) (which ? s2 : s1)[o] = sh[0];
}

long long col_tiles(int N, int HW) {
  return ((long long)N * HW + kTP - 1) / kTP;
}

}  // namespace

extern "C" {

// Floats of the f32 scratch the caller allocates for one call.
long long mxt_conv1x1_stats_scratch(int N, int HW, int O) {
  return 2LL * O * col_tiles(N, HW);
}

// x (N, C, HW), w (O, C), y (N, O, HW) in float32 (dtype 0) or bfloat16
// (dtype 1), all contiguous; scratch of mxt_conv1x1_stats_scratch floats;
// s1, s2 (O,) float32.  Launches on `stream`; returns the CUDA error of
// the launches (0 when both were accepted).
int mxt_conv1x1_stats(const void* x, const void* w, void* y, void* scratch,
                      void* s1, void* s2, int N, int C, int HW, int O,
                      int dtype, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long cols = (long long)N * HW;
  const long long tiles = col_tiles(N, HW);
  const int o_tiles = (O + kTO - 1) / kTO;
  const long long blocks = tiles * o_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0) {
    conv1x1_stats_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), part, C, HW, O, cols, o_tiles, tiles);
  } else if (dtype == 1) {
    conv1x1_stats_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0,
                                          st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), part, C, HW, O, cols, o_tiles,
        tiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<dim3(O, 2), kRedThreads, 0, st>>>(
      part, static_cast<float*>(s1), static_cast<float*>(s2), O, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
