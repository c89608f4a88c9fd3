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
// What bounds it: in bf16, 9 of the 12 shapes of a ResNet-50 step move
// more bytes (x read, y written) than the tensor cores need time for; the
// other three (C 1024 at HW 196, O 512; both HW 49 shapes) sit within 1.3x
// of their bytes bound.  So the bf16 design is a memory pipeline that keeps
// the products on the tensor cores.
//
// Three instances, one chosen per shape by conv_path (mxt_conv1x1_stats_path
// reports it):
//   * kTensorRows (bf16 or f16, C % 32 == 0, HW % 8 == 0): the (n, hw) columns are
//     flattened and cut into tiles of 128; a block of 8 warps owns 128
//     output channels x 128 columns, 64 x 32 per warp.  x comes in 16-byte
//     cp.async pieces of 8 columns (never across two images, since HW % 8
//     == 0), w in 16-byte pieces of its rows, through a ring of kStages
//     stages of 32 input channels.  Products: mma.sync m16n8k16 bf16 (f16) with
//     f32 accumulators; w (row-major, k = c contiguous) is the A operand by
//     ldmatrix, x (stored [c][p], n contiguous) the B operand by
//     ldmatrix.trans.
//   * kTensorSlabs (bf16 or f16, C % 32 == 0, O % 8 == 0, HW <= 224, HW % 8 != 0:
//     the HW 196 and 49 shapes, whose rows are 392 and 98 bytes and so not
//     16-byte aligned): one image's run of 32 channels is one contiguous
//     range of 32 HW elements that starts on a 16-byte boundary (C % 32 ==
//     0).  It is copied whole, in 16-byte pieces, into a slab of the ring,
//     and the B fragments are read from the slab with 16-bit shared loads
//     (ldmatrix needs 16-byte aligned rows).  The tile's columns are the
//     images' columns padded to a multiple of 8 (196 -> 200, 49 -> 56); a
//     block of 2 x 7 warps owns 128 output channels x 224 padded columns,
//     or of 2 x 13 warps 128 x 208, whichever computes fewer padded
//     columns per image (slab_nt): 208 holds one image at HW 196, 224 four
//     at HW 49.  Its y rows, 128 HW elements from (n O + o0) HW, are again
//     one 16-byte aligned range (O % 8 == 0).
//   * kCudaCores (f32, and 16-bit shapes the two above do not take): scalar
//     f32 FMAs on the CUDA cores, 64 x 64 output tiles, x and w widened to
//     f32 in shared memory.  It beats cuDNN's f32 convolution at the tool's
//     five f32 shapes (PERF.md) and serves the ragged shapes.
//
// Both tensor-core instances:
//   * One f32 accumulator takes every mma over C.  The mma rounds its f32
//     sum toward zero, so |y| shrinks by up to C/16 ulps (7.6e-6 of |y| at
//     C 2048) and Sum y^2 by up to twice that; on random data a model of
//     that rounding gives 4.3e-6 in Sum y^2 at C 2048, within the
//     statistics' 1e-5 tolerance (tests/test_torch_kernels_emulated.py
//     guards it on the CPU, tc_precision_study.py reads it on the card).
//     Folding each stage's sum into the accumulator with rounding adds
//     would keep Sum y^2 closer to exact, at a cost in time that no check
//     needs (PERF.md).
//   * y is rounded to bf16 (f16) and staged through shared memory, so that it
//     leaves in 16-byte stores of whole rows.
//   * s1 and s2 are summed from the accumulator fragments in registers: a
//     shuffle over the four lanes of a row, then across the warps of the
//     block in a fixed order.
//
// All instances: per-tile partial sums of each output channel go to an f32
// scratch (2, O, tiles) that the caller allocates -- every scratch element
// has one owner -- and a second launch reduces each scratch row in a fixed
// order, so the sums do not depend on the order the blocks ran in and the
// same bits come out of every launch.  Ragged N*HW, C and O are masked in
// the kernels.  Every operand must start on a 16-byte boundary (cp.async).
//
// What it leaves for later: the tensor-core instances reach about half of
// the bytes bound at HW 3136 and 784 and a seventh at HW 196 (PERF.md);
// TMA bulk copies in place of per-thread cp.async, wgmma, and persistent
// blocks that overlap one tile's y stores with the next tile's loads.
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// instance numbers, as mxt_conv1x1_stats_path returns them
constexpr int kCudaCores = 0;
constexpr int kTensorRows = 1;
constexpr int kTensorSlabs = 2;

// ---- CUDA-core instance ------------------------------------------------------

constexpr int kTO = 64;        // output channels per block
constexpr int kTP = 64;        // flattened (n, hw) columns per block
constexpr int kKC = 16;        // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWStride = kTO + 4;   // padded row of the w tile
constexpr int kRedThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f32(const f16* p) { return __half2float(*p); }

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ void store_t(f16* p, float v) { *p = __float2half_rn(v); }

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

// ---- tensor-core instances (bf16, f16) ---------------------------------------

constexpr int kTcO = 128;       // output channels per block: 2 warps of 64 rows
constexpr int kChunk = 32;      // input channels per stage: two k16 steps
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kWLD = kChunk + 8;  // w tile row stride (80 bytes: ldmatrix hits distinct banks)
// warps along the columns (WP) and n8 tiles per warp (NT) of an instance:
// 128 columns of 8-aligned rows; 224 or 208 padded columns of whole images
// in two tilings of the slab instance (see slab_nt)
constexpr int kRowsWP = 4, kRowsNT = 4;
constexpr int kSlabWP = 7, kSlabNT = 4;
constexpr int kSlab2WP = 13, kSlab2NT = 2;
constexpr int kRowsCols = 8 * kRowsNT * kRowsWP;
constexpr int kSlabCols = 8 * kSlabNT * kSlabWP;
constexpr int kSlab2Cols = 8 * kSlab2NT * kSlab2WP;

// A block has 2 x WP warps; warp (wo, wp) owns output channels wo*64 .. +63
// and tile columns wp*8*NT .. +8*NT-1, TP = 8*NT*WP columns in all.  Shared memory: the ring of w stages
// (kTcO x kWLD each); the ring of x stages, [c][p] tiles of stride x_ld
// (rows) or the staged slabs (slabs, kChunk x TP elements each); and the
// cross-warp partial sums.  After the loop the front of it holds the 16-bit y
// tile (kTcO x x_ld).
template <int TP> __host__ __device__ constexpr int x_ld() { return TP + 8; }

template <int TP, bool kSlab>
__host__ __device__ constexpr int x_stage() {
  return kChunk * (kSlab ? TP : x_ld<TP>());
}

template <int WP, int NT, bool kSlab>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)kStages * (kTcO * kWLD + x_stage<8 * NT * WP, kSlab>()) +
         sizeof(float) * 2 * WP * kTcO;
}

// the y tile fits in front of the partial sums
static_assert(sizeof(bf16) * kTcO * x_ld<kRowsCols>() + sizeof(float) * 2 * kRowsWP * kTcO <=
                  tc_smem_bytes<kRowsWP, kRowsNT, false>(), "y tile of the rows instance");
static_assert(sizeof(bf16) * kTcO * x_ld<kSlabCols>() + sizeof(float) * 2 * kSlabWP * kTcO <=
                  tc_smem_bytes<kSlabWP, kSlabNT, true>(), "y tile of the slab instance");
static_assert(sizeof(bf16) * kTcO * x_ld<kSlab2Cols>() + sizeof(float) * 2 * kSlab2WP * kTcO <=
                  tc_smem_bytes<kSlab2WP, kSlab2NT, true>(), "y tile of the slab instance");

// rows o0 .. o0 + kTcO of w, channels c0 .. c0 + kChunk, zeros past O
template <int kThreadsTc, typename H>
__device__ __forceinline__ void load_w(H* dst, const H* __restrict__ w, int o0, int c0, int C,
                                       int O) {
  for (int i = threadIdx.x; i < kTcO * (kChunk / 8); i += kThreadsTc) {
    const int r = i / (kChunk / 8), q = (i % (kChunk / 8)) * 8;
    const bool ok = o0 + r < O;
    cp_async16(dst + r * kWLD + q, w + (size_t)(ok ? o0 + r : 0) * C + c0 + q, ok);
  }
}

// B fragments [k16 step][n8 tile][b0, b1] of this warp's 32 columns for one
// stage, from a [c][p] tile of stride XLD by ldmatrix.trans
template <int XLD, int NT, typename H>
__device__ __forceinline__ void b_frags(uint32_t (&b)[2][NT][2], const H* xt, int wp) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t r[4];  // rows k*16 / + 8 x cols jj*16 / + 8 of [c][p], transposed
      ldmatrix_x4_trans(r, xt + (k * 16 + (lm & 1) * 8 + lr) * XLD + wp * 8 * NT + jj * 16 +
                               (lm >> 1) * 8);
      b[k][2 * jj][0] = r[0];
      b[k][2 * jj][1] = r[1];
      b[k][2 * jj + 1][0] = r[2];
      b[k][2 * jj + 1][1] = r[3];
    }
}

// the same from a staged slab [g][c][p] (row stride HW): lane (g8, t4) takes
// B[k][n] = x[c = 2 t4 (+1, +8, +9)][column g8 of tile j], whose slab offset
// (of c = 0) is off[j], or -1 for a padding column or an absent image
template <int NT>
__device__ __forceinline__ void b_frags(uint32_t (&b)[2][NT][2], const unsigned short* slab,
                                        const int (&off)[NT], int HW) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned short* col = slab + (off[j] < 0 ? 0 : off[j]) + 2 * t4 * HW;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned short* c = col + k * 16 * HW;
      b[k][j][0] = off[j] < 0 ? 0u : c[0] | (uint32_t)c[HW] << 16;
      b[k][j][1] = off[j] < 0 ? 0u : c[8 * HW] | (uint32_t)c[9 * HW] << 16;
    }
  }
}

// acc (64 x 8 NT of this warp) += w x for one stage, w from the stage's
// tile, x as B fragments: two k16 steps per (m16, n8) tile.
template <int NT, typename H>
__device__ __forceinline__ void stage_product(float (&acc)[4][NT][4], const H* wt,
                                              const uint32_t (&b)[2][NT][2], int wo) {
  const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t a[2][4];  // rows of m16 tile i x cols k*16 .. + 15
#pragma unroll
    for (int k = 0; k < 2; ++k)
      ldmatrix_x4(a[k], wt + (wo * 64 + i * 16 + (lm & 1) * 8 + lr) * kWLD + k * 16 +
                            (lm >> 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma16(acc[i][j], a[0], b[0][j][0], b[0][j][1], H());
      mma16(acc[i][j], a[1], b[1][j][0], b[1][j][1], H());
    }
  }
}

// kSlab false: tile = flattened columns tile*TP .. + TP (HW % 8 == 0).
// kSlab true: tile = images tile*imgs .. + imgs, each padded to hwp columns.
template <typename H, int WP, int NT, bool kSlab>
__global__ void __launch_bounds__(64 * WP)
conv1x1_stats_tc_kernel(const H* __restrict__ x, const H* __restrict__ w, H* __restrict__ y,
                        float* __restrict__ part, int N, int C, int HW, int O, int o_tiles,
                        int tiles, int hwp, int imgs) {
  constexpr int kThreadsTc = 64 * WP;
  constexpr int TP = 8 * NT * WP;  // tile columns
  constexpr int XLD = x_ld<TP>();
  constexpr int kPieces = TP / 8;  // 16-byte pieces of a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XS = x_stage<TP, kSlab>();
  H* ws = reinterpret_cast<H*>(smem);                              // kStages x kTcO x kWLD
  H* xs = ws + kStages * kTcO * kWLD;                              // kStages x XS
  float* red = reinterpret_cast<float*>(xs + kStages * XS);        // 2 x WP x kTcO
  H* ys = ws;                                                      // after the loop: kTcO x XLD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wo = warp & 1, wp = warp >> 1;
  // o tiles vary fastest, so the blocks that read one x tile run together
  const int o_tile = (int)(blockIdx.x % (unsigned)o_tiles);
  const int tile = (int)(blockIdx.x / (unsigned)o_tiles);
  const int o0 = o_tile * kTcO;
  const long long cols = (long long)N * HW;
  const int n0 = tile * imgs;  // kSlab: first image of the tile

  // kSlab false: this thread always copies piece `piece` of tile rows
  // prow, prow + 16 (threads are a multiple of kPieces), so its x offset
  // is computed once
  const int piece = tid % kPieces, prow = tid / kPieces;
  const long long pcol = (long long)tile * TP + piece * 8;
  const bool pcol_ok = pcol < cols;
  long long xoff = 0;  // x offset of (n, c = 0, p) of this piece's column
  if (!kSlab && pcol_ok) {
    const long long n = pcol / HW;
    xoff = n * C * HW + (pcol - n * HW);
  }

  // kSlab: slab offsets of this lane's B columns (see b_frags)
  int off[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = wp * 8 * NT + j * 8 + (lane >> 2);
    const int g = kSlab ? n / hwp : 0, p = n - g * hwp;
    off[j] = kSlab && g < imgs && n0 + g < N && p < HW ? g * kChunk * HW + p : -1;
  }

  const int stages = C / kChunk;
  auto load_stage = [&](int kc, int s) {
    const int c0 = kc * kChunk;
    load_w<kThreadsTc>(ws + s * kTcO * kWLD, w, o0, c0, C, O);
    if (!kSlab) {
      H* dst = xs + s * XS + piece * 8;
#pragma unroll
      for (int r = prow; r < kChunk; r += kThreadsTc / kPieces)
        cp_async16(dst + r * XLD, x + (pcol_ok ? xoff + (long long)(c0 + r) * HW : 0), pcol_ok);
    } else {
      // one image's kChunk channels: kChunk*HW contiguous elements from
      // (n C + c0) HW, a multiple of 8, so 16-byte pieces
      H* dst = xs + s * XS;
      for (int g = 0; g < imgs && n0 + g < N; ++g) {
        const H* src = x + ((long long)(n0 + g) * C + c0) * HW;
        for (int i = tid; i < kChunk * HW / 8; i += kThreadsTc)
          cp_async16(dst + g * kChunk * HW + i * 8, src + i * 8, true);
      }
    }
  };

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < stages; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kc is in; stage kc - 1's buffers are free
    if (kc + kStages - 1 < stages) load_stage(kc + kStages - 1, (kc + kStages - 1) % kStages);
    cp_async_commit();
    const int s = kc % kStages;
    uint32_t b[2][NT][2];
    if (kSlab)
      b_frags<NT>(b, reinterpret_cast<const unsigned short*>(xs + s * XS), off, HW);
    else
      b_frags<XLD, NT>(b, xs + s * XS, wp);
    stage_product(acc, ws + s * kTcO * kWLD, b, wo);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the y tile

  // partial sums of this warp's 64 rows over its 8 NT columns: the lane's
  // columns, then the 4 lanes of a row; padded and masked columns are 0
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float a = acc[i][j][2 * h], b = acc[i][j][2 * h + 1];
        p1 += a + b;
        p2 += a * a + b * b;
      }
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p2 += __shfl_xor_sync(0xffffffffu, p2, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      p2 += __shfl_xor_sync(0xffffffffu, p2, 2);
      if (t4 == 0) {
        const int ol = wo * 64 + i * 16 + h * 8 + g8;
        red[wp * kTcO + ol] = p1;
        red[(WP + wp) * kTcO + ol] = p2;
      }
    }
  // y rounded to H into the y tile, two columns per 32-bit store
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wo * 64 + i * 16 + g8, c = wp * 8 * NT + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(ys + r * XLD + c) = pack16(acc[i][j][0], acc[i][j][1], H());
      *reinterpret_cast<uint32_t*>(ys + (r + 8) * XLD + c) = pack16(acc[i][j][2], acc[i][j][3], H());
    }
  __syncthreads();

  // the block's partial sums, the column warps in a fixed order
  if (tid < kTcO && o0 + tid < O) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < WP; ++q) {
      s1 += red[q * kTcO + tid];
      s2 += red[(WP + q) * kTcO + tid];
    }
    part[(long long)(o0 + tid) * tiles + tile] = s1;
    part[((long long)O + o0 + tid) * tiles + tile] = s2;
  }

  if (!kSlab) {
    // 16-byte rows of 8 columns of one channel; this thread's piece column
    // is fixed (threads are a multiple of kPieces), so is its y offset
    if (pcol_ok) {
      const long long n = pcol / HW;
      H* yrow = y + n * O * HW + (pcol - n * HW);
      for (int r = prow; r < kTcO && o0 + r < O; r += kThreadsTc / kPieces)
        *reinterpret_cast<uint4*>(yrow + (long long)(o0 + r) * HW) =
            *reinterpret_cast<const uint4*>(ys + r * XLD + piece * 8);
    }
  } else {
    // image g's rows o0 .. o0 + orows: orows*HW contiguous elements from
    // (n O + o0) HW, a multiple of 8 (O % 8 == 0), gathered 8 at a time
    const int orows = min(kTcO, O - o0);
    const unsigned short* ytile = reinterpret_cast<const unsigned short*>(ys);
    for (int g = 0; g < imgs && n0 + g < N; ++g) {
      uint4* dst = reinterpret_cast<uint4*>(y + ((long long)(n0 + g) * O + o0) * HW);
      for (int i = tid; i < orows * HW / 8; i += kThreadsTc) {
        int r = i * 8 / HW, p = i * 8 - r * HW;
        uint32_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t lo = ytile[r * XLD + g * hwp + p];
          if (++p == HW) { p = 0; ++r; }
          const uint32_t hi = ytile[r * XLD + g * hwp + p];
          if (++p == HW) { p = 0; ++r; }
          v[u] = lo | (hi << 16);
        }
        dst[i] = make_uint4(v[0], v[1], v[2], v[3]);
      }
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

int conv_path(int C, int HW, int O, int dtype) {
  if (dtype == 0 || C % kChunk) return kCudaCores;
  if (HW % 8 == 0) return kTensorRows;
  if (O % 8 == 0 && HW <= kSlabCols) return kTensorSlabs;
  return kCudaCores;
}

// columns of a padded image of the slab instance
int slab_hwp(int HW) { return (HW + 7) / 8 * 8; }

// n8 tiles per warp of the slab instance's tiling at HW: 13 x 2 warps (208
// columns) where they compute fewer padded columns per image than 7 x 4
// (224), else 7 x 4.  HW 196: one image either way, 208 columns against
// 224; HW 49: 3 images in 208 against 4 in 224 (PERF.md, the tilings).
int slab_nt(int HW) {
  const int whole = kSlabCols / slab_hwp(HW), whole2 = kSlab2Cols / slab_hwp(HW);
  return whole2 > 0 && kSlab2Cols * whole < kSlabCols * whole2 ? kSlab2NT : kSlabNT;
}

// whole images per tile of the slab instance
int slab_imgs(int HW) {
  return (slab_nt(HW) == kSlab2NT ? kSlab2Cols : kSlabCols) / slab_hwp(HW);
}

long long conv_tiles(int N, int C, int HW, int O, int dtype) {
  switch (conv_path(C, HW, O, dtype)) {
    case kTensorRows: return ((long long)N * HW + kRowsCols - 1) / kRowsCols;
    case kTensorSlabs: return (N + slab_imgs(HW) - 1) / slab_imgs(HW);
    default: return ((long long)N * HW + kTP - 1) / kTP;
  }
}

template <typename H, int WP, int NT, bool kSlab>
int launch_tc(const void* x, const void* w, void* y, float* part, int N, int C, int HW, int O,
              int o_tiles, int tiles, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<WP, NT, kSlab>();
  auto kernel = conv1x1_stats_tc_kernel<H, WP, NT, kSlab>;
  if (smem > 48 * 1024) {
    const int err =
        (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const unsigned blocks = (unsigned)tiles * (unsigned)o_tiles;
  kernel<<<blocks, 64 * WP, smem, st>>>(
      static_cast<const H*>(x), static_cast<const H*>(w), static_cast<H*>(y), part, N, C, HW, O,
      o_tiles, tiles, kSlab ? slab_hwp(HW) : 0, kSlab ? slab_imgs(HW) : 0);
  return (int)cudaGetLastError();
}

// the tensor-core instance `path` (kTensorRows or kTensorSlabs) in operand type H
template <typename H>
int launch_tc_path(int path, const void* x, const void* w, void* y, float* part, int N, int C,
                   int HW, int O, int o_tiles, int tiles, cudaStream_t st) {
  if (path == kTensorRows)
    return launch_tc<H, kRowsWP, kRowsNT, false>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
  if (slab_nt(HW) == kSlab2NT)
    return launch_tc<H, kSlab2WP, kSlab2NT, true>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
  return launch_tc<H, kSlabWP, kSlabNT, true>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
}

template <typename T>
int launch_cuda_cores(const void* x, const void* w, void* y, float* part, int N, int C, int HW,
                      int O, int o_tiles, long long tiles, cudaStream_t st) {
  auto kernel = conv1x1_stats_kernel<T>;
  const unsigned blocks = (unsigned)(tiles * o_tiles);
  kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), part, C, HW, O,
      (long long)N * HW, o_tiles, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The instance a shape takes: 0 scalar FMAs on the CUDA cores, 1 tensor
// cores over 16-byte aligned rows (HW % 8 == 0), 2 tensor cores over
// whole-image slabs (HW % 8 != 0, HW <= 224).
int mxt_conv1x1_stats_path(int N, int C, int HW, int O, int dtype) {
  (void)N;
  return conv_path(C, HW, O, dtype);
}

// Floats of the f32 scratch the caller allocates for one call.
long long mxt_conv1x1_stats_scratch(int N, int C, int HW, int O, int dtype) {
  return 2LL * O * conv_tiles(N, C, HW, O, dtype);
}

// x (N, C, HW), w (O, C), y (N, O, HW) in float32 (dtype 0), bfloat16
// (dtype 1) or float16 (dtype 2), all contiguous and starting on 16-byte
// boundaries; scratch of mxt_conv1x1_stats_scratch floats; s1, s2 (O,) float32.  Launches on
// `stream`; returns the CUDA error of the launches (0 when both were
// accepted).
int mxt_conv1x1_stats(const void* x, const void* w, void* y, void* scratch,
                      void* s1, void* s2, int N, int C, int HW, int O,
                      int dtype, void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || O <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const long long tiles = conv_tiles(N, C, HW, O, dtype);
  const int path = conv_path(C, HW, O, dtype);
  const int o_tiles = (O + (path == kCudaCores ? kTO : kTcO) - 1) /
                      (path == kCudaCores ? kTO : kTcO);
  if (tiles * o_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  int err;
  if (path != kCudaCores && dtype == 1)
    err = launch_tc_path<bf16>(path, x, w, y, part, N, C, HW, O, o_tiles, (int)tiles, st);
  else if (path != kCudaCores)
    err = launch_tc_path<f16>(path, x, w, y, part, N, C, HW, O, o_tiles, (int)tiles, st);
  else if (dtype == 0)
    err = launch_cuda_cores<float>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
  else if (dtype == 1)
    err = launch_cuda_cores<bf16>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
  else
    err = launch_cuda_cores<f16>(x, w, y, part, N, C, HW, O, o_tiles, tiles, st);
  if (err != 0) return err;
  dim3 grid(O, 2);
  stats_reduce_kernel<<<grid, kRedThreads, 0, st>>>(
      part, static_cast<float*>(s1), static_cast<float*>(s2), O, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
