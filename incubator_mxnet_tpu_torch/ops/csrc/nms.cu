// Greedy non-maximum suppression for Hopper (sm_90a), in bitmask form.
//
// Replaces no Pallas kernel: the JAX package leaves NMS to XLA (a
// `fori_loop` in `box_nms`, incubator_mxnet_tpu/ops/contrib.py:59, and a
// blocked `fori_loop`/`while_loop` fixpoint in `_nms_keep`,
// incubator_mxnet_tpu/ops/rcnn.py:58).  On the card a per-box loop is N
// tiny launches (2000 per image in Proposal, 24,564 anchors in SSD-512's
// MultiBoxDetection), and the fixpoint's exit depends on the data, which a
// captured CUDA graph cannot hold.  These launches do the whole pass with
// no host read and a grid that depends only on (B, N) and the card.
//
// Input: B images of N boxes each, already in score order, (x1, y1, x2, y2)
// f32; optional class ids (f32, compared for equality) and optional
// "takes part" flags.  Box i suppresses a later box j when
//   IoU(i, j) > thresh, and (class-aware) cls[i] == cls[j].
// Greedy result: box i is kept when it takes part and no kept box before
// it suppresses it.  n_eff, one past the last box that takes part (N
// without flags), bounds all work: a box at or past it is never kept and
// suppresses nothing, so its mask row and column are never computed,
// written or read.
//
//   * Count launch (only with flags), grid (ceil(nb / 8), B) with nb =
//     ceil(N / 64), 256 threads: one warp packs a chunk of 64 flags into a
//     word by two ballots.  Each later block reads n_eff from those words.
//   * Mask launch, a persistent grid of 4 blocks of 256 threads per SM
//     folded over the images: the blocks of an image stride over the
//     tiles (r, c) with r <= c < ceil(n_eff / 64), the upper triangle
//     only; no block is launched for the lower one and no tile past n_eff
//     is visited.  A tile's 64 column boxes, their areas and classes sit
//     in shared memory; a block takes four tiles at once, a thread a row,
//     and each row r*64 + i < n_eff gets one 64-bit word, bit j set when
//     box c*64 + j comes after it and is suppressed by it.  Rows past
//     n_eff are left unwritten.
//   * Scan launch, grid B, 256 threads: walks the chunks of 64 boxes up to
//     n_eff with a "removed" bitmask in shared memory.  A chunk's words
//     from its diagonal on are one contiguous run of the scratch; one
//     thread streams them into a double buffer of slabs in shared memory
//     with the bulk asynchronous copy (cp.async.bulk, completing on an
//     mbarrier), the next slab in flight while this one is used.  Every
//     warp resolves the chunk on its own from the diagonal words, held two
//     a lane, in rounds: the candidates that no earlier candidate
//     suppresses are kept, what they suppress is removed, each by one OR
//     over the warp (two redux.sync); a round keeps at least the first
//     candidate, and chains of suppression are short, so a chunk takes a
//     few rounds where a box-by-box pass took a step per kept box (several
//     times slower on an H100, PERF.md).  Then the warps OR the kept rows' words of the
//     slab into "removed", one word a warp.  The serial chain reads shared
//     memory and registers only; one block barrier a slab.  Without keep
//     flags (positions only) the scan ends with the chunk that holds the
//     topk-th kept box.
//
// Scratch, per image: the triangle's words, chunk r holding words r..nb-1
// of its rows (word w of the chunk's rows adjacent), then the nb flag
// words, rounded to an even count: 64 * nb (nb + 1) / 2 words at most,
// about half of the full N x nb mask at large N.
//
// The IoU is computed in the order of operations of the JAX formulas with
// the rounding intrinsics, so nvcc cannot contract a product and a sum
// into an FMA, and `iou > thresh` decides as the plain version does on the
// CPU: either
//   corner (box_nms, `_iou_corner`): union = (area_i + area_j) - inter,
//     IoU = inter / union where union > 0, else 0;
//   plus one (Proposal, `_nms_keep`): widths x2 - x1 + 1, IoU = inter /
//     max(union, 1e-12).
// Each box's area is computed once, by the same formula.  The decision
// RN(inter / union) > thresh is read from the product thresh * union where
// inter lies beyond it by far more than rounding can move either (`above`),
// and from the division only near the threshold: the same bit, a third
// less time on the mask at box_nms's shape.
//
// What bounds it: the needed pairs' IoUs, 13 f32 operations a pair on the
// CUDA cores, or reading the inputs once; the scan's chain of chunks is
// serial by the greedy rule and is what the design keeps short.
#include <cuda_runtime.h>

// Bytes of one slab buffer of the scan (two are kept); a chunk whose
// words reach further is streamed in several slabs.
#ifndef MXT_NMS_SLAB_BYTES
#define MXT_NMS_SLAB_BYTES (96 * 1024)
#endif

namespace {

typedef unsigned long long u64;

constexpr int kCountThreads = 256;
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kMaskThreads = 256;  // four tiles at once, a thread a row
constexpr int kMaskBlocksPerSM = 4;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kSlabBlocks = MXT_NMS_SLAB_BYTES / (64 * 8);  // words of 64 rows
constexpr int kMaxDynamicSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSlabBlocks >= 1, "a slab holds at least one word of 64 rows");

// word offset of chunk r in an image's triangle: chunks 0..r-1 hold nb - r'
// words of 64 rows each
__host__ __device__ inline long long chunk_offset(int r, int nb) {
  return 64LL * ((long long)r * nb - (long long)r * (r - 1) / 2);
}

// words of an image's triangle (its last chunk has N - 64 (nb - 1) rows)
__host__ __device__ inline long long tri_words(int n, int nb) {
  return chunk_offset(nb - 1, nb) + (n - 64 * (nb - 1));
}

__host__ __device__ inline long long image_words(int n) {
  const int nb = (n + 63) / 64;
  return (tri_words(n, nb) + nb + 1) & ~1LL;
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier awaiting one arrival (and the bytes it is told to expect)
__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the bulk asynchronous copy, completing on `bar`; one thread
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(u64* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// n_eff of an image from its flag words, the same in every thread
template <int kThreads>
__device__ __forceinline__ int block_n_eff(const u64* part, int nb, int* red) {
  unsigned last = 0;
  for (int c = threadIdx.x; c < nb; c += kThreads)
    if (part[c]) last = max(last, (unsigned)(c * 64 + 64 - __clzll((long long)part[c])));
  last = __reduce_max_sync(kFull, last);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = (int)last;
  __syncthreads();
  int n_eff = 0;
  for (int w = 0; w < kThreads / 32; ++w) n_eff = max(n_eff, red[w]);
  return n_eff;
}

__device__ __forceinline__ float box_area(float4 v, int plus_one) {
  if (plus_one)
    return __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(v.z, v.x), 1.f), 0.f),
                     fmaxf(__fadd_rn(__fsub_rn(v.w, v.y), 1.f), 0.f));
  return __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
}

// RN(inter / den) > thresh for den > 0, bit for bit: from the product
// thresh * den where inter lies beyond it by far more than the product's
// rounding (2^-20 of it against 2^-24; thresh and the product normal
// floats), else from the division
__device__ __forceinline__ bool above(float inter, float den, float thresh) {
  const float p = __fmul_rn(thresh, den);
  if (thresh >= 1.17549435e-38f && p >= 1.17549435e-38f) {
    if (inter > __fmul_rn(p, 1.00000095367431640625f)) return true;
    if (inter < __fmul_rn(p, 0.99999904632568359375f)) return false;
  }
  return __fdiv_rn(inter, den) > thresh;
}

// IoU(a, b) > thresh, the IoU in the JAX formula's order of operations
template <bool kPlusOne>
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thresh) {
  if constexpr (kPlusOne) {
    const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f), 0.f);
    const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    return above(inter, fmaxf(uni, 1e-12f), thresh);
  } else {
    const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    return uni > 0.f ? above(inter, uni, thresh) : 0.f > thresh;
  }
}

// the suppression bits of row box `a` against columns j0..ncol-1 of a tile
template <bool kPlusOne>
__device__ __forceinline__ u64 row_bits(float4 a, float area_a, float ca, bool aware,
                                        const float4* sbox, const float* sarea, const float* scls,
                                        int j0, int ncol, float thresh) {
  u64 bits = 0;
  for (int j = j0; j < ncol; ++j) {
    if (aware && scls[j] != ca) continue;
    if (suppresses<kPlusOne>(a, area_a, sbox[j], sarea[j], thresh)) bits |= 1ull << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kCountThreads)
mxt_nms_count_kernel(const unsigned char* __restrict__ valid, u64* __restrict__ mask, int n, int nb,
                     long long img_words) {
  const int b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kCountWarps + warp;
  if (c >= nb) return;
  const unsigned char* v = valid + (size_t)b * n + (size_t)c * 64;
  const int len = min(64, n - c * 64);
  const unsigned lo = __ballot_sync(kFull, lane < len && v[lane]);
  const unsigned hi = __ballot_sync(kFull, lane + 32 < len && v[lane + 32]);
  if (lane == 0) mask[(size_t)b * img_words + tri_words(n, nb) + c] = (u64)hi << 32 | lo;
}

__global__ void __launch_bounds__(kMaskThreads)
mxt_nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ cls, int has_part,
                    u64* __restrict__ mask, int n, int nb, long long img_words, float thresh,
                    int plus_one) {
  __shared__ float4 sbox[4][64];
  __shared__ float sarea[4][64];
  __shared__ float scls[4][64];
  __shared__ int red[kMaskThreads / 32];
  const int b = blockIdx.y, t = threadIdx.x;
  u64* m = mask + (size_t)b * img_words;
  const int n_eff = has_part ? block_n_eff<kMaskThreads>(m + tri_words(n, nb), nb, red) : n;
  const int nbe = (n_eff + 63) / 64;
  const long long ntri = (long long)nbe * (nbe + 1) / 2;
  const float4* bb = reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  const float* cb = cls ? cls + (size_t)b * n : nullptr;
  const int g = t / 64, row = t % 64;
  for (long long q0 = (long long)blockIdx.x * 4; q0 < ntri; q0 += (long long)gridDim.x * 4) {
    // tile q of the upper triangle, column by column: q = c (c + 1) / 2 + r
    const long long q = q0 + g;
    int r = 0, c = -1;
    if (q < ntri) {
      c = (int)((sqrtf(8.f * (float)q + 1.f) - 1.f) * 0.5f);
      while ((long long)c * (c + 1) / 2 > q) --c;
      while ((long long)(c + 1) * (c + 2) / 2 <= q) ++c;
      r = (int)(q - (long long)c * (c + 1) / 2);
    }
    const int col0 = c * 64, ncol = c < 0 ? 0 : min(64, n_eff - col0);
    __syncthreads();  // the last tiles' columns are no longer read
    if (row < ncol) {
      const float4 v = bb[col0 + row];
      sbox[g][row] = v;
      sarea[g][row] = box_area(v, plus_one);
      scls[g][row] = cb ? cb[col0 + row] : 0.f;
    }
    __syncthreads();
    const int i = r * 64 + row;
    if (c < 0 || i >= n_eff) continue;
    const float4 a = bb[i];
    const float area_a = box_area(a, plus_one), ca = cb ? cb[i] : 0.f;
    const int j0 = c == r ? row + 1 : 0;
    m[chunk_offset(r, nb) + (long long)(c - r) * 64 + row] =
        plus_one ? row_bits<true>(a, area_a, ca, cb != nullptr, sbox[g], sarea[g], scls[g], j0,
                                  ncol, thresh)
                 : row_bits<false>(a, area_a, ca, cb != nullptr, sbox[g], sarea[g], scls[g], j0,
                                   ncol, thresh);
  }
}

// the OR over the warp of the rows (lane, lane + 32) that `rows` selects,
// of their words d0, d1
__device__ __forceinline__ u64 warp_or_rows(u64 rows, u64 d0, u64 d1, int lane) {
  const u64 v = (((unsigned)rows >> lane) & 1u ? d0 : 0) |
                (((unsigned)(rows >> 32) >> lane) & 1u ? d1 : 0);
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
  return (u64)hi << 32 | lo;
}

// the slab after (c, k): the next words of chunk c, else chunk c + 1's first
__device__ __forceinline__ void next_slab(int& c, int& k, int nbe, int slab_blocks) {
  if (c + (k + 1) * slab_blocks < nbe) {
    ++k;
  } else {
    ++c;
    k = 0;
  }
}

// slab k of chunk c (its words c + k S .. up to nbe - 1, each 64 rows; the
// last chunk's one word has `len` rows, rounded up to an even count)
__device__ __forceinline__ void load_slab(u64* dst, const u64* m, int c, int k, int n, int nb,
                                          int nbe, int slab_blocks, u64* bar) {
  const int w0 = c + k * slab_blocks, w1 = min(w0 + slab_blocks, nbe);
  const int len = min(64, n - c * 64);
  const unsigned words = (unsigned)((w1 - w0) * len + 1) & ~1u;
  bulk_load(dst, m + chunk_offset(c, nb) + (long long)(w0 - c) * len, words * 8u, bar);
}

__global__ void __launch_bounds__(kScanThreads)
mxt_nms_scan_kernel(const u64* __restrict__ mask, int has_part, unsigned char* __restrict__ keep,
                    long long* __restrict__ idx, int n, int nb, long long img_words,
                    int slab_blocks, int topk) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* slab = reinterpret_cast<u64*>(smem);  // two buffers of slab_blocks x 64 words
  u64* removed = slab + 2 * (size_t)slab_blocks * 64;
  u64* partw = removed + nb;
  __shared__ u64 full[2];
  __shared__ int red[kScanWarps];
  const int b = blockIdx.x, t = threadIdx.x, warp = t / 32, lane = t % 32;
  const bool positions_only = keep == nullptr;
  const u64* m = mask + (size_t)b * img_words;
  const long long tri = tri_words(n, nb);
  for (int w = t; w < nb; w += kScanThreads) {
    const int len = min(64, n - w * 64);
    removed[w] = 0;
    partw[w] = has_part ? m[tri + w] : len == 64 ? ~0ull : (1ull << len) - 1;
  }
  const int n_eff = has_part ? block_n_eff<kScanThreads>(partw, nb, red) : n;
  const int nbe = (n_eff + 63) / 64;
  // the producer's cursor (every thread keeps it; thread 0 issues)
  int pc = 0, pk = 0, issued = 0;
  if (t == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
  }
  __syncthreads();
  for (; issued < 2 && pc < nbe; ++issued) {
    if (t == 0)
      load_slab(slab + (size_t)issued * slab_blocks * 64, m, pc, pk, n, nb, nbe, slab_blocks,
                &full[issued]);
    next_slab(pc, pk, nbe, slab_blocks);
  }
  __syncthreads();

  int c = 0, k = 0, seq = 0, count = 0;
  u64 kb = 0;  // the kept boxes of chunk c
  bool stop = false;
  for (; c < nbe; ++seq) {
    const int s = seq & 1;
    mbar_wait(&full[s], (seq >> 1) & 1);
    const u64* sl = slab + (size_t)s * slab_blocks * 64;
    const int w0 = c + k * slab_blocks, w1 = min(w0 + slab_blocks, nbe);
    if (k == 0) {
      // the chunk's greedy pass, the same in every warp, in rounds
      const int base = c * 64, len = min(64, n - base), before = count;
      const u64 d0 = lane < len ? sl[lane] : 0, d1 = lane + 32 < len ? sl[lane + 32] : 0;
      u64 cand = partw[c] & ~removed[c];
      kb = 0;
      while (cand) {
        // kept: the candidates no earlier candidate suppresses; removed:
        // what those suppress (the first candidate is kept every round)
        const u64 sure = cand & ~warp_or_rows(cand, d0, d1, lane);
        kb |= sure;
        cand &= ~sure;
        if (cand) cand &= ~warp_or_rows(sure, d0, d1, lane);
      }
      count = before + __popcll(kb);
      stop = positions_only && count >= topk;
      if (warp == 0) {
        for (int p = lane; p < len; p += 32) {
          const bool kept = (kb >> p) & 1;
          if (keep) keep[(size_t)b * n + base + p] = kept;
          const int rank = before + __popcll(kb & ((1ull << p) - 1));
          if (idx && kept && rank < topk) idx[(size_t)b * topk + rank] = base + p;
        }
      }
    }
    if (!stop && kb) {
      // the kept rows' words of this slab into "removed", one word a warp
      for (int w = max(w0, c + 1) + warp; w < w1; w += kScanWarps) {
        const u64* rows = sl + (size_t)(w - w0) * 64;
        const u64 hit = warp_or_rows(kb, rows[lane], rows[lane + 32], lane);
        if (lane == 0) removed[w] |= hit;
      }
    }
    __syncthreads();  // "removed" is whole and slab s is free
    if (stop) {
      ++seq;
      break;
    }
    next_slab(c, k, nbe, slab_blocks);
    if (pc < nbe) {
      if (t == 0)
        load_slab(slab + (size_t)s * slab_blocks * 64, m, pc, pk, n, nb, nbe, slab_blocks,
                  &full[s]);
      next_slab(pc, pk, nbe, slab_blocks);
      ++issued;
    }
  }
  // no copy may land after the block has gone
  for (int q = seq; q < issued; ++q) mbar_wait(&full[q & 1], (q >> 1) & 1);
  if (keep)
    for (int p = nbe * 64 + t; p < n; p += kScanThreads) keep[(size_t)b * n + p] = 0;
  if (idx)
    for (int q = count + t; q < topk; q += kScanThreads) idx[(size_t)b * topk + q] = -1;
}

}  // namespace

// Greedy NMS over B x n boxes in score order (module comment).  boxes (B,
// n, 4) f32; cls (B, n) f32 or null (every pair may suppress); valid (B, n)
// bytes (0 or 1) or null (every box takes part); scratch of
// mxt_nms_mask_words(n) * B words; keep (B, n) bytes out (1 = kept), or
// null: then only the positions are wanted and the scan ends at the
// topk-th kept box; with topk > 0, idx (B, topk) int64 out: the first topk
// kept positions, -1 after.  Returns the launches' CUDA error (0 on
// success).
extern "C" long long mxt_nms_mask_words(int n) { return n > 0 ? image_words(n) : 0; }

extern "C" int mxt_nms(const float* boxes, const float* cls, const unsigned char* valid,
                       unsigned long long* scratch, unsigned char* keep, long long* idx, int batch,
                       int n, float thresh, int plus_one, int topk, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535 || (keep == nullptr && topk <= 0)) return (int)cudaErrorInvalidValue;
  const int nb = (n + 63) / 64;
  const long long img = image_words(n);
  // two slabs, "removed" and the flag words in the scan's shared memory
  const size_t fixed = (size_t)nb * 2 * sizeof(u64);
  if (fixed + 1024 > (size_t)kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  const int fit = (int)(((size_t)kMaxDynamicSmem - fixed) / (2 * 64 * sizeof(u64)));
  int slab_blocks = kSlabBlocks < nb ? kSlabBlocks : nb;
  if (slab_blocks > fit) slab_blocks = fit;
  const size_t smem = (size_t)slab_blocks * 2 * 64 * sizeof(u64) + fixed;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const long long ntri = (long long)nb * (nb + 1) / 2;
  const long long want = ((long long)kMaskBlocksPerSM * sms + batch - 1) / batch;
  const long long most = (ntri + 3) / 4;  // four tiles a block
  const int per = (int)(want < 1 ? 1 : want > most ? most : want);
  if (valid) {
    const dim3 count_grid((nb + kCountWarps - 1) / kCountWarps, batch);
    mxt_nms_count_kernel<<<count_grid, kCountThreads, 0, stream>>>(valid, scratch, n, nb, img);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 mask_grid(per, batch), scan_grid(batch);
  mxt_nms_mask_kernel<<<mask_grid, kMaskThreads, 0, stream>>>(boxes, cls, valid ? 1 : 0, scratch, n,
                                                              nb, img, thresh, plus_one);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(mxt_nms_scan_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  mxt_nms_scan_kernel<<<scan_grid, kScanThreads, smem, stream>>>(
      scratch, valid ? 1 : 0, keep, topk > 0 ? idx : nullptr, n, nb, img, slab_blocks,
      topk > 0 ? topk : 0);
  return (int)cudaGetLastError();
}
