// Greedy non-maximum suppression for Hopper (sm_90a), in bitmask form.
//
// Replaces no Pallas kernel: the JAX package leaves NMS to XLA (a
// `fori_loop` in `box_nms`, incubator_mxnet_tpu/ops/contrib.py:59, and a
// blocked `fori_loop`/`while_loop` fixpoint in `_nms_keep`,
// incubator_mxnet_tpu/ops/rcnn.py:58).  On the card a per-box loop is N
// tiny launches (2000 per image in Proposal, 24,564 anchors in SSD-512's
// MultiBoxDetection), and the fixpoint's exit depends on the data, which a
// captured CUDA graph cannot hold.  These two launches do the whole pass
// with no host read.
//
// Input: B images of N boxes each, already in score order, (x1, y1, x2, y2)
// f32; optional class ids (f32, compared for equality) and optional
// "takes part" flags.  Box i suppresses a later box j when
//   IoU(i, j) > thresh, and (class-aware) cls[i] == cls[j].
// Greedy result: box i is kept when it takes part and no kept box before
// it suppresses it.
//
//   * Mask launch, grid (nb * nb, B) with nb = ceil(N / 64), 64 threads:
//     block (r, c) with c >= r (the upper triangle; the others return),
//     thread i writes one 64-bit word, bit j set when box c*64+j comes
//     after box r*64+i and is suppressed by it.  mask is (B, N, nb) words.
//   * Scan launch, grid B, 256 threads: walks the chunks of 64 boxes in
//     order with a "removed" bitmask of nb words in shared memory.  One
//     thread resolves a chunk against its diagonal words (64 serial steps,
//     no global loads in the chain), then every thread ORs the kept boxes'
//     words into the removed words after the chunk.
//
// The IoU is computed in the order of operations of the JAX formulas with
// the rounding intrinsics, so nvcc cannot contract a product and a sum
// into an FMA, and `iou > thresh` decides as the plain version does on the
// CPU: either
//   corner (box_nms, `_iou_corner`): union = (area_i + area_j) - inter,
//     IoU = inter / union where union > 0, else 0;
//   plus one (Proposal, `_nms_keep`): widths x2 - x1 + 1, IoU = inter /
//     max(union, 1e-12).
//
// What bounds it: the pairs' IoUs, 13 f32 operations a pair on the CUDA
// cores (every byte of the inputs is read once; the mask is scratch the
// caller allocates: B * N * nb * 8 bytes, 0.6 GB at 8 x 24,564).  The
// scan is one block per image and serial within a chunk; it is the part
// a later design would spread over more of the card.
#include <cuda_runtime.h>

namespace {

constexpr int kMaskThreads = 64;
constexpr int kScanThreads = 256;

__device__ __forceinline__ float iou_corner(float ax1, float ay1, float ax2, float ay2,
                                            float bx1, float by1, float bx2, float by2) {
  const float w = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(ax2, ax1), 0.f), fmaxf(__fsub_rn(ay2, ay1), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(bx2, bx1), 0.f), fmaxf(__fsub_rn(by2, by1), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float iou_plus_one(float ax1, float ay1, float ax2, float ay2,
                                              float bx1, float by1, float bx2, float by2) {
  const float w = fmaxf(__fadd_rn(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 1.f), 0.f);
  const float h = fmaxf(__fadd_rn(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 1.f), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(ax2, ax1), 1.f), 0.f),
                                 fmaxf(__fadd_rn(__fsub_rn(ay2, ay1), 1.f), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fadd_rn(__fsub_rn(bx2, bx1), 1.f), 0.f),
                                 fmaxf(__fadd_rn(__fsub_rn(by2, by1), 1.f), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(kMaskThreads)
mxt_nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ cls,
                    unsigned long long* __restrict__ mask, int n, int nb, float thresh,
                    int plus_one) {
  const int r = blockIdx.x / nb, c = blockIdx.x % nb, b = blockIdx.y;
  if (c < r) return;
  __shared__ float sbox[kMaskThreads][4];
  __shared__ float scls[kMaskThreads];
  const int t = threadIdx.x;
  const int col0 = c * kMaskThreads;
  const int ncol = min(kMaskThreads, n - col0);
  const float* bb = boxes + (size_t)b * n * 4;
  const float* cb = cls ? cls + (size_t)b * n : nullptr;
  if (t < ncol) {
    for (int k = 0; k < 4; ++k) sbox[t][k] = bb[(size_t)(col0 + t) * 4 + k];
    scls[t] = cb ? cb[col0 + t] : 0.f;
  }
  __syncthreads();
  const int i = r * kMaskThreads + t;
  if (i >= n) return;
  const float x1 = bb[(size_t)i * 4], y1 = bb[(size_t)i * 4 + 1];
  const float x2 = bb[(size_t)i * 4 + 2], y2 = bb[(size_t)i * 4 + 3];
  const float ci = cb ? cb[i] : 0.f;
  unsigned long long bits = 0;
  for (int j = (c == r) ? t + 1 : 0; j < ncol; ++j) {
    if (cb && scls[j] != ci) continue;
    const float v = plus_one
        ? iou_plus_one(x1, y1, x2, y2, sbox[j][0], sbox[j][1], sbox[j][2], sbox[j][3])
        : iou_corner(x1, y1, x2, y2, sbox[j][0], sbox[j][1], sbox[j][2], sbox[j][3]);
    if (v > thresh) bits |= 1ull << j;
  }
  mask[((size_t)b * n + i) * nb + c] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
mxt_nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    const unsigned char* __restrict__ valid, unsigned char* __restrict__ keep,
                    long long* __restrict__ idx, int n, int nb, int topk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* removed = reinterpret_cast<unsigned long long*>(smem);
  __shared__ unsigned long long diag[64];
  __shared__ unsigned char part[64];
  __shared__ unsigned long long kept_bits;
  __shared__ int count;
  const int b = blockIdx.x, t = threadIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * nb;
  for (int w = t; w < nb; w += kScanThreads) removed[w] = 0;
  if (t == 0) count = 0;
  for (int c = 0; c < nb; ++c) {
    const int base = c * 64, len = min(64, n - base);
    if (t < len) {
      diag[t] = m[(size_t)(base + t) * nb + c];
      part[t] = valid ? valid[(size_t)b * n + base + t] : 1;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[c], kb = 0;
      int cnt = count;
      for (int j = 0; j < len; ++j) {
        if (!part[j] || ((rem >> j) & 1ull)) continue;
        kb |= 1ull << j;
        rem |= diag[j];
        if (cnt < topk) idx[(size_t)b * topk + cnt++] = base + j;
      }
      count = cnt;
      kept_bits = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    if (t < len) keep[(size_t)b * n + base + t] = (unsigned char)((kb >> t) & 1ull);
    for (int w = c + 1 + t; w < nb; w += kScanThreads) {
      unsigned long long acc = 0, bits = kb;
      while (bits) {
        const int j = __ffsll((long long)bits) - 1;
        bits &= bits - 1;
        acc |= m[(size_t)(base + j) * nb + w];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
  for (int q = count + t; q < topk; q += kScanThreads) idx[(size_t)b * topk + q] = -1;
}

}  // namespace

// Greedy NMS over B x n boxes in score order (module comment).  boxes (B,
// n, 4) f32; cls (B, n) f32 or null (every pair may suppress); valid (B, n)
// bytes or null (every box takes part); mask scratch of
// mxt_nms_mask_words(n) * B * n words; keep (B, n) bytes out (1 = kept);
// with topk > 0, idx (B, topk) int64 out: the first topk kept positions,
// -1 after.  Returns the launches' CUDA error (0 on success).
extern "C" int mxt_nms_mask_words(int n) { return (n + 63) / 64; }

extern "C" int mxt_nms(const float* boxes, const float* cls, const unsigned char* valid,
                       unsigned long long* mask, unsigned char* keep, long long* idx, int batch,
                       int n, float thresh, int plus_one, int topk, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int nb = (n + 63) / 64;
  const size_t smem = (size_t)nb * sizeof(unsigned long long);
  if (batch > 65535 || (long long)nb * nb > 2147483647LL || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 mask_grid(nb * nb, batch), scan_grid(batch);
  mxt_nms_mask_kernel<<<mask_grid, kMaskThreads, 0, stream>>>(
      boxes, cls, mask, n, nb, thresh, plus_one);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  mxt_nms_scan_kernel<<<scan_grid, kScanThreads, smem, stream>>>(
      mask, valid, keep, topk > 0 ? idx : nullptr, n, nb, topk > 0 ? topk : 0);
  return (int)cudaGetLastError();
}
