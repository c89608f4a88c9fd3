// CPU emulation of the CUDA pieces that incubator_mxnet_tpu_torch's kernels
// use, so that their source can be compiled with a host C++ compiler and run
// on small inputs where there is no card (tests/test_torch_bwd_kernels_
// emulated.py, tests/test_torch_kernels_emulated.py).
//
// A block's CUDA threads are cooperative threads of one host thread; blocks
// run one after another, so a kernel's static __shared__ arrays are static
// locals, one per kernel, that each block finds as the last one left them.
// __syncthreads is a barrier of the block's threads.  The warp-wide
// instructions (ldmatrix, mma.sync, shfl, ballot, redux) are collectives: each
// lane posts its operands, the warp meets at a barrier, each lane reads what
// the PTX ISA says it receives, and the warp meets again.  cp.async and the
// bulk copy (cp.async.bulk) copy at once, so their waits, and the mbarrier a
// bulk copy completes on, are no-ops.  The card has emu::kSmCount SMs.  An mma sums its products and accumulator in double and
// rounds the sum to f32 toward zero, as the tensor cores do (the card matched
// that rounding in 9 sums of 10, bwd_precision_study.py); the tests hold the
// results to f32 or bf16 tolerances, not to the card's bits.
// A tf32 operand is read from its top 19 bits, as the tensor cores read it.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <ucontext.h>
#include <vector>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
uint3 threadIdx;
uint3 blockIdx;
uint3 gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// 232,448 bytes is the most dynamic shared memory a block may opt into
template <class K>
int cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) { return bytes > 232448 ? 1 : 0; }
inline int cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
using std::min;
using std::max;

struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
// the rounding intrinsics: one IEEE operation each (a host build for x86-64
// has no FMA to contract them into)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __clzll(long long x) { return x ? __builtin_clzll(x) : 64; }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {  // nearest even
  uint32_t b = __float_as_uint(f);
  b += 0x7fffu + ((b >> 16) & 1u);
  return {static_cast<uint16_t>(b >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float((uint32_t)h.x << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

struct __half { uint16_t x; };
struct __half2 { __half x, y; };
inline __half __float2half_rn(float f) {  // nearest even; past 65504 to inf
  const uint32_t u = __float_as_uint(f), sign = (u >> 16) & 0x8000u, a = u & 0x7fffffffu;
  if (a >= 0x7f800000u) return {static_cast<uint16_t>(sign | (a > 0x7f800000u ? 0x7e00u : 0x7c00u))};
  if (a >= 0x477ff000u) return {static_cast<uint16_t>(sign | 0x7c00u)};
  if (a < 0x38800000u)  // below 2**-14: a multiple of 2**-24, exact in f32 after scaling
    return {static_cast<uint16_t>(sign | (uint32_t)std::nearbyint(__uint_as_float(a) * 16777216.f))};
  uint32_t h = ((a >> 23) - 112) << 10 | (a & 0x7fffffu) >> 13;
  const uint32_t rest = a & 0x1fffu;
  h += rest > 0x1000u || (rest == 0x1000u && (h & 1u));
  return {static_cast<uint16_t>(sign | h)};
}
inline float __half2float(__half h) {
  const uint32_t sign = (uint32_t)(h.x & 0x8000u) << 16, e = (h.x >> 10) & 0x1fu, m = h.x & 0x3ffu;
  if (e == 0) return __uint_as_float(sign | __float_as_uint(m * 5.9604644775390625e-8f));
  if (e == 31) return __uint_as_float(sign | 0x7f800000u | m << 13);
  return __uint_as_float(sign | (e + 112) << 23 | m << 13);
}
inline __half2 __floats2half2_rn(float a, float b) { return {__float2half_rn(a), __float2half_rn(b)}; }

namespace emu {
// one SM, so that a grid sized to the card is small and its blocks stride
constexpr int kSmCount = 1;
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemBytes = 232448;
constexpr size_t kStackBytes = 64 * 1024;
alignas(16) unsigned char smem[kSmemBytes];

// A block's threads are cooperative user-level threads (ucontext) that a
// round-robin scheduler resumes in turn; a thread runs until it waits at a
// barrier or ends.  Deterministic, and no OS thread per CUDA thread.
struct Barrier { int count, arrived; long generation; };
ucontext_t scheduler;
ucontext_t context[kMaxThreads];
bool done[kMaxThreads];
int current;
const std::function<void()>* body;
Barrier block_barrier;
Barrier warp_barrier[kMaxThreads / 32];
struct Slot { const void* p; uint32_t a[4], b[2]; float f; uint64_t u; };
Slot slot[kMaxThreads / 32][32];  // what each lane posts for a collective

inline int warp() { return threadIdx.x / 32; }
inline int lane() { return threadIdx.x % 32; }

inline void arrive_and_wait(Barrier& b) {
  const long generation = b.generation;
  if (++b.arrived == b.count) {  // the last to arrive releases the others
    b.arrived = 0;
    ++b.generation;
    return;
  }
  while (b.generation == generation) swapcontext(&context[current], &scheduler);
}
inline void warp_sync() { arrive_and_wait(warp_barrier[warp()]); }

inline void thread_main() {
  (*body)();
  done[current] = true;
}

// every block of `grid`, each with `threads` threads running `fn`
inline void launch(dim3 grid, int threads, size_t smem_bytes, const std::function<void()>& fn) {
  std::unique_ptr<char[]> stacks(new char[threads * kStackBytes]);
  body = &fn;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      gridDim = {grid.x, grid.y, grid.z};
      std::memset(smem, 0x7f, smem_bytes);  // stale shared memory reads as huge floats
      block_barrier = {threads, 0, 0};
      for (int w = 0; w < threads / 32; ++w) warp_barrier[w] = {32, 0, 0};
      for (int i = 0; i < threads; ++i) {
        getcontext(&context[i]);
        context[i].uc_stack.ss_sp = stacks.get() + i * kStackBytes;
        context[i].uc_stack.ss_size = kStackBytes;
        context[i].uc_link = &scheduler;
        makecontext(&context[i], thread_main, 0);
        done[i] = false;
      }
      for (int running = threads; running > 0;) {
        running = 0;
        for (int i = 0; i < threads; ++i) {
          if (done[i]) continue;
          current = i;
          threadIdx = {static_cast<unsigned>(i), 0, 0};
          swapcontext(&scheduler, &context[i]);
          running += !done[i];
        }
      }
    }
}

inline float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
inline float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
inline float f16_lo(uint32_t u) { return __half2float({static_cast<uint16_t>(u)}); }
inline float f16_hi(uint32_t u) { return __half2float({static_cast<uint16_t>(u >> 16)}); }
inline float tf32(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }

// d = a.b + c for this lane's four accumulator elements (rows lane/4 and
// lane/4 + 8, columns 2*(lane%4) + {0, 1}) of a 16 x 8 tile
template <int K>
void mma_lane(float (&c)[4], const float (&A)[16][K], const float (&B)[K][8]) {
  const int g = lane() / 4, t = lane() % 4;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    double acc = c[e];
    for (int k = 0; k < K; ++k) acc += (double)A[rows[e]][k] * B[k][cols[e]];
    // to f32 toward zero, as the tensor cores round their sums
    float r = static_cast<float>(acc);
    if (std::fabs(static_cast<double>(r)) > std::fabs(acc)) r = std::nextafter(r, 0.f);
    c[e] = r;
  }
}
}  // namespace emu

inline void __syncthreads() { emu::arrive_and_wait(emu::block_barrier); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  emu::slot[emu::warp()][emu::lane()].f = v;
  emu::warp_sync();
  const float r = emu::slot[emu::warp()][emu::lane() ^ mask].f;
  emu::warp_sync();
  return r;
}

inline int cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = emu::kSmCount;
  return 0;
}

// what `reduce` makes of every lane's 64-bit `v`, read between the warp's
// two meetings into this lane's own copy
namespace emu {
template <class F>
inline uint64_t warp_collective(uint64_t v, F reduce) {
  slot[warp()][lane()].u = v;
  warp_sync();
  uint64_t got[32];
  for (int l = 0; l < 32; ++l) got[l] = slot[warp()][l].u;
  const uint64_t r = reduce(got);
  warp_sync();
  return r;
}
}  // namespace emu

inline unsigned __ballot_sync(unsigned, int pred) {
  return static_cast<unsigned>(emu::warp_collective(pred != 0, [](const uint64_t* got) {
    uint64_t bits = 0;
    for (int l = 0; l < 32; ++l) bits |= static_cast<uint64_t>(got[l] != 0) << l;
    return bits;
  }));
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return static_cast<unsigned>(emu::warp_collective(v, [](const uint64_t* got) {
    uint64_t r = 0;
    for (int l = 0; l < 32; ++l) r |= got[l];
    return r;
  }));
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return static_cast<unsigned>(emu::warp_collective(v, [](const uint64_t* got) {
    uint64_t r = 0;
    for (int l = 0; l < 32; ++l) r = std::max(r, got[l]);
    return r;
  }));
}

// the mbarrier and the bulk asynchronous copy: the copy lands at once
inline void mbar_init(unsigned long long*) {}
inline void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long*) {
  std::memcpy(dst, src, bytes);
}
inline void mbar_wait(unsigned long long*, int) {}

inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N> inline void cp_async_wait() {}

// ldmatrix .x4: lanes 8m..8m+7 give the row addresses of 8x8 matrix m; lane
// L receives row L/4, columns 2(L%4), 2(L%4)+1 of each matrix, or with .trans
// rows 2(L%4), 2(L%4)+1 of column L/4
inline void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  const int w = emu::warp(), g = emu::lane() / 4, t = emu::lane() % 4;
  emu::slot[w][emu::lane()].p = p;
  emu::warp_sync();
  for (int m = 0; m < 4; ++m) {
    uint16_t lo, hi;
    if (!trans) {
      const uint16_t* row = static_cast<const uint16_t*>(emu::slot[w][8 * m + g].p);
      lo = row[2 * t];
      hi = row[2 * t + 1];
    } else {
      lo = static_cast<const uint16_t*>(emu::slot[w][8 * m + 2 * t].p)[g];
      hi = static_cast<const uint16_t*>(emu::slot[w][8 * m + 2 * t + 1].p)[g];
    }
    r[m] = lo | (static_cast<uint32_t>(hi) << 16);
  }
  emu::warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, true); }

// mma.sync.m16n8k16.row.col.f32.{bf16,f16}: `lo` and `hi` read the two
// 16-bit values of a 32-bit register
template <float (*lo)(uint32_t), float (*hi)(uint32_t)>
inline void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = emu::warp();
  emu::Slot& mine = emu::slot[w][emu::lane()];
  std::copy(a, a + 4, mine.a);
  mine.b[0] = b0;
  mine.b[1] = b1;
  emu::warp_sync();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const emu::Slot& o = emu::slot[w][L];
    const int g = L / 4, t = L % 4;
    for (int h = 0; h < 2; ++h) {  // a0..a3: (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
      A[g + 8 * h][2 * t] = lo(o.a[h]);
      A[g + 8 * h][2 * t + 1] = hi(o.a[h]);
      A[g + 8 * h][2 * t + 8] = lo(o.a[2 + h]);
      A[g + 8 * h][2 * t + 9] = hi(o.a[2 + h]);
      B[2 * t + 8 * h][g] = lo(o.b[h]);  // b0, b1: rows 2t(+8), 2t+1(+8)
      B[2 * t + 8 * h + 1][g] = hi(o.b[h]);
    }
  }
  emu::warp_sync();
  emu::mma_lane<16>(c, A, B);
}
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma_m16n8k16<emu::bf16_lo, emu::bf16_hi>(c, a, b0, b1);
}
inline void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma_m16n8k16<emu::f16_lo, emu::f16_hi>(c, a, b0, b1);
}

// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = emu::warp();
  emu::Slot& mine = emu::slot[w][emu::lane()];
  std::copy(a, a + 4, mine.a);
  mine.b[0] = b0;
  mine.b[1] = b1;
  emu::warp_sync();
  float A[16][8], B[8][8];
  for (int L = 0; L < 32; ++L) {
    const emu::Slot& o = emu::slot[w][L];
    const int g = L / 4, t = L % 4;
    A[g][t] = emu::tf32(o.a[0]);
    A[g + 8][t] = emu::tf32(o.a[1]);
    A[g][t + 4] = emu::tf32(o.a[2]);
    A[g + 8][t + 4] = emu::tf32(o.a[3]);
    B[t][g] = emu::tf32(o.b[0]);
    B[t + 4][g] = emu::tf32(o.b[1]);
  }
  emu::warp_sync();
  emu::mma_lane<8>(c, A, B);
}
