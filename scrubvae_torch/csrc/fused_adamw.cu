// Fused AdamW update of many parameter leaves in one launch, in place, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scrubvae_tpu/ops/fused_adamw.py:77 `_kernel`
// (launched by `fused_adamw_leaf`, helper `_sround_bits`). Per element:
//
//   g  = g * gscale
//   m  = b1 * mu + (1 - b1) * g
//   n  = b2 * nu + (1 - b2) * g * g
//   upd = (m / b1c) / (sqrt(max(n, 0) / b2c) + eps)
//   w  = w - lr * (upd + wd * w)
//
// w, mu and nu are read and written back in place. A bf16 store of w, mu or
// nu uses stochastic rounding: 16 random bits are added to the f32 word and
// the low half is dropped, which is unbiased in expectation, so increments
// far below bf16's ulp still integrate.
//
// What bounds it: bytes. An element moves 14 B with bf16 w and moments (read
// w, g, mu, nu; write w, mu, nu) and 28 B with all f32, against 3.35 TB/s;
// its ~20 f32 operations are a fifth of that time or less. The random bits
// are integer work: one Philox-4x32-10 draw is 10 rounds of two 32x32->64
// multiplies, two three-way XORs and two key additions, about 80 integer
// instructions for 128 bits.
//
// What the design does about it:
// - One launch per dtype variant for any number of leaves. A leaf table on
//   the device (built once by LeafTable in ops/fused_adamw.py) holds each
//   leaf's w, mu, nu and optional noise pointers, its size and its Philox
//   leaf word; a chunk table maps each block to (leaf, chunk of the leaf),
//   so a block never straddles leaves and the variant is uniform in a
//   launch. The gradients are new tensors every step: their pointers travel
//   by value in the kernel's parameter struct (__grid_constant__, read in
//   place), at most kMaxLeaves of them; the wrapper splits larger trees.
// - 16-byte vector access. A thread owns one group of 8 consecutive
//   elements: one 16-byte vector of each bf16 array, two of each f32 array,
//   so 64 B (bf16) or 128 B (f32) a thread are in flight at once. A chunk is
//   128 threads x 8 = 1024 elements. One group a thread keeps the kernel at
//   about 62 registers, so an SM holds 32 warps (1024 threads, 64 KB of
//   bf16 loads in flight) and other warps' loads cover one warp's
//   arithmetic. Two groups a thread, the first design, took 122 registers,
//   halved the resident warps and was slower in bf16, whose Philox and
//   IEEE-divide work then no longer hid under the loads. The last, partial
//   group of a leaf and every group of a leaf whose base pointers are not
//   16-byte aligned go through masked scalar loads and stores in the same
//   kernel.
// - Philox spread over eight elements. An element needs at most three
//   16-bit noises (rows w, m, n), so a group of 8 takes 3 draws (24 halves),
//   not 8: draw d of group q has counter (q low word, (q >> 32) << 2 | d,
//   leaf, step) and key (seed low, seed high); element 8q + j takes half
//   3j + r of the 24 for row r (half h is word h >> 1 of draw h >> 3, low
//   16 bits when h is even). The bits depend on (seed, leaf, step, element)
//   only, never on the block size, the vector width or the grid. Variants
//   with no bf16 store draw nothing.
// - An optional per-leaf `noise` buffer (int32, (3, n), rows w, m, n, values
//   in [0, 65536)) replaces Philox so that the kernel can also be held
//   bitwise against its plain PyTorch version on given bits.
// - The per-step scalars (lr, b1c, b2c, gscale) are read from a 4-float
//   device buffer, so a training step never waits on the host. The kernel
//   allocates nothing.
//
// Build with -fmad=false: PyTorch computes the same formula as separate
// elementwise ops, each rounded on its own; contracting a*b+c into one FMA
// here would round differently and break the bitwise comparison.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;  // elements of one Philox triple and one bf16 vector
constexpr int64_t kChunkElems = int64_t(kThreads) * kGroup;  // one group a thread
constexpr int kMaxLeaves = 256;

// One row of the device leaf table: six int64 words, in this order, written
// by LeafTable in ops/fused_adamw.py.
struct Leaf {
  void* w;
  void* mu;
  void* nu;
  const int32_t* noise;  // null: Philox bits
  int64_t n;
  uint32_t leaf;     // the Philox leaf word
  uint32_t aligned;  // w, mu and nu 16-byte aligned
};
static_assert(sizeof(Leaf) == 48, "Leaf must match LeafTable's six int64 words");

struct Params {
  const Leaf* leaves;  // this launch's rows of the leaf table
  const int2* chunks;  // (slot in `leaves`, chunk of that leaf) per block
  const float* scal;   // lr, b1c, b2c, gscale
  float b1, omb1, b2, omb2, eps, wd;
  uint64_t seed;
  uint32_t step;
  const void* g[kMaxLeaves];  // gradient of each slot
};
static_assert(sizeof(Params) <= 4096, "kernel parameters are limited to 4 KB");

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// The 24 noises of group q: nz[r][j] for row r of element 8q + j.
__device__ __forceinline__ void philox_group(int64_t q, uint32_t leaf, uint32_t step, uint2 key,
                                             uint32_t (&nz)[3][kGroup]) {
  uint32_t words[12];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const uint32_t hi = static_cast<uint32_t>((static_cast<uint64_t>(q) >> 32) << 2);
    const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(q), hi | d, leaf, step), key);
    words[4 * d] = r.x;
    words[4 * d + 1] = r.y;
    words[4 * d + 2] = r.z;
    words[4 * d + 3] = r.w;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int h = 3 * j + r;
      const uint32_t wd = words[h >> 1];
      nz[r][j] = (h & 1) ? (wd >> 16) : (wd & 0xFFFFu);
    }
  }
}

// Injected noise of group q (elements i0 .. i0 + cnt - 1 of the leaf).
__device__ __forceinline__ void noise_group(const int32_t* noise, int64_t n, int64_t i0, int cnt,
                                            bool vec, uint32_t (&nz)[3][kGroup]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int32_t* row = noise + r * n + i0;
    if (vec) {
      const int4 a = reinterpret_cast<const int4*>(row)[0];
      const int4 b = reinterpret_cast<const int4*>(row)[1];
      const int32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < kGroup; ++j) nz[r][j] = static_cast<uint32_t>(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) nz[r][j] = j < cnt ? static_cast<uint32_t>(row[j]) : 0u;
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Eight elements at p (16-byte aligned), as f32.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[kGroup]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[kGroup]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k is the low half of word k
    x[2 * k] = __uint_as_float(u[k] << 16);
    x[2 * k + 1] = __uint_as_float(u[k] & 0xFFFF0000u);
  }
}

template <typename T>
__device__ __forceinline__ void load_scalar(const T* p, int cnt, float (&x)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) x[j] = j < cnt ? to_f32(p[j]) : 0.f;
}

// Stochastically rounded f32 -> bf16 bits: add 16 noise bits, keep the high half.
__device__ __forceinline__ uint32_t sround_bits(float x, uint32_t noise16) {
  return (__float_as_uint(x) + noise16) >> 16;
}

__device__ __forceinline__ void store_vec(float* p, const float (&x)[kGroup], const uint32_t (&)[kGroup]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[kGroup],
                                          const uint32_t (&nz)[kGroup]) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = sround_bits(x[2 * k], nz[2 * k]) | (sround_bits(x[2 * k + 1], nz[2 * k + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void store_scalar(float* p, int cnt, const float (&x)[kGroup],
                                             const uint32_t (&)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (j < cnt) p[j] = x[j];
}
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, int cnt, const float (&x)[kGroup],
                                             const uint32_t (&nz)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    if (j < cnt) p[j] = __ushort_as_bfloat16(static_cast<unsigned short>(sround_bits(x[j], nz[j])));
}

template <typename WT, typename MT>
__global__ void __launch_bounds__(kThreads) fused_adamw_kernel(const __grid_constant__ Params p) {
  constexpr bool kRound = sizeof(WT) == 2 || sizeof(MT) == 2;
  const int2 ch = p.chunks[blockIdx.x];
  const Leaf lf = p.leaves[ch.x];
  WT* __restrict__ w = static_cast<WT*>(lf.w);
  const WT* __restrict__ g = static_cast<const WT*>(p.g[ch.x]);
  MT* __restrict__ mu = static_cast<MT*>(lf.mu);
  MT* __restrict__ nu = static_cast<MT*>(lf.nu);
  const int64_t n = lf.n;
  const int64_t q = static_cast<int64_t>(ch.y) * kThreads + threadIdx.x;  // group of the leaf
  const int64_t i0 = q * kGroup;
  if (i0 >= n) return;
  const int cnt = n - i0 >= kGroup ? kGroup : static_cast<int>(n - i0);
  // g is new every step, so its alignment is checked here, not in the table
  const bool vec = cnt == kGroup && lf.aligned && (reinterpret_cast<uintptr_t>(g) & 15u) == 0;

  float xw[kGroup], xg[kGroup], xm[kGroup], xn[kGroup];
  if (vec) {
    load_vec(g + i0, xg);
    load_vec(mu + i0, xm);
    load_vec(nu + i0, xn);
    load_vec(w + i0, xw);
  } else {
    load_scalar(g + i0, cnt, xg);
    load_scalar(mu + i0, cnt, xm);
    load_scalar(nu + i0, cnt, xn);
    load_scalar(w + i0, cnt, xw);
  }

  const float lr = p.scal[0], b1c = p.scal[1], b2c = p.scal[2], gscale = p.scal[3];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float gs = xg[j] * gscale;
    const float m = p.b1 * xm[j] + p.omb1 * gs;
    const float nv = p.b2 * xn[j] + p.omb2 * (gs * gs);
    const float vpos = (nv != nv) ? nv : fmaxf(nv, 0.f);  // max(n, 0), NaN kept
    const float upd = (m / b1c) / (sqrtf(vpos / b2c) + p.eps);
    const float wf = xw[j];
    xw[j] = wf - lr * (upd + p.wd * wf);
    xm[j] = m;
    xn[j] = nv;
  }

  uint32_t nz[3][kGroup] = {};
  if (kRound) {
    if (lf.noise != nullptr) {
      const bool noise_vec = cnt == kGroup && (reinterpret_cast<uintptr_t>(lf.noise) & 15u) == 0 &&
                             (n & 3) == 0;
      noise_group(lf.noise, n, i0, cnt, noise_vec, nz);
    } else {
      const uint2 key = make_uint2(static_cast<uint32_t>(p.seed), static_cast<uint32_t>(p.seed >> 32));
      philox_group(q, lf.leaf, p.step, key, nz);
    }
  }
  if (vec) {
    store_vec(w + i0, xw, nz[0]);
    store_vec(mu + i0, xm, nz[1]);
    store_vec(nu + i0, xn, nz[2]);
  } else {
    store_scalar(w + i0, cnt, xw, nz[0]);
    store_scalar(mu + i0, cnt, xm, nz[1]);
    store_scalar(nu + i0, cnt, xn, nz[2]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch over `n_chunks` chunks
// of the `n_leaves` table rows at `leaves`, all of one dtype variant.
// `grads` is a host array of n_leaves device pointers, copied into the
// kernel's parameters. `chunk_elems` must equal the kernel's chunk size (the
// tables were cut for it). Returns the cudaError_t of the launch; 0 means the
// kernel was enqueued on `stream`.
extern "C" int fused_adamw_multi_launch(const void* leaves, const void* chunks, int n_chunks,
                                        const void* const* grads, int n_leaves, int w_bf16,
                                        int m_bf16, const void* scal, float b1, float omb1,
                                        float b2, float omb2, float eps, float wd, uint64_t seed,
                                        uint32_t step, int64_t chunk_elems, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || chunk_elems != kChunkElems || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  Params p;
  memset(&p, 0, sizeof(p));
  p.leaves = static_cast<const Leaf*>(leaves);
  p.chunks = static_cast<const int2*>(chunks);
  p.scal = static_cast<const float*>(scal);
  p.b1 = b1;
  p.omb1 = omb1;
  p.b2 = b2;
  p.omb2 = omb2;
  p.eps = eps;
  p.wd = wd;
  p.seed = seed;
  p.step = step;
  memcpy(p.g, grads, sizeof(void*) * n_leaves);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chunks)), block(kThreads);
  if (w_bf16 && m_bf16)
    fused_adamw_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, block, 0, st>>>(p);
  else if (w_bf16)
    fused_adamw_kernel<__nv_bfloat16, float><<<grid, block, 0, st>>>(p);
  else if (m_bf16)
    fused_adamw_kernel<float, __nv_bfloat16><<<grid, block, 0, st>>>(p);
  else
    fused_adamw_kernel<float, float><<<grid, block, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
