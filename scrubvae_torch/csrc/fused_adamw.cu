// Fused AdamW update of one parameter leaf, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scrubvae_tpu/ops/fused_adamw.py `_kernel`
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
// Bound: memory bandwidth. Each element does ~20 flops and moves
// 14 bytes (bf16 w, g, mu, nu read; w, mu, nu written) or 28 bytes (all f32);
// at 3.35 TB/s that is far below the ~295 flop/byte ridge of the H100.
// This first version is deliberately simple: one element per thread, scalar
// loads, no vectorisation and one launch per leaf. Making the loads 16 bytes
// wide and batching all leaves into one multi-tensor launch are later work.
//
// The per-step scalars (lr, b1c, b2c, gscale) are read from a device f32
// buffer so that a training step never waits on the host. The random bits
// come from a counter-based Philox-4x32-10 keyed by (seed) and countered by
// (element, leaf, step); one draw supplies the three 16-bit noises an
// element needs. An optional `noise` buffer (int32, (3, n), rows w, m, n,
// values in [0, 65536)) replaces Philox so that the kernel can be held
// bitwise against its plain PyTorch version.
//
// Build with -fmad=false: PyTorch computes the same formula as separate
// elementwise ops, each rounded on its own; contracting a*b+c into one FMA
// here would round differently and break the bitwise comparison.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// Stochastically rounded f32 -> bf16: add 16 noise bits, keep the high half.
__device__ __forceinline__ __nv_bfloat16 sround(float x, uint32_t noise16) {
  const uint32_t bits = (__float_as_uint(x) + noise16) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

__device__ __forceinline__ void store(float* p, int64_t i, float x, uint32_t) { p[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float x, uint32_t noise16) {
  p[i] = sround(x, noise16);
}

template <typename WT, typename MT>
__global__ void fused_adamw_kernel(WT* __restrict__ w, const WT* __restrict__ g,
                                   MT* __restrict__ mu, MT* __restrict__ nu,
                                   const float* __restrict__ scal,
                                   const int32_t* __restrict__ noise, int64_t n,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, float wd, uint64_t seed,
                                   uint32_t leaf, uint32_t step) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float lr = scal[0], b1c = scal[1], b2c = scal[2], gscale = scal[3];

  const float gs = load_f32(g, i) * gscale;
  const float m = b1 * load_f32(mu, i) + omb1 * gs;
  const float v = b2 * load_f32(nu, i) + omb2 * (gs * gs);
  const float vpos = (v != v) ? v : fmaxf(v, 0.f);  // max(n, 0), NaN kept
  const float upd = (m / b1c) / (sqrtf(vpos / b2c) + eps);
  const float wf = load_f32(w, i);
  const float nw = wf - lr * (upd + wd * wf);

  uint32_t nz_w = 0, nz_m = 0, nz_n = 0;
  constexpr bool kRound = sizeof(WT) == 2 || sizeof(MT) == 2;
  if (kRound) {
    if (noise != nullptr) {
      nz_w = static_cast<uint32_t>(noise[i]);
      nz_m = static_cast<uint32_t>(noise[n + i]);
      nz_n = static_cast<uint32_t>(noise[2 * n + i]);
    } else {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), leaf, step),
          make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
      nz_w = r.x & 0xFFFFu;
      nz_m = r.y & 0xFFFFu;
      nz_n = r.z & 0xFFFFu;
    }
  }
  store(w, i, nw, nz_w);
  store(mu, i, m, nz_m);
  store(nu, i, v, nz_n);
}

template <typename WT, typename MT>
cudaError_t launch(void* w, const void* g, void* mu, void* nu, const float* scal,
                   const int32_t* noise, int64_t n, float b1, float omb1, float b2,
                   float omb2, float eps, float wd, uint64_t seed, uint32_t leaf,
                   uint32_t step, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fused_adamw_kernel<WT, MT><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<WT*>(w), static_cast<const WT*>(g), static_cast<MT*>(mu),
      static_cast<MT*>(nu), scal, noise, n, b1, omb1, b2, omb2, eps, wd, seed, leaf, step);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means the kernel was enqueued on `stream`.
extern "C" int fused_adamw_launch(void* w, const void* g, void* mu, void* nu,
                                  const void* scal, const void* noise, int64_t n,
                                  int w_bf16, int m_bf16, float b1, float omb1,
                                  float b2, float omb2, float eps, float wd,
                                  uint64_t seed, uint32_t leaf, uint32_t step,
                                  void* stream) {
  if (n <= 0) return 0;
  const float* s = static_cast<const float*>(scal);
  const int32_t* nz = static_cast<const int32_t*>(noise);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16 && m_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(w, g, mu, nu, s, nz, n, b1, omb1, b2, omb2, eps, wd, seed, leaf, step, st);
  else if (w_bf16)
    err = launch<__nv_bfloat16, float>(w, g, mu, nu, s, nz, n, b1, omb1, b2, omb2, eps, wd, seed, leaf, step, st);
  else if (m_bf16)
    err = launch<float, __nv_bfloat16>(w, g, mu, nu, s, nz, n, b1, omb1, b2, omb2, eps, wd, seed, leaf, step, st);
  else
    err = launch<float, float>(w, g, mu, nu, s, nz, n, b1, omb1, b2, omb2, eps, wd, seed, leaf, step, st);
  return static_cast<int>(err);
}
