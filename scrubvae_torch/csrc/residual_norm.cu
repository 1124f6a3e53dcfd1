// The post-norm tail of a transformer block, norm(x + dropout(y)), forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.Dropout, the
// residual add and nn.LayerNorm to XLA, which fuses them. Eagerly, PyTorch
// runs each op of the tail as its own kernel (the mask's compare and
// scale, the add, two row means, five (rows, 1) ops, the affine), about
// 15 forward and 25 backward a tail, each a pass over the (rows, d)
// tensors.
//
// Forward, per row of d features (f32), with the keep mask drawn by the
// caller (bool, or none: then s = x + y):
//
//   s    = x + (keep ? y * inv_keep : 0)     inv_keep = 1 / (1 - rate), f32
//   mean = sum(s) * inv_d
//   var  = sum(s * s) * inv_d - mean * mean, held at 0 where below
//   out  = (s - mean) * (rsqrt(var + eps) * w) + b
//
// as the plain version's torch ops compute it on the card: a division by a
// Python scalar is a product with the f32 reciprocal, a mean is the sum
// times the f32 factor rows / (rows * d), rsqrtf is what torch.rsqrt
// calls, and -fmad=false keeps every product and sum rounded on its own.
// Only the order of the row sums differs. Per row the forward keeps the
// mean and rstd, rstd negated where the clamp held var at 0.
//
// Backward, with xh = (s - mean) * rstd, gw = g * w, A = sum(gw) and
// B = sum(gw * xh) over the row, f = inv_d:
//
//   ds = rstd * (gw - f * (A + B * xh))     B taken as 0 where the clamp held
//   dx = ds,  dy = keep ? ds * inv_keep : 0
//   dw = sum over rows of g * xh,  db = sum over rows of g
//
// the derivative of the forward's form (the clamp passes the gradient
// where var >= 0, as torch.clamp's backward does).
//
// What bounds it: bytes, far below the card's ridge (about 10 f32 operations
// an element forward, 20 backward). At the transformer's (26,112, 128) a
// tensor is 13.37 MB and the mask 3.34 MB: the forward reads x, y, keep and
// writes out (43.4 MB, 13.0 us at 3.35 TB/s); the backward reads g, x, y,
// keep and writes dx, dy (70.2 MB, 21.0 us; 56.8 MB where x needs no
// gradient).
//
// What the design does about it:
// - One warp a row, lanes over the row in 16-byte chunks (4 floats and 4
//   mask bytes a lane; scalar chunks where d is not a multiple of 4 or a
//   pointer is not aligned), so any d runs. The sum and the sum of squares
//   are one pass and one butterfly of shuffles, which leaves the same
//   value in every lane.
// - s is never stored: the forward's second pass and the backward compute
//   it again from x, y and keep, whose lines the row's first pass has just
//   brought into L1 and L2, so device memory sees each input once. Saving s
//   would move the same bytes (a write forward, a read backward, in place
//   of the backward's reads of x and y) and hold 13.37 MB more a tail.
// - dw and db without atomics, in a fixed order: each warp adds its rows'
//   g * xh and g into its own slice of shared memory (a lane touches only
//   its own columns), each block sums its warps in order into one partial
//   row of a (blocks, 2, d) scratch, and a second kernel sums the partials
//   in order. The block count depends on the row count alone, so two runs
//   give the same bits. It replaces the two column sums over all rows,
//   about 35 us each, that autograd runs a tail.
// - Launches on the caller's stream, no allocation and no host sync, so a
//   CUDA graph captures it; each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps a block, one row at a time each
constexpr int kBackBlocks = 1024;  // most blocks of the backward (partial rows of dw, db)
constexpr int kSumRows = 32;       // threads down the partials a column, in the partials' sum

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// s of the V features at element `off`: x + (keep ? y * inv_keep : 0), or
// x + y without a mask; k the mask's bytes (1 without a mask)
template <int V>
__device__ __forceinline__ void residual(const float* x, const float* y, const unsigned char* keep,
                                         float inv_keep, size_t off, float (&s)[V],
                                         unsigned char (&k)[V]) {
  float a[V], b[V];
  load<V>(x + off, a);
  load<V>(y + off, b);
  if (keep == nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = a[i] + b[i], k[i] = 1;
    return;
  }
  if constexpr (V == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(keep + off);
    k[0] = t.x, k[1] = t.y, k[2] = t.z, k[3] = t.w;
  } else {
    k[0] = keep[off];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = a[i] + (k[i] ? b[i] * inv_keep : 0.0f);
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    residual_norm_forward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                 const unsigned char* __restrict__ keep, const float* __restrict__ w,
                                 const float* __restrict__ b, float* __restrict__ out,
                                 float* __restrict__ stats, int64_t rows, int d, float inv_keep,
                                 float inv_d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = d / V;
  const size_t base = static_cast<size_t>(row) * d;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    float s[V];
    unsigned char k[V];
    residual<V>(x, y, keep, inv_keep, base + static_cast<size_t>(c) * V, s, k);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum += s[i];
      sq += s[i] * s[i];
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum * inv_d;
  const float var = sq * inv_d - mean * mean;
  const bool held = var < 0.0f;
  const float rstd = rsqrtf((held ? 0.0f : var) + eps);
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = held ? -rstd : rstd;
  }
  for (int c = lane; c < chunks; c += 32) {
    const size_t off = base + static_cast<size_t>(c) * V;
    float s[V], wv[V], bv[V], o[V];
    unsigned char k[V];
    residual<V>(x, y, keep, inv_keep, off, s, k);
    load<V>(w + c * V, wv);
    load<V>(b + c * V, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = (s[i] - mean) * (rstd * wv[i]) + bv[i];
    store<V>(out + off, o);
  }
}

// dx (where given), dy (where given) and each block's partial row of dw, db
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    residual_norm_backward_kernel(const float* __restrict__ g, const float* __restrict__ x,
                                  const float* __restrict__ y, const unsigned char* __restrict__ keep,
                                  const float* __restrict__ w, const float* __restrict__ stats,
                                  float* __restrict__ dx, float* __restrict__ dy,
                                  float* __restrict__ partial, int64_t rows, int d, float inv_keep,
                                  float inv_d) {
  extern __shared__ float acc[];  // kWarps x (2, d): a warp's sums of g * xh and of g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = d / V;
  float* mine = acc + static_cast<size_t>(warp) * 2 * d;
  float zero[V] = {};
  for (int c = lane; c < chunks; c += 32) {
    store<V>(mine + c * V, zero);
    store<V>(mine + d + c * V, zero);
  }
  const int64_t per_block = (rows + gridDim.x - 1) / gridDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = first + per_block < rows ? first + per_block : rows;
  for (int64_t row = first + warp; row < end; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    const float mean = stats[2 * row];
    const float signed_rstd = stats[2 * row + 1];
    const float rstd = fabsf(signed_rstd);
    float A = 0.0f, B = 0.0f;
    for (int c = lane; c < chunks; c += 32) {
      const size_t off = base + static_cast<size_t>(c) * V;
      float s[V], gv[V], wv[V], gx[V], g1[V];
      unsigned char k[V];
      residual<V>(x, y, keep, inv_keep, off, s, k);
      load<V>(g + off, gv);
      load<V>(w + c * V, wv);
      load<V>(mine + c * V, gx);
      load<V>(mine + d + c * V, g1);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (s[i] - mean) * rstd;
        const float gw = gv[i] * wv[i];
        A += gw;
        B += gw * xh;
        gx[i] += gv[i] * xh;
        g1[i] += gv[i];
      }
      store<V>(mine + c * V, gx);
      store<V>(mine + d + c * V, g1);
    }
    A = warp_sum(A);
    B = signed_rstd < 0.0f ? 0.0f : warp_sum(B);
    for (int c = lane; c < chunks; c += 32) {
      const size_t off = base + static_cast<size_t>(c) * V;
      float s[V], gv[V], wv[V], ds[V];
      unsigned char k[V];
      residual<V>(x, y, keep, inv_keep, off, s, k);
      load<V>(g + off, gv);
      load<V>(w + c * V, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (s[i] - mean) * rstd;
        ds[i] = rstd * (gv[i] * wv[i] - inv_d * (A + B * xh));
      }
      if (dx != nullptr) store<V>(dx + off, ds);
      if (dy != nullptr) {
        if (keep != nullptr) {
#pragma unroll
          for (int i = 0; i < V; ++i) ds[i] = k[i] ? ds[i] * inv_keep : 0.0f;
        }
        store<V>(dy + off, ds);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * d; j += blockDim.x) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += acc[static_cast<size_t>(k) * 2 * d + j];
    partial[static_cast<size_t>(blockIdx.x) * 2 * d + j] = t;
  }
}

// dw, db: the partial rows summed in order; block (32, kSumRows), 32 columns
__global__ void __launch_bounds__(32 * kSumRows)
    residual_norm_weight_sum_kernel(const float* __restrict__ partial, int blocks, int d,
                                    float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float part[kSumRows][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float t = 0.0f;
  if (col < 2 * d)
    for (int k = ty; k < blocks; k += kSumRows) t += partial[static_cast<size_t>(k) * 2 * d + col];
  part[ty][tx] = t;
  __syncthreads();
  if (ty != 0 || col >= 2 * d) return;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumRows; ++k) s += part[k][tx];
  if (col < d)
    dw[col] = s;
  else
    db[col - d] = s;
}

}  // namespace

extern "C" int residual_norm_backward_blocks(int64_t rows) {
  const int64_t need = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(need < kBackBlocks ? need : kBackBlocks);
}

extern "C" int residual_norm_forward_launch(const void* x, const void* y, const void* keep,
                                            const void* w, const void* b, void* out, void* stats,
                                            int64_t rows, int d, int vec, float inv_keep,
                                            float inv_d, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || (vec && d % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps)), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x), *yf = static_cast<const float*>(y);
  const unsigned char* k = static_cast<const unsigned char*>(keep);
  const float *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(b);
  float *o = static_cast<float*>(out), *s = static_cast<float*>(stats);
  if (vec)
    residual_norm_forward_kernel<4><<<grid, block, 0, st>>>(xf, yf, k, wf, bf, o, s, rows, d, inv_keep,
                                                            inv_d, eps);
  else
    residual_norm_forward_kernel<1><<<grid, block, 0, st>>>(xf, yf, k, wf, bf, o, s, rows, d, inv_keep,
                                                            inv_d, eps);
  return static_cast<int>(cudaGetLastError());
}

// Two launches: the rows (dx, dy, partials of blocks = residual_norm_backward_blocks(rows)
// rows of 2d floats), then the partials' sum into dw and db.
extern "C" int residual_norm_backward_launch(const void* g, const void* x, const void* y,
                                             const void* keep, const void* w, const void* stats,
                                             void* dx, void* dy, void* partial, void* dw, void* db,
                                             int64_t rows, int d, int vec, float inv_keep,
                                             float inv_d, void* stream) {
  if (rows <= 0 || d <= 0 || (vec && d % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = residual_norm_backward_blocks(rows);
  const size_t smem = sizeof(float) * kWarps * 2 * static_cast<size_t>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *gf = static_cast<const float*>(g), *xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const unsigned char* k = static_cast<const unsigned char*>(keep);
  const float *wf = static_cast<const float*>(w), *sf = static_cast<const float*>(stats);
  float *dxf = static_cast<float*>(dx), *dyf = static_cast<float*>(dy), *pf = static_cast<float*>(partial);
  cudaError_t err;
  if (vec) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(residual_norm_backward_kernel<4>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    residual_norm_backward_kernel<4><<<blocks, kWarps * 32, smem, st>>>(gf, xf, yf, k, wf, sf, dxf, dyf, pf,
                                                                        rows, d, inv_keep, inv_d);
  } else {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(residual_norm_backward_kernel<1>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return static_cast<int>(err);
    residual_norm_backward_kernel<1><<<blocks, kWarps * 32, smem, st>>>(gf, xf, yf, k, wf, sf, dxf, dyf, pf,
                                                                        rows, d, inv_keep, inv_d);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 sum_grid(static_cast<unsigned>((2 * d + 31) / 32)), sum_block(32, kSumRows);
  residual_norm_weight_sum_kernel<<<sum_grid, sum_block, 0, st>>>(pf, blocks, d, static_cast<float*>(dw),
                                                                  static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}
