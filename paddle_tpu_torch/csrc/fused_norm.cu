// RMSNorm forward and backward for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm.py
// `_fwd_kernel` (called from `_rms_fwd`): per row of x [R, D],
//   rstd = rsqrt(mean(x^2) + eps)   in fp32,
//   y    = (x * rstd) * w           in fp32, stored in x's type,
// with the per-row rstd [R] fp32 written when asked for (the backward
// needs it).
//
// What bounds it, at the shapes the models launch (D = 4096 Llama, 2048
// DeepSeekMoE): at decode (R = 1..8) latency: the row's bytes (8 KB)
// take 2.4 ns of the card's bandwidth, so the time is the launch, one
// trip to device memory and the reduction; at prefill (R = 128..1536)
// and in training (R = 8192) bytes: x is read and y written once, two
// multiply-adds a byte, far below the card's ratio of operations to
// bandwidth. The design makes one trip to memory, not two:
// - the "row" route (`rms_norm_row_kernel`) fixes D at compile time
//   (2048, 4096) and gives each thread VPT 16-byte vectors of the row at
//   fixed columns: it issues the row's x loads and its weight loads
//   together, before the reduction, keeps them in registers and never
//   reads the row twice; the sum of squares is reduced by shuffles in
//   each warp, then across the row's warps in one shared-memory stage;
// - the wrapper's plan (ops/kernels/fused_norm.py `plan`) sets VPT = 1
//   and one row a block at decode, so that every load of the row is in
//   flight at once (512 threads at D = 4096); at prefill and in training
//   VPT = 4, several rows a block and blocks that walk rows a grid
//   apart, loading the next row while they reduce and store this one;
//   the weight stays in registers across the walk (a TMA 1-D bulk copy
//   of each row into shared memory was measured against these loads and
//   dropped: slower at decode, within 2% at the other shapes, PERF.md);
// - other widths that are multiples of 8 on 16-byte aligned rows take
//   the "vec" route (`rms_norm_vec_kernel`: one block a row, 16-byte
//   vectors, the row read again from L1/L2 after the reduction), the
//   rest the "scalar" route (the same kernel, one element at a time).
// Every route sums in a fixed order: no atomics, the same bits each run.

#include "common.cuh"

namespace {

using pt::load8;
using pt::store8;

template <typename TX, typename TW, bool VEC8>
__global__ void rms_norm_vec_kernel(const TX* __restrict__ x,
                                    const TW* __restrict__ w,
                                    TX* __restrict__ y,
                                    float* __restrict__ rstd, int D,
                                    float eps) {
  const size_t row = blockIdx.x;
  const TX* xr = x + row * D;
  TX* yr = y + row * D;
  float ss = 0.f;
  if (VEC8) {
    for (int i = threadIdx.x * 8; i < D; i += blockDim.x * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += v[e] * v[e];
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float v = pt::to_f(xr[i]);
      ss += v * v;
    }
  }
  ss = pt::block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[row] = r;
  if (VEC8) {
    for (int i = threadIdx.x * 8; i < D; i += blockDim.x * 8) {
      float v[8], wv[8];
      load8(xr + i, v);
      load8(w + i, wv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] * r) * wv[e];
      store8(yr + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      yr[i] = pt::from_f<TX>((pt::to_f(xr[i]) * r) * pt::to_f(w[i]));
  }
}

// The row route. TPR = D / (8 VPT) threads hold a row, RPB rows a block;
// thread t of a row owns the vectors t, t + TPR, ... (neighbouring
// threads on neighbouring 16 bytes). The blocks walk rows gridDim.x *
// RPB apart; every thread of a block runs the same number of trips, so
// the one __syncthreads a trip is reached by all. The shared-memory
// partials alternate between two buffers: a trip's writes cannot meet
// the previous trip's reads, which all lie before this trip's barrier.
template <typename TX, int D, int VPT, int RPB>
struct RowShape {
  static constexpr int TPR = D / (8 * VPT);
  static constexpr int WPR = TPR / 32;
  static constexpr int THREADS = TPR * RPB;
  static_assert(TPR % 32 == 0 && WPR >= 2, "a row spans whole warps");
};

template <typename TX, typename TW, int D, int VPT, int RPB>
__global__ void __launch_bounds__(RowShape<TX, D, VPT, RPB>::THREADS)
    rms_norm_row_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        TX* __restrict__ y, float* __restrict__ rstd, int R,
                        float eps) {
  using Sh = RowShape<TX, D, VPT, RPB>;
  constexpr int TPR = Sh::TPR, WPR = Sh::WPR;
  const int team = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  __shared__ float part[2][RPB][WPR];
  const long long step = static_cast<long long>(gridDim.x) * RPB;
  const long long first = static_cast<long long>(blockIdx.x) * RPB;

  pt::Vec8<TX> cur[VPT];
  if (first + team < R) {
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      cur[j].load(x + (first + team) * D + (j * TPR + t) * 8);
  }
  // the weight's loads are in flight with the first row's
  float wv[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j) load8(w + (j * TPR + t) * 8, wv[j]);

  int trip = 0;
  for (long long base = first; base < R; base += step, ++trip) {
    const long long row = base + team;
    const int buf = trip & 1;
    pt::Vec8<TX> nxt[VPT];
    if (row + step < R) {
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        nxt[j].load(x + (row + step) * D + (j * TPR + t) * 8);
    }
    float v[VPT][8];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      cur[j].get(v[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += v[j][e] * v[j][e];
    }
    ss = pt::warp_sum(ss);
    if ((t & 31) == 0) part[buf][team][t >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) ss += part[buf][team][i];
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    if (row < R) {
      if (rstd != nullptr && t == 0) rstd[row] = r;
      TX* yr = y + row * D;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = (v[j][e] * r) * wv[j][e];
        store8(yr + (j * TPR + t) * 8, o);
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) cur[j] = nxt[j];
  }
}

template <typename TX, typename TW, int D, int VPT, int RPB>
cudaError_t launch_row(const void* x, const void* w, void* y, float* rstd,
                       int R, float eps, int blocks, cudaStream_t stream) {
  using Sh = RowShape<TX, D, VPT, RPB>;
  rms_norm_row_kernel<TX, TW, D, VPT, RPB><<<blocks, Sh::THREADS, 0,
                                             stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rstd, R, eps);
  return cudaGetLastError();
}

// route 2 at a width the row route fixes: the wrapper's plan must give
// vpt 1 with one row a block, or vpt 4 with 256 / (D / 32) rows a block
template <typename TX, typename TW, int D>
cudaError_t launch_row_width(const void* x, const void* w, void* y,
                             float* rstd, int R, float eps, int vpt,
                             int rows, int blocks, int threads,
                             cudaStream_t s) {
  constexpr int WIDE_RPB = 256 / (D / 32);
  if (vpt == 1 && rows == 1 && threads == D / 8)
    return launch_row<TX, TW, D, 1, 1>(x, w, y, rstd, R, eps, blocks, s);
  if (vpt == 4 && rows == WIDE_RPB && threads == 256)
    return launch_row<TX, TW, D, 4, WIDE_RPB>(x, w, y, rstd, R, eps, blocks,
                                              s);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, float* rstd, int R,
                   int D, float eps, int route, int vpt, int rows,
                   int blocks, int threads, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (route == 0 || route == 1) {
    if (blocks != R || threads < 32 || threads > 1024 || threads % 32)
      return cudaErrorInvalidValue;
    if (route == 1)
      rms_norm_vec_kernel<TX, TW, true><<<R, threads, 0, stream>>>(
          xp, wp, yp, rstd, D, eps);
    else
      rms_norm_vec_kernel<TX, TW, false><<<R, threads, 0, stream>>>(
          xp, wp, yp, rstd, D, eps);
    return cudaGetLastError();
  }
  if (route != 2) return cudaErrorInvalidValue;
  if (D == 4096)
    return launch_row_width<TX, TW, 4096>(x, w, y, rstd, R, eps, vpt, rows,
                                          blocks, threads, stream);
  if (D == 2048)
    return launch_row_width<TX, TW, 2048>(x, w, y, rstd, R, eps, vpt, rows,
                                          blocks, threads, stream);
  return cudaErrorInvalidValue;
}

// RMSNorm backward.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm.py
// `_bwd_kernel` (called from `_rms_bwd_rule`): per row, with the rstd
// saved by the forward,
//   xhat = x * rstd,  wdy = dy * w,  c = mean(wdy * xhat),
//   dx   = (wdy - xhat * c) * rstd                       (x's type),
// and per block of rows the fp32 partial sum of dy * xhat over its rows,
// written to dw_part[block, D]. The caller sums the partials over blocks
// (one deterministic reduction outside the kernel, as the JAX wrapper
// does), so no atomics are needed.
//
// Bound: bytes. x and dy are read once, dx written once; about nine
// operations per element, far below the card's ratio of operations to
// bandwidth. Design: ROWS rows per block, so the partials stay small
// ([ceil(R / ROWS), D] fp32) while there are still hundreds of blocks;
// each thread owns fixed columns, so its share of the dw partial lives in
// shared memory that no other thread touches; the row's dot product is a
// block reduction; the second pass reads x and dy again, from L1/L2.

template <typename TX, typename TW, bool VEC8>
__global__ void rms_norm_bwd_kernel(const TX* __restrict__ x,
                                    const TW* __restrict__ w,
                                    const float* __restrict__ rstd,
                                    const TX* __restrict__ dy,
                                    TX* __restrict__ dx,
                                    float* __restrict__ dw_part, int R, int D,
                                    int rows_per_block) {
  extern __shared__ float dw_s[];  // [D], each column owned by one thread
  const int step = VEC8 ? blockDim.x * 8 : blockDim.x;
  const int first = VEC8 ? threadIdx.x * 8 : threadIdx.x;
  for (int i = first; i < D; i += step) {
    if (VEC8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dw_s[i + e] = 0.f;
    } else {
      dw_s[i] = 0.f;
    }
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const float inv_d = 1.f / static_cast<float>(D);
  for (int row = r0; row < r1; ++row) {
    const TX* xr = x + static_cast<size_t>(row) * D;
    const TX* dyr = dy + static_cast<size_t>(row) * D;
    TX* dxr = dx + static_cast<size_t>(row) * D;
    const float rs = rstd[row];
    float part = 0.f;
    if (VEC8) {
      for (int i = first; i < D; i += step) {
        float xv[8], dv[8], wv[8];
        load8(xr + i, xv);
        load8(dyr + i, dv);
        load8(w + i, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += (dv[e] * wv[e]) * (xv[e] * rs);
      }
    } else {
      for (int i = first; i < D; i += step) {
        const float xh = pt::to_f(xr[i]) * rs;
        part += (pt::to_f(dyr[i]) * pt::to_f(w[i])) * xh;
      }
    }
    const float c = pt::block_sum(part) * inv_d;
    if (VEC8) {
      for (int i = first; i < D; i += step) {
        float xv[8], dv[8], wv[8], o[8];
        load8(xr + i, xv);
        load8(dyr + i, dv);
        load8(w + i, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = xv[e] * rs;
          o[e] = (dv[e] * wv[e] - xh * c) * rs;
          dw_s[i + e] += dv[e] * xh;
        }
        store8(dxr + i, o);
      }
    } else {
      for (int i = first; i < D; i += step) {
        const float xh = pt::to_f(xr[i]) * rs;
        const float dv = pt::to_f(dyr[i]);
        dxr[i] = pt::from_f<TX>((dv * pt::to_f(w[i]) - xh * c) * rs);
        dw_s[i] += dv * xh;
      }
    }
  }
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * D;
  for (int i = first; i < D; i += step) {
    if (VEC8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[i + e] = dw_s[i + e];
    } else {
      out[i] = dw_s[i];
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch_bwd(const void* x, const void* w, const float* rstd,
                       const void* dy, void* dx, float* dw_part, int R, int D,
                       int rows_per_block, bool vec8, cudaStream_t stream) {
  const int work = vec8 ? D / 8 : D;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const TX* dyp = static_cast<const TX*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  if (vec8) {
    auto k = rms_norm_bwd_kernel<TX, TW, true>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    k<<<blocks, threads, smem, stream>>>(xp, wp, rstd, dyp, dxp, dw_part, R,
                                         D, rows_per_block);
  } else {
    auto k = rms_norm_bwd_kernel<TX, TW, false>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    k<<<blocks, threads, smem, stream>>>(xp, wp, rstd, dyp, dxp, dw_part, R,
                                         D, rows_per_block);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_rms_norm_bwd(const void* x, const void* w,
                               const void* rstd, const void* dy, void* dx,
                               void* dw_part, int R, int D,
                               int rows_per_block, int x_dtype, int w_dtype,
                               int vec8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(dw_part);
  const bool v = vec8 != 0;
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, r, dy, dx, p, R, D, rows_per_block,
                                    v, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, r, dy, dx, p, R, D,
                                            rows_per_block, v, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, r, dy, dx, p, R, D,
                                            rows_per_block, v, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, r, dy, dx, p, R, D,
                                                    rows_per_block, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// route: 0 scalar, 1 vec, 2 row; vpt, rows, blocks and threads are the
// wrapper's plan (ops/kernels/fused_norm.py `plan`), which the launch
// checks against the kernels' shapes
extern "C" int pt_rms_norm_fwd(const void* x, const void* w, void* y,
                               void* rstd, int R, int D, float eps,
                               int x_dtype, int w_dtype, int route, int vpt,
                               int rows, int blocks, int threads,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, r, R, D, eps, route, vpt, rows,
                                blocks, threads, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, r, R, D, eps, route, vpt,
                                        rows, blocks, threads, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, r, R, D, eps, route, vpt,
                                        rows, blocks, threads, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, r, R, D, eps, route,
                                                vpt, rows, blocks, threads,
                                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}
