// RMSNorm forward and backward for Hopper.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm.py
// `_fwd_kernel` (called from `_rms_fwd`): per row of x [R, D],
//   rstd = rsqrt(mean(x^2) + eps)   in fp32,
//   y    = (x * rstd) * w           in fp32, stored in x's type,
// with the per-row rstd [R] fp32 written when asked for (the backward
// needs it).
//
// Bound: bytes. Each element of x is read and each of y written once;
// the work per byte is two multiply-adds, far below the card's ratio of
// operations to bandwidth. Design: one block per row, so any R works
// (the TPU kernel's R % block_r restriction does not apply); 16-byte
// vector loads and stores when D % 8 == 0 and the rows are 16-byte
// aligned; the sum of squares is reduced in fp32 within the block. The
// second pass reads the row again, which at D = 4096 hits the L1/L2
// cache rather than device memory.

#include "common.cuh"

namespace {

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename TX, typename TW, bool VEC8>
__global__ void rms_norm_fwd_kernel(const TX* __restrict__ x,
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

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, float* rstd, int R,
                   int D, float eps, bool vec8, cudaStream_t stream) {
  const int work = vec8 ? D / 8 : D;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (vec8)
    rms_norm_fwd_kernel<TX, TW, true><<<R, threads, 0, stream>>>(
        xp, wp, yp, rstd, D, eps);
  else
    rms_norm_fwd_kernel<TX, TW, false><<<R, threads, 0, stream>>>(
        xp, wp, yp, rstd, D, eps);
  return cudaGetLastError();
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

extern "C" int pt_rms_norm_fwd(const void* x, const void* w, void* y,
                               void* rstd, int R, int D, float eps,
                               int x_dtype, int w_dtype, int vec8,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  const bool v = vec8 != 0;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, r, R, D, eps, v, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, r, R, D, eps, v, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, r, R, D, eps, v, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, r, R, D, eps, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
