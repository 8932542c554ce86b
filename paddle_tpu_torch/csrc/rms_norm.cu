// RMS norm forward: y = x * rsqrt(mean(x^2) + eps) * w, per row.
//
// Replaces: paddle_tpu/pallas/fused.py _rms_fwd_kernel / _rms_pallas_fwd
// (row-blocked Pallas kernel on the TPU).
//
// Bound on the H100 (3.35 TB/s): bytes.  The work is ~3 flops per element
// against 2-4 bytes moved, so the least time is (x read + w read + y
// written [+ r written]) / 3.35 TB/s: at a decode step (4 rows x 4096,
// bf16) that is ~72 KB, about 21 ns, far below a launch, so the serving
// path is launch-bound here; at 4096 rows x 4096 bf16 it is ~67 MB, 20 us.
//
// Design: one block per row, so any row count works (the TPU kernel needed
// rows % 8 == 0 and N % 128 == 0).  Each thread reads 16 bytes at a time
// (uint4: 8 bf16/fp16 or 4 fp32 values) with neighbouring threads on
// neighbouring addresses; the sum of squares is kept in fp32 and reduced
// by warp shuffles plus one shared-memory step across warps.  The second
// pass reads x again (it is hot in L1/L2 after the first) and computes
// x * r * w in fp32 with one rounding to x's type, the same op order as the
// TPU kernel.  A row length that is not a multiple of the vector width, or
// an unaligned pointer, takes a scalar loop.  Optionally r (fp32 [rows])
// is written for a later backward kernel.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T, typename W>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x,
                                    const W* __restrict__ w,
                                    T* __restrict__ y, float* __restrict__ r,
                                    int n, float eps, bool vec) {
  __shared__ float scratch[32];
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < n / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float f = ptt::to_f32(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float f = ptt::to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = ptt::block_sum(ss, scratch);
  const float rr = 1.0f / sqrtf(ss / static_cast<float>(n) + eps);
  if (r != nullptr && threadIdx.x == 0) r[row] = rr;

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < n / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        o[k] = ptt::from_f32<T>(ptt::to_f32(e[k]) * rr *
                                ptt::to_f32(__ldg(w + i * V + k)));
      }
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      yr[i] = ptt::from_f32<T>(ptt::to_f32(xr[i]) * rr *
                               ptt::to_f32(__ldg(w + i)));
    }
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* y, float* r, int rows, int n,
            float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int work = vec ? n / V : n;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  rms_norm_fwd_kernel<T, W><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(y), r, n, eps, vec);
}

template <typename T>
bool launch_w(int w_dtype, const void* x, const void* w, void* y, float* r,
              int rows, int n, float eps, cudaStream_t stream) {
  switch (w_dtype) {
    case ptt::kF32: launch<T, float>(x, w, y, r, rows, n, eps, stream); return true;
    case ptt::kBF16: launch<T, __nv_bfloat16>(x, w, y, r, rows, n, eps, stream); return true;
    case ptt::kF16: launch<T, __half>(x, w, y, r, rows, n, eps, stream); return true;
  }
  return false;
}

}  // namespace

// x, y: [rows, n] of x_dtype; w: [n] of w_dtype; r: fp32 [rows] or null.
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* r, int rows, int n, float eps,
                                int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rf = static_cast<float*>(r);
  bool ok = false;
  switch (x_dtype) {
    case ptt::kF32: ok = launch_w<float>(w_dtype, x, w, y, rf, rows, n, eps, s); break;
    case ptt::kBF16: ok = launch_w<__nv_bfloat16>(w_dtype, x, w, y, rf, rows, n, eps, s); break;
    case ptt::kF16: ok = launch_w<__half>(w_dtype, x, w, y, rf, rows, n, eps, s); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
