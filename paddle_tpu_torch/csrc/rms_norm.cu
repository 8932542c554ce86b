// RMS norm forward: y = x * rsqrt(mean(x^2) + eps) * w, per row, and its
// backward (below).
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

// ---------------------------------------------------------------------------
// RMS norm backward: with x^ = x r (r the forward's fp32 rsqrt per row),
//   dx = r (g w - x^ mean(g w x^))      dw = sum over rows of g x^
// in fp32, dx rounded once to x's type, dw to w's type.
//
// Replaces: paddle_tpu/pallas/fused.py _rms_bwd_kernel / _rms_pallas_bwd.
//
// Bound on the H100 (3.35 TB/s): bytes.  It reads x and g and writes dx
// (3 rows x N each) plus r and w: at 4096 x 4096 bf16 that is ~100 MB,
// 30 us; the arithmetic is ~10 flops per element.
//
// Design.  The TPU kernel carried dw across its sequential row grid in
// VMEM scratch.  Blocks on Hopper run in no order, so each of up to
// 2 x SMs blocks takes a contiguous range of rows and sums g x^ for the
// columns each of its threads owns (the same columns in every row, so no
// two threads touch one sum) into fp32 partials: in shared memory when the
// row fits (N <= 12288), else in the block's own row of the workspace.
// Each block writes its partials to the fp32 workspace [blocks, N]; a
// second small kernel sums the workspace down its columns in block order
// and casts to w's type.  Fixed order, no atomics: dw is the same on
// every run.  Rows are read twice (the mean, then dx), the second time
// from L1/L2; 16-byte vector loads as in the forward, with a scalar path
// for any N or alignment.

namespace {

constexpr int kBwdSmemCols = 12288;

template <typename T, typename W>
__global__ void rms_norm_bwd_kernel(const T* __restrict__ x,
                                    const W* __restrict__ w,
                                    const float* __restrict__ r,
                                    const T* __restrict__ g,
                                    T* __restrict__ dx,
                                    float* __restrict__ ws, int rows, int n,
                                    int rows_per_block, bool vec,
                                    bool smem_acc) {
  extern __shared__ float acc_s[];
  __shared__ float scratch[32];
  constexpr int V = 16 / sizeof(T);
  float* ws_row = ws + static_cast<size_t>(blockIdx.x) * n;
  float* acc = smem_acc ? acc_s : ws_row;
  const int n_vec = vec ? n / V : n;   // units a thread strides over
  const int width = vec ? V : 1;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    for (int k = 0; k < width; ++k) acc[i * width + k] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + static_cast<size_t>(row) * n;
    const T* gr = g + static_cast<size_t>(row) * n;
    T* dxr = dx + static_cast<size_t>(row) * n;
    const float rr = r[row];
    float dot = 0.f;
    if (vec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const uint4* gv = reinterpret_cast<const uint4*>(gr);
      for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
        uint4 xraw = xv[i], graw = gv[i];
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = ptt::to_f32(xe[k]) * rr;
          const float gw = ptt::to_f32(ge[k]) * ptt::to_f32(__ldg(w + i * V + k));
          dot += gw * xh;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float xh = ptt::to_f32(xr[i]) * rr;
        const float gw = ptt::to_f32(gr[i]) * ptt::to_f32(__ldg(w + i));
        dot += gw * xh;
      }
    }
    const float mean = ptt::block_sum(dot, scratch) / static_cast<float>(n);
    if (vec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const uint4* gv = reinterpret_cast<const uint4*>(gr);
      uint4* dv = reinterpret_cast<uint4*>(dxr);
      for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
        uint4 xraw = xv[i], graw = gv[i], out;
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* ge = reinterpret_cast<const T*>(&graw);
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = ptt::to_f32(xe[k]) * rr;
          const float gf = ptt::to_f32(ge[k]);
          const float gw = gf * ptt::to_f32(__ldg(w + i * V + k));
          o[k] = ptt::from_f32<T>(rr * (gw - xh * mean));
          acc[i * V + k] += gf * xh;
        }
        dv[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float xh = ptt::to_f32(xr[i]) * rr;
        const float gf = ptt::to_f32(gr[i]);
        const float gw = gf * ptt::to_f32(__ldg(w + i));
        dxr[i] = ptt::from_f32<T>(rr * (gw - xh * mean));
        acc[i] += gf * xh;
      }
    }
  }
  if (smem_acc) {
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
      for (int k = 0; k < width; ++k)
        ws_row[i * width + k] = acc[i * width + k];
  }
}

// dw[c] = sum over blocks of ws[blk, c], in block order, cast to W
template <typename W>
__global__ void rms_norm_dw_kernel(const float* __restrict__ ws,
                                   W* __restrict__ dw, int blocks, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += ws[static_cast<size_t>(b) * n + c];
  dw[c] = ptt::from_f32<W>(sum);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const float* r, const void* g,
               void* dx, void* dw, float* ws, int rows, int n, int blocks,
               cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int work = vec ? n / V : n;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const int per = (rows + blocks - 1) / blocks;
  const int used = (rows + per - 1) / per;
  const bool smem_acc = n <= kBwdSmemCols;
  const size_t smem = smem_acc ? sizeof(float) * n : 0;
  rms_norm_bwd_kernel<T, W><<<used, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), r,
      static_cast<const T*>(g), static_cast<T*>(dx), ws, rows, n, per, vec,
      smem_acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_kernel<W><<<(n + 255) / 256, 256, 0, stream>>>(
      ws, static_cast<W*>(dw), used, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_w(int w_dtype, const void* x, const void* w, const float* r,
                 const void* g, void* dx, void* dw, float* ws, int rows,
                 int n, int blocks, cudaStream_t s) {
  switch (w_dtype) {
    case ptt::kF32: return launch_bwd<T, float>(x, w, r, g, dx, dw, ws, rows, n, blocks, s);
    case ptt::kBF16: return launch_bwd<T, __nv_bfloat16>(x, w, r, g, dx, dw, ws, rows, n, blocks, s);
    case ptt::kF16: return launch_bwd<T, __half>(x, w, r, g, dx, dw, ws, rows, n, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, g, dx: [rows, n] of x_dtype; w, dw: [n] of w_dtype; r: fp32 [rows];
// ws: fp32 workspace of at least blocks * n.
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* r,
                                const void* g, void* dx, void* dw, void* ws,
                                int rows, int n, int blocks, int x_dtype,
                                int w_dtype, void* stream) {
  if (rows <= 0 || n <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  float* wsf = static_cast<float*>(ws);
  switch (x_dtype) {
    case ptt::kF32: return launch_bwd_w<float>(w_dtype, x, w, rf, g, dx, dw, wsf, rows, n, blocks, s);
    case ptt::kBF16: return launch_bwd_w<__nv_bfloat16>(w_dtype, x, w, rf, g, dx, dw, wsf, rows, n, blocks, s);
    case ptt::kF16: return launch_bwd_w<__half>(w_dtype, x, w, rf, g, dx, dw, wsf, rows, n, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
