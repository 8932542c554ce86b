// RMS norm on the H100, forward and backward:
//
//   forward   y = x r w,  r = rsqrt(mean(x^2) + eps), in fp32, y rounded once
//             to x's type (and r written as fp32 [rows] when asked)
//   backward  dx = r (g w - x^ mean(g w x^)),  dw = sum over rows of g x^,
//             x^ = x r, in fp32; dx rounded to x's type, dw to w's
//
// Replaces: paddle_tpu/pallas/fused.py _rms_fwd_kernel / _rms_pallas_fwd
// (:52, :92) and _rms_bwd_kernel / _rms_pallas_bwd (:59, :112), row-blocked
// Pallas kernels; the TPU backward carries dw across its sequential row grid
// in VMEM scratch.
//
// Bound on the H100 (3.35 TB/s): bytes, both ways.  The forward reads x and w
// and writes y (and r): a decode step (4 x 4096 bf16) moves ~72 KB, ~21 ns,
// so one launch and one DRAM round trip are all it should cost; 4096 x 4096
// bf16 moves ~67 MB, 20 us.  The backward reads x and g and writes dx, ~100 MB
// at 4096 x 4096 bf16, 30 us; ~10 flops an element.
//
// Design.  The host plans every launch (kernels/rms_norm.py `plan`): the
// path, the threads, the elements of a row a thread holds, the rows a block
// walks and the blocks; the entry points check the plan against the shape.
// * Register path (rows of at most 8192 elements, at most 32 a thread): each
//   thread owns the same 16-byte vectors of every row, neighbouring threads
//   on neighbouring addresses.  A block issues the loads of its first row of
//   x (and g) and of w together, before any reduction, keeps w in fp32
//   registers for all its rows, and issues row i+1's loads into a second set
//   of registers before row i reduces: every row is read from memory once,
//   and a block walking many rows always has one in flight.  A row's sum is
//   warp shuffles and one shared-memory step behind one barrier.
// * Staged path (longer rows): the same walk with rows staged in shared
//   memory by cp.async, two rows deep (one where two do not fit); w is read
//   through L1 with 16-byte loads.
// * Generic path (N not a multiple of the 16-byte vector, a pointer off
//   16-byte alignment, or a row too long to stage): the first design's
//   kernels, one block a row in the forward, any shape.
// * dw: every backward block sums g x^ over its rows in fp32 for the columns
//   its threads own (in registers; shared memory on the staged path) and
//   writes the sums once to its row of an fp32 workspace [blocks, N].  A
//   second kernel sums the workspace down its columns: one block a strip of
//   32 columns, 32 thread rows each adding every 32nd partial row in order,
//   then a fixed tree in shared memory.  No atomics, every sum in a fixed
//   order: dw is the same, bit for bit, on every call.
// Nothing here allocates or synchronises (the wrapper passes the workspace),
// so the launches can be captured in a CUDA graph.
#include <cstdint>

#include "common.cuh"

namespace {

// limits of the plan (kernels/rms_norm.py keeps the same numbers)
constexpr int kFwdMaxThreads = 512;      // register path, forward
constexpr int kBwdMaxThreads = 256;      // register path, backward
constexpr int kStagedThreads = 512;
constexpr int kSmemLimit = 220 * 1024;   // dynamic shared memory a block
constexpr int kDwCols = 32;              // dw column sum: columns a block
constexpr int kDwGroups = 32;            //   and thread rows
enum Path : int { kGeneric = 0, kReg = 1, kStaged = 2 };

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V values of W at p as fp32, in 16-byte loads (8 bytes where V values take
// 8); p is aligned to min(16, V sizeof(W)) bytes.
template <typename W, int V>
__device__ __forceinline__ void load_f32(const W* p, float* out) {
  constexpr int kBytes = V * static_cast<int>(sizeof(W));
  constexpr int kPer = 16 / static_cast<int>(sizeof(W));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const W* e = reinterpret_cast<const W*>(&u);
#pragma unroll
      for (int k = 0; k < kPer; ++k) out[j * kPer + k] = ptt::to_f32(e[k]);
    }
  } else {
    static_assert(kBytes == 8, "V values of W take 8, 16 or 32 bytes");
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const W* e = reinterpret_cast<const W*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = ptt::to_f32(e[k]);
  }
}

// This thread's VPT vectors of one row (vector threadIdx.x + k blockDim.x);
// vectors past the row's nv read as zero.
template <int VPT>
__device__ __forceinline__ void load_row(const void* row, int nv,
                                         uint4* out) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    out[k] = i < nv ? __ldg(p + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Sum of v over the block behind one barrier: the warps' sums go to
// red[parity * 32 + warp], and every warp adds them in one butterfly, so
// every thread gets the same bits.  Consecutive calls alternate `parity`: a
// warp that runs ahead writes the other half, never sums a slow warp still
// reads (it passed the barrier of the call in between).
__device__ __forceinline__ float block_sum1(float v, float* red, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s = red + parity * 32;
  v = ptt::warp_sum(v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  return ptt::warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? s[lane]
                                                                : 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0 or 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ forward
// Register path: block b walks rows [b rpb, (b + 1) rpb); a thread holds
// EPT elements of a row (EPT / V vectors).
template <typename T, typename W, int EPT>
__global__ void __launch_bounds__(kFwdMaxThreads)
rms_fwd_reg(const T* __restrict__ x, const W* __restrict__ w,
            T* __restrict__ y, float* __restrict__ r, int rows, int n,
            float eps, int rows_per_block) {
  constexpr int V = vec_width<T>(), VPT = EPT / V;
  __shared__ float red[64];
  const int nv = n / V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  uint4 cur[VPT], nxt[VPT];
  float wf[VPT][V];
  // the first row of x and w in flight together
  load_row<VPT>(x + static_cast<size_t>(r0) * n, nv, cur);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      load_f32<W, V>(w + static_cast<size_t>(i) * V, wf[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) wf[k][j] = 0.f;
    }
  }
  for (int row = r0; row < r1; ++row) {
    if (row + 1 < r1)      // the next row in flight while this one reduces
      load_row<VPT>(x + static_cast<size_t>(row + 1) * n, nv, nxt);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const T* e = reinterpret_cast<const T*>(&cur[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f32(e[j]);
        ss += f * f;
      }
    }
    ss = block_sum1(ss, red, (row - r0) & 1);
    const float rr = 1.0f / sqrtf(ss / static_cast<float>(n) + eps);
    if (r != nullptr && threadIdx.x == 0) r[row] = rr;
    uint4* yv = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * n);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&cur[k]);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = ptt::from_f32<T>(ptt::to_f32(e[j]) * rr * wf[k][j]);
        yv[i] = out;
      }
    }
    if (row + 1 < r1) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) cur[k] = nxt[k];
    }
  }
}

// Staged path: rows of x staged in shared memory by cp.async, `stages` (1 or
// 2) deep, one commit group a row (empty past the block's last row).
template <typename T, typename W>
__global__ void __launch_bounds__(kStagedThreads)
rms_fwd_staged(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, float* __restrict__ r, int rows, int n,
               float eps, int rows_per_block, int stages) {
  constexpr int V = vec_width<T>();
  extern __shared__ uint4 stage[];         // [stages][n / V]
  __shared__ float red[64];
  const int nv = n / V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  auto issue = [&](int row) {
    if (row < r1) {
      const uint4* src =
          reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * n);
      uint4* dst = stage + static_cast<size_t>((row - r0) % stages) * nv;
      for (int i = threadIdx.x; i < nv; i += blockDim.x)
        cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages; ++s) issue(r0 + s);
  for (int row = r0; row < r1; ++row) {
    cp_async_wait(stages - 1);
    __syncthreads();                       // the row, from every thread
    const uint4* xs = stage + static_cast<size_t>((row - r0) % stages) * nv;
    float ss = 0.f;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 raw = xs[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f32(e[j]);
        ss += f * f;
      }
    }
    ss = block_sum1(ss, red, (row - r0) & 1);
    const float rr = 1.0f / sqrtf(ss / static_cast<float>(n) + eps);
    if (r != nullptr && threadIdx.x == 0) r[row] = rr;
    uint4* yv = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * n);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 raw = xs[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      float wv[V];
      load_f32<W, V>(w + static_cast<size_t>(i) * V, wv);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = ptt::from_f32<T>(ptt::to_f32(e[j]) * rr * wv[j]);
      yv[i] = out;
    }
    __syncthreads();                       // every thread done with the stage
    issue(row + stages);
  }
}

// Generic path: one block a row, any N and alignment (`vec` takes 16-byte
// loads of x where N and the pointers allow); x is read twice, the second
// time from L1/L2.
template <typename T, typename W>
__global__ void rms_fwd_generic(const T* __restrict__ x,
                                const W* __restrict__ w, T* __restrict__ y,
                                float* __restrict__ r, int n, float eps,
                                bool vec) {
  __shared__ float red[64];
  constexpr int V = vec_width<T>();
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
  ss = block_sum1(ss, red, 0);
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

// ------------------------------------------------------------ backward
// Store a thread's V fp32 dw partials at p (16-byte aligned).
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// Register path: as the forward's, with g beside x, r read a row ahead, and
// dw's partials for the thread's columns in fp32 registers.
template <typename T, typename W, int EPT>
__global__ void __launch_bounds__(kBwdMaxThreads)
rms_bwd_reg(const T* __restrict__ x, const W* __restrict__ w,
            const float* __restrict__ r, const T* __restrict__ g,
            T* __restrict__ dx, float* __restrict__ ws, int rows, int n,
            int rows_per_block) {
  constexpr int V = vec_width<T>(), VPT = EPT / V;
  __shared__ float red[64];
  const int nv = n / V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  uint4 xc[VPT], gc[VPT], xn[VPT], gn[VPT];
  float wf[VPT][V], acc[VPT][V];
  load_row<VPT>(x + static_cast<size_t>(r0) * n, nv, xc);
  load_row<VPT>(g + static_cast<size_t>(r0) * n, nv, gc);
  float rr = __ldg(r + r0), rn = rr;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) {
      load_f32<W, V>(w + static_cast<size_t>(i) * V, wf[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) wf[k][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  }
  for (int row = r0; row < r1; ++row) {
    if (row + 1 < r1) {    // the next row in flight while this one reduces
      load_row<VPT>(x + static_cast<size_t>(row + 1) * n, nv, xn);
      load_row<VPT>(g + static_cast<size_t>(row + 1) * n, nv, gn);
      rn = __ldg(r + row + 1);
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const T* xe = reinterpret_cast<const T*>(&xc[k]);
      const T* ge = reinterpret_cast<const T*>(&gc[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = ptt::to_f32(xe[j]) * rr;
        const float gw = ptt::to_f32(ge[j]) * wf[k][j];
        dot += gw * xh;
      }
    }
    const float mean = block_sum1(dot, red, (row - r0) & 1) /
                       static_cast<float>(n);
    uint4* dv = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * n);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const T* xe = reinterpret_cast<const T*>(&xc[k]);
      const T* ge = reinterpret_cast<const T*>(&gc[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = ptt::to_f32(xe[j]) * rr;
        const float gf = ptt::to_f32(ge[j]);
        const float gw = gf * wf[k][j];
        o[j] = ptt::from_f32<T>(rr * (gw - xh * mean));
        acc[k][j] += gf * xh;
      }
      if (i < nv) dv[i] = out;
    }
    if (row + 1 < r1) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        xc[k] = xn[k];
        gc[k] = gn[k];
      }
      rr = rn;
    }
  }
  float* wsr = ws + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nv) store_f32<V>(wsr + static_cast<size_t>(i) * V, acc[k]);
  }
}

// Staged path: rows of x and g staged by cp.async `stages` deep; dw's
// partials in shared memory (fp32 [n] after the stages), each column owned
// by one thread.
template <typename T, typename W>
__global__ void __launch_bounds__(kStagedThreads)
rms_bwd_staged(const T* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ r, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ ws, int rows, int n,
               int rows_per_block, int stages) {
  constexpr int V = vec_width<T>();
  extern __shared__ uint4 stage[];   // x [stages][nv], g [stages][nv], acc
  __shared__ float red[64];
  const int nv = n / V;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  uint4* xs_all = stage;
  uint4* gs_all = stage + static_cast<size_t>(stages) * nv;
  float* acc = reinterpret_cast<float*>(stage + 2 * static_cast<size_t>(stages) * nv);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i * V + j] = 0.f;
  }
  auto issue = [&](int row) {
    if (row < r1) {
      const size_t off = static_cast<size_t>(row) * n;
      const uint4* xsrc = reinterpret_cast<const uint4*>(x + off);
      const uint4* gsrc = reinterpret_cast<const uint4*>(g + off);
      const size_t slot = static_cast<size_t>((row - r0) % stages) * nv;
      for (int i = threadIdx.x; i < nv; i += blockDim.x) {
        cp_async16(xs_all + slot + i, xsrc + i);
        cp_async16(gs_all + slot + i, gsrc + i);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages; ++s) issue(r0 + s);
  for (int row = r0; row < r1; ++row) {
    cp_async_wait(stages - 1);
    __syncthreads();
    const size_t slot = static_cast<size_t>((row - r0) % stages) * nv;
    const uint4* xs = xs_all + slot;
    const uint4* gs = gs_all + slot;
    const float rr = __ldg(r + row);
    float dot = 0.f;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 xraw = xs[i], graw = gs[i];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      float wv[V];
      load_f32<W, V>(w + static_cast<size_t>(i) * V, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = ptt::to_f32(xe[j]) * rr;
        const float gw = ptt::to_f32(ge[j]) * wv[j];
        dot += gw * xh;
      }
    }
    const float mean = block_sum1(dot, red, (row - r0) & 1) /
                       static_cast<float>(n);
    uint4* dv = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * n);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 xraw = xs[i], graw = gs[i];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      float wv[V];
      load_f32<W, V>(w + static_cast<size_t>(i) * V, wv);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = ptt::to_f32(xe[j]) * rr;
        const float gf = ptt::to_f32(ge[j]);
        const float gw = gf * wv[j];
        o[j] = ptt::from_f32<T>(rr * (gw - xh * mean));
        acc[i * V + j] += gf * xh;
      }
      dv[i] = out;
    }
    __syncthreads();
    issue(row + stages);
  }
  float* wsr = ws + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    store_f32<V>(wsr + static_cast<size_t>(i) * V, acc + i * V);
}

// Generic path: a block walks rows_per_block rows; dw's partials for the
// columns each thread owns in shared memory when the row fits under the
// 48 KB a block takes without opting in (N <= 12032), else in the block's own
// workspace row.  Rows are read twice, the second
// time from L1/L2.
constexpr int kBwdSmemCols = 12032;

template <typename T, typename W>
__global__ void rms_bwd_generic(const T* __restrict__ x,
                                const W* __restrict__ w,
                                const float* __restrict__ r,
                                const T* __restrict__ g,
                                T* __restrict__ dx,
                                float* __restrict__ ws, int rows, int n,
                                int rows_per_block, bool vec,
                                bool smem_acc) {
  extern __shared__ float acc_s[];
  __shared__ float red[64];
  constexpr int V = vec_width<T>();
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
    const float mean = block_sum1(dot, red, (row - r0) & 1) /
                       static_cast<float>(n);
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

// dw[c] = the sum over parts of ws[part, c], cast to W.  A block takes 32
// columns (one warp's 128 bytes a partial row); thread row j adds partial
// rows j, j + 32, j + 64, ... in order (8 loads in flight), then a fixed
// tree sums the 32 thread rows in shared memory.
template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwGroups)
rms_dw_sum(const float* __restrict__ ws, W* __restrict__ dw, int parts,
           int n) {
  __shared__ float part[kDwGroups][kDwCols + 1];
  const int c = threadIdx.x % kDwCols, j = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + c;
  float s = 0.f;
  if (col < n) {
#pragma unroll 8
    for (int b = j; b < parts; b += kDwGroups)
      s += __ldg(ws + static_cast<size_t>(b) * n + col);
  }
  part[j][c] = s;
  __syncthreads();
#pragma unroll
  for (int h = kDwGroups / 2; h > 0; h >>= 1) {
    if (j < h) part[j][c] += part[j + h][c];
    __syncthreads();
  }
  if (j == 0 && col < n) dw[col] = ptt::from_f32<W>(part[0][c]);
}

// ------------------------------------------------------------ launches
struct Plan {
  int path, threads, ept, stages, rows_per_block, blocks;
};

// The plan covers rows 0..rows-1 once, every block non-empty, with whole
// warps; the vector paths need N a multiple of V and 16-byte pointers.
bool plan_ok(const Plan& p, int rows, int n, int v, bool aligned) {
  if (p.threads < 32 || p.threads % 32 != 0 || p.threads > 1024) return false;
  if (p.blocks <= 0 || p.rows_per_block <= 0) return false;
  const long long cover = static_cast<long long>(p.blocks) * p.rows_per_block;
  if (cover < rows || cover - p.rows_per_block >= rows) return false;
  if (p.path == kGeneric) return true;
  return n % v == 0 && aligned;
}

// once per kernel: the staged paths take up to kSmemLimit of shared memory
template <typename K>
cudaError_t allow_staged_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

template <typename T, typename W>
int launch_fwd(const void* xp, const void* wp, void* yp, float* r, int rows,
               int n, float eps, const Plan& p, cudaStream_t s) {
  constexpr int V = vec_width<T>();
  const T* x = static_cast<const T*>(xp);
  const W* w = static_cast<const W*>(wp);
  T* y = static_cast<T*>(yp);
  if (!plan_ok(p, rows, n, V, aligned16(x) && aligned16(w) && aligned16(y)))
    return kInvalid;
  switch (p.path) {
    case kReg: {
      if (p.threads > kFwdMaxThreads || p.ept % V != 0 ||
          static_cast<long long>(p.threads) * (p.ept / V) < n / V)
        return kInvalid;
      switch (p.ept) {
        case 8: rms_fwd_reg<T, W, 8><<<p.blocks, p.threads, 0, s>>>(
                    x, w, y, r, rows, n, eps, p.rows_per_block); break;
        case 16: rms_fwd_reg<T, W, 16><<<p.blocks, p.threads, 0, s>>>(
                    x, w, y, r, rows, n, eps, p.rows_per_block); break;
        case 32: rms_fwd_reg<T, W, 32><<<p.blocks, p.threads, 0, s>>>(
                    x, w, y, r, rows, n, eps, p.rows_per_block); break;
        default: return kInvalid;
      }
      break;
    }
    case kStaged: {
      const size_t smem = static_cast<size_t>(p.stages) * n * sizeof(T);
      if (p.stages < 1 || p.stages > 2 || smem > kSmemLimit ||
          p.threads > kStagedThreads)
        return kInvalid;
      static const cudaError_t e = allow_staged_smem(rms_fwd_staged<T, W>);
      if (e != cudaSuccess) return static_cast<int>(e);
      rms_fwd_staged<T, W><<<p.blocks, p.threads, smem, s>>>(
          x, w, y, r, rows, n, eps, p.rows_per_block, p.stages);
      break;
    }
    case kGeneric: {
      if (p.rows_per_block != 1) return kInvalid;
      const bool vec = n % V == 0 && aligned16(x) && aligned16(y);
      rms_fwd_generic<T, W><<<rows, p.threads, 0, s>>>(x, w, y, r, n, eps,
                                                       vec);
      break;
    }
    default: return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_bwd(const void* xp, const void* wp, const float* r, const void* gp,
               void* dxp, float* ws, int rows, int n, const Plan& p,
               cudaStream_t s) {
  constexpr int V = vec_width<T>();
  const T* x = static_cast<const T*>(xp);
  const W* w = static_cast<const W*>(wp);
  const T* g = static_cast<const T*>(gp);
  T* dx = static_cast<T*>(dxp);
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(g) &&
                       aligned16(dx) && aligned16(ws);
  if (!plan_ok(p, rows, n, V, aligned)) return kInvalid;
  switch (p.path) {
    case kReg: {
      if (p.threads > kBwdMaxThreads || p.ept % V != 0 ||
          static_cast<long long>(p.threads) * (p.ept / V) < n / V)
        return kInvalid;
      switch (p.ept) {
        case 8: rms_bwd_reg<T, W, 8><<<p.blocks, p.threads, 0, s>>>(
                    x, w, r, g, dx, ws, rows, n, p.rows_per_block); break;
        case 16: rms_bwd_reg<T, W, 16><<<p.blocks, p.threads, 0, s>>>(
                    x, w, r, g, dx, ws, rows, n, p.rows_per_block); break;
        case 32: rms_bwd_reg<T, W, 32><<<p.blocks, p.threads, 0, s>>>(
                    x, w, r, g, dx, ws, rows, n, p.rows_per_block); break;
        default: return kInvalid;
      }
      break;
    }
    case kStaged: {
      const size_t smem =
          (2 * static_cast<size_t>(p.stages) * sizeof(T) + sizeof(float)) * n;
      if (p.stages < 1 || p.stages > 2 || smem > kSmemLimit ||
          p.threads > kStagedThreads)
        return kInvalid;
      static const cudaError_t e = allow_staged_smem(rms_bwd_staged<T, W>);
      if (e != cudaSuccess) return static_cast<int>(e);
      rms_bwd_staged<T, W><<<p.blocks, p.threads, smem, s>>>(
          x, w, r, g, dx, ws, rows, n, p.rows_per_block, p.stages);
      break;
    }
    case kGeneric: {
      const bool vec = n % V == 0 && aligned16(x) && aligned16(g) &&
                       aligned16(dx);
      const bool smem_acc = n <= kBwdSmemCols;
      const size_t smem = smem_acc ? sizeof(float) * n : 0;
      rms_bwd_generic<T, W><<<p.blocks, p.threads, smem, s>>>(
          x, w, r, g, dx, ws, rows, n, p.rows_per_block, vec, smem_acc);
      break;
    }
    default: return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

// f(T{}, W{}) for the dtype codes of x and w
template <typename F>
int dispatch(int x_dtype, int w_dtype, F&& f) {
  auto on_w = [&](auto tx) -> int {
    switch (w_dtype) {
      case ptt::kF32: return f(tx, float{});
      case ptt::kBF16: return f(tx, __nv_bfloat16{});
      case ptt::kF16: return f(tx, __half{});
    }
    return kInvalid;
  };
  switch (x_dtype) {
    case ptt::kF32: return on_w(float{});
    case ptt::kBF16: return on_w(__nv_bfloat16{});
    case ptt::kF16: return on_w(__half{});
  }
  return kInvalid;
}

}  // namespace

// x, y: [rows, n] of x_dtype; w: [n] of w_dtype; r: fp32 [rows] or null.
// path .. blocks: the launch plan (kernels/rms_norm.py `plan`).
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                void* r, int rows, int n, float eps,
                                int x_dtype, int w_dtype, int path,
                                int threads, int ept, int stages,
                                int rows_per_block, int blocks,
                                void* stream) {
  if (rows <= 0 || n <= 0) return kInvalid;
  const Plan p{path, threads, ept, stages, rows_per_block, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rf = static_cast<float*>(r);
  return dispatch(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return launch_fwd<decltype(tx), decltype(tw)>(x, w, y, rf, rows, n, eps,
                                                  p, s);
  });
}

// The backward's first launch: dx, and dw's partial sums into ws, fp32
// [blocks, n].  x, g, dx: [rows, n] of x_dtype; w: [n] of w_dtype; r: fp32
// [rows] (the forward's).
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w, const void* r,
                                const void* g, void* dx, void* ws, int rows,
                                int n, int x_dtype, int w_dtype, int path,
                                int threads, int ept, int stages,
                                int rows_per_block, int blocks,
                                void* stream) {
  if (rows <= 0 || n <= 0) return kInvalid;
  const Plan p{path, threads, ept, stages, rows_per_block, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  float* wsf = static_cast<float*>(ws);
  return dispatch(x_dtype, w_dtype, [&](auto tx, auto tw) {
    return launch_bwd<decltype(tx), decltype(tw)>(x, w, rf, g, dx, wsf, rows,
                                                  n, p, s);
  });
}

// The backward's second launch: dw [n] of w_dtype = the column sums of ws,
// fp32 [parts, n], in a fixed order.
extern "C" int ptt_rms_norm_dw(const void* ws, void* dw, int parts, int n,
                               int w_dtype, void* stream) {
  if (parts <= 0 || n <= 0) return kInvalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wsf = static_cast<const float*>(ws);
  const dim3 grid((n + kDwCols - 1) / kDwCols);
  const int threads = kDwCols * kDwGroups;
  switch (w_dtype) {
    case ptt::kF32:
      rms_dw_sum<float><<<grid, threads, 0, s>>>(
          wsf, static_cast<float*>(dw), parts, n);
      break;
    case ptt::kBF16:
      rms_dw_sum<__nv_bfloat16><<<grid, threads, 0, s>>>(
          wsf, static_cast<__nv_bfloat16*>(dw), parts, n);
      break;
    case ptt::kF16:
      rms_dw_sum<__half><<<grid, threads, 0, s>>>(
          wsf, static_cast<__half*>(dw), parts, n);
      break;
    default: return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}
