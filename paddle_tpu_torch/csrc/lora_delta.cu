// Gathered multi-LoRA delta: out[i] = (x[i] @ A[idx[i]]) @ B[idx[i]] *
// scale[idx[i]] for each batch row i, every row through its own adapter's
// factors, read from the pool stacks where they lie.
//
// Replaces: paddle_tpu/serving/adapters.py _pallas_delta (the inline
// Pallas kernel whose scalar-prefetched idx drives the A/B BlockSpec index
// maps).  As there, x and the factors go to fp32, x·A and (x·A)·B are
// taken in fp32, multiplied by the fp32 scale and rounded once to x's
// type.
//
// Bound on the H100: bytes.  The work is 2 * ns * seq * rp * (din + dout)
// operations against reading x, the factors of the distinct adapters in
// idx and writing the delta; at rank 16 that is ~16 operations per byte of
// A or B at decode (seq 1) and ~60 at a 32-token prefill chunk, below the
// ~295 where the tensor cores would bind.  Llama-2 7B's 4096 -> 11008
// projection with four distinct rank-16 adapters reads ~1.9 MB of factors,
// ~0.6 us.  At decode the call is a chain of dependent steps (idx, then
// the factors, then a reduction across blocks), so its time is latency:
// the design keeps that chain short and every load of a step in flight at
// once.
//
// Design: one launch, no gathered copy of A or B and no scratch in device
// memory.  For each (batch row, tile of 8 tokens) the grid holds R
// thread-block clusters of C blocks (C <= 8, portable), sized from din and
// dout so that four decode rows still spread over the card's SMs.  Block c
// of a cluster reads its row's adapter slot, then issues, all at once, 16-
// byte asynchronous copies of its 1/C chunk of the x rows and of A[slot]
// (contiguous rows of rp values) and of the first B[slot] columns it will
// expand, into shared memory.  It computes its chunk's [tokens, rp]
// partial of x·A in fp32 (each thread a fixed group of 16 bytes of rank
// columns over strided rows, then butterfly shuffles and a sum over the
// warps in a fixed order) into its own shared memory.  One cluster barrier,
// then every block sums the C partials through distributed shared memory
// in rank order, so the blocks of a cluster hold the same bits of x·A; no
// atomics, so two calls give the same bits.  Each block then expands its
// share of the dout columns from the staged B, times the scale, rounded
// once, stored 16 bytes a thread.  The R clusters of a row repeat the
// shrink (A again, from L2) to put more SMs on the B columns.  Ranks whose
// 16-byte groups are not a power of two (or unaligned shapes) take the same
// kernel with element-wise copies.  No tensor cores: at these ranks the
// factors' bytes bind, not the products.  An index outside the pool
// writes NaN rows.
#include <cooperative_groups.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeqTile = 8;
constexpr int kMaxRank = 256;
constexpr int kMaxCluster = 8;
constexpr int kStageBytes = 32 * 1024;   // A rows, or B columns, a stage

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// `rows` rows of `cols` elements, src (row stride `src_ld` elements) ->
// dst (row stride `dst_ld`): 16-byte asynchronous copies spread over the
// block's threads (VEC: 16-byte aligned rows, cols a multiple of 16
// bytes; complete at cp_async_wait_all) or element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      size_t src_ld, int rows, int cols) {
  constexpr int kVe = VEC ? 16 / sizeof(T) : 1;
  const int per_row = cols / kVe;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, e = (v - r * per_row) * kVe;
    if constexpr (VEC)
      cp_async16(dst + r * dst_ld + e, src + r * src_ld + e);
    else
      dst[r * dst_ld + e] = src[r * src_ld + e];
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_vec(float* v, const T* p) {
  constexpr int kVe = VEC ? 16 / sizeof(T) : 1;
  if constexpr (VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVe; ++u) v[u] = ptt::to_f32(e[u]);
  } else {
    v[0] = ptt::to_f32(*p);
  }
}

// Grid (R * C, token tiles, rows), clusters of C blocks along x.  kc: the
// input columns of a cluster block; kr: the A rows staged at a time; nc:
// the output columns of a block; cw: the B columns staged at a time (all
// multiples of 8).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
lora_delta_kernel(const T* __restrict__ x, const T* __restrict__ a_stack,
                  const T* __restrict__ b_stack, const T* __restrict__ scale,
                  const int* __restrict__ idx, T* __restrict__ out, int seq,
                  int din, int dout, int rp, int n_pool, int kc, int kr,
                  int nc, int cw) {
  // VEC: a thread owns kVe rank columns (16 bytes); G groups of them span
  // a row of A, L threads stride over its rows.  Otherwise one column.
  constexpr int kVe = VEC ? 16 / sizeof(T) : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);                 // [kr][rp]
  T* b_s = a_s + kr * rp;                              // [rp][cw]
  T* x_s = b_s + rp * cw;                              // [kSeqTile][kr]
  float* part_s = reinterpret_cast<float*>(x_s + kSeqTile * kr);
  float* xa_s = part_s + kSeqTile * rp;                // [kSeqTile][rp]
  float* red = xa_s + kSeqTile * rp;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.z, s0 = blockIdx.y * kSeqTile;
  const int n_tok = min(kSeqTile, seq - s0);
  const int tid = threadIdx.x, lane32 = tid & 31, warp = tid >> 5;
  const int slot_in = idx[i];
  const bool valid = slot_in >= 0 && slot_in < n_pool;
  const int slot = valid ? slot_in : 0;   // NaN rows: see part_s below
  const T* a = a_stack + static_cast<size_t>(slot) * din * rp;
  const T* bm = b_stack + static_cast<size_t>(slot) * rp * dout;
  const T* xr = x + (static_cast<size_t>(i) * seq + s0) * din;

  // this block's B columns; the first stage is in flight with the shrink's
  const int n_begin = blockIdx.x * nc;
  const int n_end = min(dout, n_begin + nc);
  auto stage_b = [&](int n0) {
    stage<T, VEC>(b_s, cw, bm + n0, dout, rp, min(cw, n_end - n0));
  };
  if (n_begin < n_end) stage_b(n_begin);

  // ---- shrink: this block's chunk of x·A, [tokens, rp] in fp32
  const int G = VEC ? rp / kVe : rp;
  const int L = kThreads / G;
  const int gi = tid % G, ln = tid / G;
  float acc[kSeqTile][kVe];
#pragma unroll
  for (int t = 0; t < kSeqTile; ++t)
#pragma unroll
    for (int u = 0; u < kVe; ++u) acc[t][u] = 0.f;
  const int k_end = min(din, (c + 1) * kc);
  for (int k0 = c * kc; k0 < k_end; k0 += kr) {
    const int rows = min(kr, k_end - k0);
    stage<T, VEC>(a_s, 0, a + static_cast<size_t>(k0) * rp, 0, 1, rows * rp);
    stage<T, VEC>(x_s, kr, xr + k0, din, n_tok, rows);
    cp_async_wait_all();
    __syncthreads();
    if (ln < L) {
#pragma unroll 4
      for (int k = ln; k < rows; k += L) {
        float av[kVe];
        load_vec<T, VEC>(av, a_s + k * rp + gi * kVe);
#pragma unroll
        for (int t = 0; t < kSeqTile; ++t) {
          if (t < n_tok) {
            const float xv = ptt::to_f32(x_s[t * kr + k]);
#pragma unroll
            for (int u = 0; u < kVe; ++u) acc[t][u] = fmaf(xv, av[u], acc[t][u]);
          }
        }
      }
    }
    __syncthreads();   // the next stage overwrites a_s and x_s
  }
  // the threads of one rank group, in a fixed order
  if constexpr (VEC) {
    // lanes of a warp with the same group differ by multiples of G
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t)
        if (t < n_tok) {                   // n_tok is uniform
#pragma unroll
          for (int u = 0; u < kVe; ++u)
            acc[t][u] += __shfl_xor_sync(0xffffffffu, acc[t][u], off);
        }
    }
    if (lane32 < G) {
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t)
        if (t < n_tok) {
#pragma unroll
          for (int u = 0; u < kVe; ++u)
            red[(warp * kSeqTile + t) * rp + gi * kVe + u] = acc[t][u];
        }
    }
  } else {
    if (ln < L) {
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t)
        if (t < n_tok) red[(ln * kSeqTile + t) * rp + gi] = acc[t][0];
    }
  }
  __syncthreads();
  const int n_red = VEC ? kWarps : L;
  for (int e = tid; e < n_tok * rp; e += kThreads) {
    const int t = e / rp, r = e - t * rp;
    float sum = 0.f;
    for (int w = 0; w < n_red; ++w) sum += red[(w * kSeqTile + t) * rp + r];
    part_s[e] = valid ? sum : NAN;
  }

  // ---- the cluster's partials, summed in rank order in every block
  cluster.sync();
  for (int e = tid; e < n_tok * rp; e += kThreads) {
    float sum = 0.f;
    for (int cc = 0; cc < n_blocks; ++cc)
      sum += cluster.map_shared_rank(part_s, cc)[e];
    xa_s[e] = sum;
  }
  // no block leaves (freeing its partials) before every block has read them
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // ---- expand: this block's columns of (x·A)·B, times the scale
  const float sc = ptt::to_f32(scale[slot]);
  for (int n0 = n_begin; n0 < n_end; n0 += cw) {
    if (n0 != n_begin) {
      __syncthreads();   // every thread is done with the previous stage
      stage_b(n0);
    }
    cp_async_wait_all();
    __syncthreads();
    const int cols = min(cw, n_end - n0);
    for (int v = tid; v < cols / kVe; v += kThreads) {
      float o[kSeqTile][kVe];
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t)
#pragma unroll
        for (int u = 0; u < kVe; ++u) o[t][u] = 0.f;
      for (int r = 0; r < rp; ++r) {
        float bv[kVe];
        load_vec<T, VEC>(bv, b_s + r * cw + v * kVe);
#pragma unroll
        for (int t = 0; t < kSeqTile; ++t) {
          if (t < n_tok) {
            const float xv = xa_s[t * rp + r];
#pragma unroll
            for (int u = 0; u < kVe; ++u) o[t][u] = fmaf(xv, bv[u], o[t][u]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t) {
        if (t >= n_tok) continue;
        T* dst = out + (static_cast<size_t>(i) * seq + s0 + t) * dout + n0 +
                 v * kVe;
        if constexpr (VEC) {
          uint4 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int u = 0; u < kVe; ++u) e[u] = ptt::from_f32<T>(o[t][u] * sc);
          *reinterpret_cast<uint4*>(dst) = raw;
        } else {
          *dst = ptt::from_f32<T>(o[t][0] * sc);
        }
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Plan {
  int cluster, per_row, kc, kr, nc, cw;
  size_t smem;
};

int round8(int n) { return (n + 7) / 8 * 8; }

// Cluster size from din (a block reduces >= 512 input columns), clusters
// a row from the card's SMs and dout (a block expands >= 256 columns),
// stages within kStageBytes.
Plan plan(int ns, int seq, int din, int dout, int rp, int elem, int sms,
          bool vec) {
  Plan p{};
  p.cluster = std::min(kMaxCluster, std::max(1, (din + 511) / 512));
  p.kc = round8((din + p.cluster - 1) / p.cluster);
  const int tiles = ns * ((seq + kSeqTile - 1) / kSeqTile);
  const int want = (sms + tiles * p.cluster - 1) / (tiles * p.cluster);
  const int most = std::max(1, dout / (256 * p.cluster));
  const int r = std::max(1, std::min(want, most));
  p.per_row = r * p.cluster;
  p.nc = round8((dout + p.per_row - 1) / p.per_row);
  p.kr = std::min(p.kc, std::max(8, kStageBytes / (rp * elem) / 8 * 8));
  p.cw = std::min(p.nc, std::max(8, kStageBytes / (rp * elem) / 8 * 8));
  const size_t red = vec ? static_cast<size_t>(kWarps) * kSeqTile * rp
                         : static_cast<size_t>(kThreads) * kSeqTile;
  p.smem = static_cast<size_t>(elem) *
               (static_cast<size_t>(p.kr) * rp +
                static_cast<size_t>(rp) * p.cw +
                static_cast<size_t>(kSeqTile) * p.kr) +
           4 * (2 * static_cast<size_t>(kSeqTile) * rp + red);
  return p;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool VEC>
int launch(const void* x, const void* a_stack, const void* b_stack,
           const void* scale, const int* idx, void* out, int ns, int seq,
           int din, int dout, int rp, int n_pool, cudaStream_t stream) {
  auto kernel = lora_delta_kernel<T, VEC>;
  static const cudaError_t e = cudaFuncSetAttribute(     // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (e != cudaSuccess) return static_cast<int>(e);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const Plan p = plan(ns, seq, din, dout, rp, sizeof(T), sms, VEC);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.per_row, (seq + kSeqTile - 1) / kSeqTile, ns);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(a_stack),
      static_cast<const T*>(b_stack), static_cast<const T*>(scale), idx,
      static_cast<T*>(out), seq, din, dout, rp, n_pool, p.kc, p.kr, p.nc,
      p.cw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies where every row of A, B and x and every base allows
// them and a row of A is a power-of-two number (<= 32) of 16-byte groups
template <typename T>
int dispatch(const void* x, const void* a_stack, const void* b_stack,
             const void* scale, const int* idx, void* out, int ns, int seq,
             int din, int dout, int rp, int n_pool, cudaStream_t stream) {
  constexpr int kVe = 16 / sizeof(T);
  const int g = rp / kVe;
  const bool vec = rp % kVe == 0 && g <= 32 && (g & (g - 1)) == 0 &&
                   din % kVe == 0 && dout % kVe == 0 && aligned16(x) &&
                   aligned16(a_stack) && aligned16(b_stack) &&
                   aligned16(out);
  return vec ? launch<T, true>(x, a_stack, b_stack, scale, idx, out, ns, seq,
                               din, dout, rp, n_pool, stream)
             : launch<T, false>(x, a_stack, b_stack, scale, idx, out, ns,
                                seq, din, dout, rp, n_pool, stream);
}

}  // namespace

// x: [ns, seq, din]; a_stack: [n_pool, din, rp]; b_stack: [n_pool, rp, dout];
// scale: [n_pool]; out: [ns, seq, dout], all of `dtype` and contiguous;
// idx: int32 [ns]; rp <= 256.
extern "C" int ptt_lora_delta(const void* x, const void* a_stack,
                              const void* b_stack, const void* scale,
                              const void* idx, void* out, int ns, int seq,
                              int din, int dout, int rp, int n_pool,
                              int dtype, void* stream) {
  if (ns <= 0 || seq <= 0 || din <= 0 || dout <= 0 || rp <= 0 ||
      rp > kMaxRank || n_pool <= 0 || ns > 65535 ||
      (seq + kSeqTile - 1) / kSeqTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case ptt::kF32:
      return dispatch<float>(x, a_stack, b_stack, scale, ix, out, ns, seq,
                             din, dout, rp, n_pool, s);
    case ptt::kBF16:
      return dispatch<__nv_bfloat16>(x, a_stack, b_stack, scale, ix, out, ns,
                                     seq, din, dout, rp, n_pool, s);
    case ptt::kF16:
      return dispatch<__half>(x, a_stack, b_stack, scale, ix, out, ns, seq,
                              din, dout, rp, n_pool, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
