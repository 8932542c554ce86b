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
// ~0.6 us.
//
// Design, as Punica does it: two kernels and an fp32 intermediate, no
// gathered copy of A or B (each block reads its own row's adapter slot
// from idx and indexes the stacks with it).
// - shrink: one block per (row, tile of 8 tokens, chunk of 512 input
//   columns) stages the x tile in shared memory as fp32, then its threads
//   (one per (rank column, input lane)) read A[slot] rows coalesced, keep
//   8 fp32 sums in registers, and reduce over the lanes in a fixed order.
//   It writes partial[row, chunk, token, rank], so no atomics and the
//   result does not depend on the block order.
// - expand: one block per (row, tile of 8 tokens, 256 output columns)
//   sums the partials over the chunks in order into xa[token, rank] in
//   shared memory, then each thread takes one output column: B[slot] rows
//   read coalesced, 8 fp32 sums, times the scale, one rounding.
// No tensor cores: at these ranks the factors' bytes bind, not the
// products.  An index outside the pool writes NaN rows.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeqTile = 8;
constexpr int kChunk = 512;
constexpr int kMaxRank = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a_stack,
                   const int* __restrict__ idx, float* __restrict__ partial,
                   int seq, int din, int rp, int n_split, int n_pool) {
  __shared__ float x_s[kSeqTile * kChunk];
  __shared__ float red[kThreads * kSeqTile];
  const int i = blockIdx.x;
  const int s0 = blockIdx.y * kSeqTile;
  const int z = blockIdx.z;
  const int k0 = z * kChunk;
  const int n_tok = min(kSeqTile, seq - s0);
  const int n_k = min(kChunk, din - k0);
  const int tid = threadIdx.x;
  const int slot = idx[i];
  const bool valid = slot >= 0 && slot < n_pool;
  for (int e = tid; e < n_tok * n_k; e += kThreads) {
    const int t = e / n_k, k = e - t * n_k;
    x_s[t * kChunk + k] =
        ptt::to_f32(x[(static_cast<size_t>(i) * seq + s0 + t) * din + k0 + k]);
  }
  __syncthreads();
  const int lanes = kThreads / rp;
  const int r = tid % rp, lane = tid / rp;
  float acc[kSeqTile];
#pragma unroll
  for (int t = 0; t < kSeqTile; ++t) acc[t] = 0.f;
  if (lane < lanes && valid) {
    const T* a = a_stack + (static_cast<size_t>(slot) * din + k0) * rp + r;
    for (int k = lane; k < n_k; k += lanes) {
      const float av = ptt::to_f32(a[static_cast<size_t>(k) * rp]);
#pragma unroll
      for (int t = 0; t < kSeqTile; ++t)
        if (t < n_tok) acc[t] += x_s[t * kChunk + k] * av;
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int t = 0; t < kSeqTile; ++t)
      if (t < n_tok) red[(lane * kSeqTile + t) * rp + r] = acc[t];
  }
  __syncthreads();
  for (int e = tid; e < n_tok * rp; e += kThreads) {
    const int t = e / rp, rr = e - t * rp;
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[(l * kSeqTile + t) * rp + rr];
    partial[((static_cast<size_t>(i) * n_split + z) * seq + s0 + t) * rp + rr] =
        valid ? sum : NAN;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_expand_kernel(const float* __restrict__ partial,
                   const T* __restrict__ b_stack, const T* __restrict__ scale,
                   const int* __restrict__ idx, T* __restrict__ out, int seq,
                   int dout, int rp, int n_split, int n_pool) {
  __shared__ float xa_s[kSeqTile * kMaxRank];
  const int i = blockIdx.x;
  const int s0 = blockIdx.y * kSeqTile;
  const int n = blockIdx.z * kThreads + threadIdx.x;
  const int n_tok = min(kSeqTile, seq - s0);
  const int tid = threadIdx.x;
  for (int e = tid; e < n_tok * rp; e += kThreads) {
    const int t = e / rp, r = e - t * rp;
    float sum = 0.f;
    for (int z = 0; z < n_split; ++z)
      sum += partial[((static_cast<size_t>(i) * n_split + z) * seq + s0 + t) * rp + r];
    xa_s[t * rp + r] = sum;
  }
  __syncthreads();
  if (n >= dout) return;
  int slot = idx[i];
  const bool valid = slot >= 0 && slot < n_pool;
  if (!valid) slot = 0;     // the rows are NaN already (shrink)
  const float sc = ptt::to_f32(scale[slot]);
  float acc[kSeqTile];
#pragma unroll
  for (int t = 0; t < kSeqTile; ++t) acc[t] = 0.f;
  const T* bcol = b_stack + static_cast<size_t>(slot) * rp * dout + n;
  for (int r = 0; r < rp; ++r) {
    const float bv = ptt::to_f32(bcol[static_cast<size_t>(r) * dout]);
#pragma unroll
    for (int t = 0; t < kSeqTile; ++t)
      if (t < n_tok) acc[t] += xa_s[t * rp + r] * bv;
  }
#pragma unroll
  for (int t = 0; t < kSeqTile; ++t)
    if (t < n_tok)
      out[(static_cast<size_t>(i) * seq + s0 + t) * dout + n] =
          ptt::from_f32<T>(acc[t] * sc);
}

template <typename T>
int launch(const void* x, const void* a_stack, const void* b_stack,
           const void* scale, const int* idx, float* partial, void* out,
           int ns, int seq, int din, int dout, int rp, int n_split,
           int n_pool, cudaStream_t stream) {
  const int seq_tiles = (seq + kSeqTile - 1) / kSeqTile;
  lora_shrink_kernel<T><<<dim3(ns, seq_tiles, n_split), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_stack), idx, partial,
      seq, din, rp, n_split, n_pool);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (dout + kThreads - 1) / kThreads;
  lora_expand_kernel<T><<<dim3(ns, seq_tiles, n_tiles), kThreads, 0, stream>>>(
      partial, static_cast<const T*>(b_stack), static_cast<const T*>(scale),
      idx, static_cast<T*>(out), seq, dout, rp, n_split, n_pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [ns, seq, din]; a_stack: [n_pool, din, rp]; b_stack: [n_pool, rp, dout];
// scale: [n_pool]; out: [ns, seq, dout], all of `dtype`; idx: int32 [ns];
// partial: float32 [ns, n_split, seq, rp] scratch, n_split = ceil(din / 512).
extern "C" int ptt_lora_delta(const void* x, const void* a_stack,
                              const void* b_stack, const void* scale,
                              const void* idx, void* partial, void* out,
                              int ns, int seq, int din, int dout, int rp,
                              int n_split, int n_pool, int dtype,
                              void* stream) {
  if (ns <= 0 || seq <= 0 || din <= 0 || dout <= 0 || rp <= 0 ||
      rp > kMaxRank || n_pool <= 0 || n_split != (din + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* part = static_cast<float*>(partial);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(x, a_stack, b_stack, scale, ix, part, out, ns, seq,
                           din, dout, rp, n_split, n_pool, s);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(x, a_stack, b_stack, scale, ix, part, out,
                                   ns, seq, din, dout, rp, n_split, n_pool, s);
    case ptt::kF16:
      return launch<__half>(x, a_stack, b_stack, scale, ix, part, out, ns, seq,
                            din, dout, rp, n_split, n_pool, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
