// Rotary position embedding of [B, S, H, D] with fp32 [S, D] cos/sin
// tables, neox (rotate halves) or interleaved (rotate pairs) layout.  The
// backward is the same kernel with the sign of sin flipped by `inverse`
// (the adjoint of a rotation is the rotation by the opposite angle).
//
// Replaces: paddle_tpu/pallas/fused.py _rope_kernel / _rope_call (both
// directions of rope_pallas).
//
// Bound on the H100 (3.35 TB/s): bytes.  It reads t and writes the output
// (2 x B S H D elements) plus the tables once (2 x S D fp32, reused by
// every head and batch row from L2); ~6 flops per element.  At
// [1, 4096, 32, 128] bf16 that is 71 MB, 21 us.
//
// Design.  The TPU kernel took a block of sequence rows per grid step
// (S % 8 == 0 in JAX's gate).  Here each thread owns one 16-byte vector of
// the output row (8 bf16/fp16 or 4 fp32 values) and its partners: in neox
// layout the vector at d and the one at d + D/2, in interleaved layout the
// pairs inside its own vector; the tables are read as float4.  Any S and
// any even D: a row length that does not split into vectors, or a
// misaligned pointer, takes a scalar path (one pair per thread).  The math
// is fp32 in the TPU kernel's order, t cos + rot sin (neox) and
// t1 c - t2 s / t2 c + t1 s (interleaved), each product and sum rounded
// on its own (no fused multiply-add), with one rounding to t's type.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// out of neox: o1 = t1 cos1 + (-t2) sin1, o2 = t2 cos2 + t1 sin2
__device__ __forceinline__ void neox_pair(float t1, float t2, float c1,
                                          float s1, float c2, float s2,
                                          float& o1, float& o2) {
  o1 = __fadd_rn(mul(t1, c1), mul(-t2, s1));
  o2 = __fadd_rn(mul(t2, c2), mul(t1, s2));
}

__device__ __forceinline__ void inter_pair(float t1, float t2, float c,
                                           float s, float& o1, float& o2) {
  o1 = __fsub_rn(mul(t1, c), mul(t2, s));
  o2 = __fadd_rn(mul(t2, c), mul(t1, s));
}

template <typename T>
__global__ void rope_vec_kernel(const T* __restrict__ t,
                                const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t,
                                T* __restrict__ out, int64_t rows, int S,
                                int H, int D, bool neox, bool inverse) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = neox ? D / 2 / V : D / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= rows * per_row) return;
  const int64_t row = idx / per_row;
  const int d0 = static_cast<int>(idx - row * per_row) * V;
  const int s = static_cast<int>((row / H) % S);
  const T* tr = t + row * D;
  T* orow = out + row * D;
  const float* cr = cos_t + static_cast<int64_t>(s) * D;
  const float* sr = sin_t + static_cast<int64_t>(s) * D;
  const float sg = inverse ? -1.f : 1.f;
  if (neox) {
    const int half = D / 2;
    uint4 ra = *reinterpret_cast<const uint4*>(tr + d0);
    uint4 rb = *reinterpret_cast<const uint4*>(tr + d0 + half);
    const T* ea = reinterpret_cast<const T*>(&ra);
    const T* eb = reinterpret_cast<const T*>(&rb);
    uint4 oa, ob;
    T* pa = reinterpret_cast<T*>(&oa);
    T* pb = reinterpret_cast<T*>(&ob);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float o1, o2;
      neox_pair(ptt::to_f32(ea[k]), ptt::to_f32(eb[k]), __ldg(cr + d0 + k),
                sg * __ldg(sr + d0 + k), __ldg(cr + d0 + half + k),
                sg * __ldg(sr + d0 + half + k), o1, o2);
      pa[k] = ptt::from_f32<T>(o1);
      pb[k] = ptt::from_f32<T>(o2);
    }
    *reinterpret_cast<uint4*>(orow + d0) = oa;
    *reinterpret_cast<uint4*>(orow + d0 + half) = ob;
  } else {
    uint4 ra = *reinterpret_cast<const uint4*>(tr + d0);
    const T* e = reinterpret_cast<const T*>(&ra);
    uint4 oa;
    T* p = reinterpret_cast<T*>(&oa);
#pragma unroll
    for (int k = 0; k < V; k += 2) {
      float o1, o2;
      inter_pair(ptt::to_f32(e[k]), ptt::to_f32(e[k + 1]),
                 __ldg(cr + d0 + k), sg * __ldg(sr + d0 + k), o1, o2);
      p[k] = ptt::from_f32<T>(o1);
      p[k + 1] = ptt::from_f32<T>(o2);
    }
    *reinterpret_cast<uint4*>(orow + d0) = oa;
  }
}

// one (d, partner) pair per thread: any even D, any alignment
template <typename T>
__global__ void rope_scalar_kernel(const T* __restrict__ t,
                                   const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t,
                                   T* __restrict__ out, int64_t rows, int S,
                                   int H, int D, bool neox, bool inverse) {
  const int half = D / 2;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= rows * half) return;
  const int64_t row = idx / half;
  const int i = static_cast<int>(idx - row * half);
  const int s = static_cast<int>((row / H) % S);
  const T* tr = t + row * D;
  T* orow = out + row * D;
  const float* cr = cos_t + static_cast<int64_t>(s) * D;
  const float* sr = sin_t + static_cast<int64_t>(s) * D;
  const float sg = inverse ? -1.f : 1.f;
  float o1, o2;
  if (neox) {
    neox_pair(ptt::to_f32(tr[i]), ptt::to_f32(tr[i + half]), cr[i],
              sg * sr[i], cr[i + half], sg * sr[i + half], o1, o2);
    orow[i] = ptt::from_f32<T>(o1);
    orow[i + half] = ptt::from_f32<T>(o2);
  } else {
    inter_pair(ptt::to_f32(tr[2 * i]), ptt::to_f32(tr[2 * i + 1]),
               cr[2 * i], sg * sr[2 * i], o1, o2);
    orow[2 * i] = ptt::from_f32<T>(o1);
    orow[2 * i + 1] = ptt::from_f32<T>(o2);
  }
}

template <typename T>
int launch(const void* t, const float* c, const float* s, void* out, int b,
           int S, int h, int d, bool neox, bool inverse,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t rows = static_cast<int64_t>(b) * S * h;
  const bool vec = (neox ? (d / 2) % V == 0 : d % V == 0) &&
                   reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;
  if (vec) {
    const int64_t n = rows * (neox ? d / 2 / V : d / V);
    rope_vec_kernel<T><<<static_cast<unsigned>((n + threads - 1) / threads),
                         threads, 0, stream>>>(
        static_cast<const T*>(t), c, s, static_cast<T*>(out), rows, S, h, d,
        neox, inverse);
  } else {
    const int64_t n = rows * (d / 2);
    rope_scalar_kernel<T><<<static_cast<unsigned>((n + threads - 1) / threads),
                            threads, 0, stream>>>(
        static_cast<const T*>(t), c, s, static_cast<T*>(out), rows, S, h, d,
        neox, inverse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t, out: contiguous [b, S, h, d] of dtype; cos, sin: contiguous fp32
// [S, d]; d even.  inverse != 0 rotates by -angle (the backward).
extern "C" int ptt_rope(const void* t, const void* cos, const void* sin,
                        void* out, int b, int s, int h, int d, int neox,
                        int inverse, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || d <= 0 || d % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  const bool nx = neox != 0, inv = inverse != 0;
  switch (dtype) {
    case ptt::kF32: return launch<float>(t, c, sn, out, b, s, h, d, nx, inv, st);
    case ptt::kBF16: return launch<__nv_bfloat16>(t, c, sn, out, b, s, h, d, nx, inv, st);
    case ptt::kF16: return launch<__half>(t, c, sn, out, b, s, h, d, nx, inv, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
