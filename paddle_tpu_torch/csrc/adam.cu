// Adam / AdamW update of one parameter, in place: the fp32 working value w
// (the fp32 master of a 16-bit parameter, or the fp32 parameter itself),
// the fp32 moments m1 and m2, a gradient g of the parameter's type, and for
// a 16-bit parameter p = w rounded to p's type.
//
// Replaces: paddle_tpu/pallas/fused.py _adam_kernel / adam_update_pallas.
//
// Scalars on the device.  As the Pallas kernel reads scal_ref, the kernel
// reads [lr * lr_scale, bc1, bc2, gscale] (fp32, bc = 1 - beta^t) from
// device memory, and an optional device skip flag (one byte; nullptr:
// none): when it is set, the kernel writes nothing.  So one launch serves
// every step of a CUDA graph: the step counter, the schedule's lr, the
// global-norm clip's scale and the loss scaler's found-inf decision all
// live on the card (kernels/adam.py adam_scalars).
//
// The clip's scale.  gscale = clip_norm / max(norm, clip_norm) (1 without
// a global-norm clip) is applied as g is loaded: float(G(float(g) * s)),
// the JAX clip's (g.astype(f32) * s).astype(g.dtype) then the update's
// astype(f32), one rounding to g's type.  So the clip reads each gradient
// once for its norm and writes nothing; at s = 1 the product and the
// rounding are exact and the update is the unclipped one, bit for bit.
//
// Bound on the H100 (3.35 TB/s): bytes.  Each element reads and writes w,
// m1 and m2 (24 B), reads g and, for a 16-bit parameter with a master,
// writes p: 28 B for bf16, ~15 fp32 operations, far under the 67 TFLOP/s
// of the non-tensor fp32 pipes.  A 4096 x 11008 bf16 weight is 1.26 GB,
// 0.38 ms; the 1.88 B parameters of the 8-layer, 7B-width model 15.7 ms.
//
// Design.  The TPU kernel took [rows, 128] row blocks of a parameter whose
// size is a multiple of 1024 (the JAX package sends any other size to its
// jnp lane).  Here each thread owns 4 consecutive elements, loaded and
// stored as one vector per tensor (16 B of fp32, 8 B of bf16/fp16), and
// any element count is taken: the last thread handles the tail element by
// element, and a misaligned pointer sends the whole call to a kernel of one
// element per thread.  The arithmetic is the jnp lane's (optimizer.py
// Adam._fused_update, the op order of _adam_kernel), each product, sum,
// quotient and root rounded on its own: __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn keep nvcc from contracting a multiply-add, so the kernel is
// bitwise equal to its plain version (kernels/adam.py) and to the JAX lane.
#include <cstdint>

#include "common.cuh"

namespace {

enum Decay : int { kNoDecay = 0, kCoupled = 1, kDecoupled = 2 };

struct AdamArgs {
  float lr, bc1, bc2, gs;  // read from the device by each thread (`scalars`)
  float b1, omb1, b2, omb2, eps, wd;               // omb = fp32(1 - beta)
  int decay;
};

// The launch's device scalars into `a`; false when the skip flag is set.
__device__ __forceinline__ bool scalars(AdamArgs& a,
                                        const float* __restrict__ scal,
                                        const uint8_t* __restrict__ skip) {
  if (skip != nullptr && *skip) return false;
  a.lr = scal[0];
  a.bc1 = scal[1];
  a.bc2 = scal[2];
  a.gs = scal[3];
  return true;
}

// g as the update reads it: scaled by the clip's gscale in fp32, rounded to
// g's own type, widened back
template <typename G>
__device__ __forceinline__ float load_g(G g, float gs) {
  return ptt::to_f32(ptt::from_f32<G>(__fmul_rn(ptt::to_f32(g), gs)));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ void adam_elem(float& w, float gf, float& m1,
                                          float& m2, const AdamArgs& a) {
  if (a.decay == kCoupled) gf = __fadd_rn(gf, __fmul_rn(a.wd, w));
  m1 = __fadd_rn(__fmul_rn(a.b1, m1), __fmul_rn(a.omb1, gf));
  m2 = __fadd_rn(__fmul_rn(a.b2, m2), __fmul_rn(a.omb2, __fmul_rn(gf, gf)));
  float upd = __fdiv_rn(__fdiv_rn(m1, a.bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(m2, a.bc2)), a.eps));
  if (a.decay == kDecoupled) upd = __fadd_rn(upd, __fmul_rn(a.wd, w));
  w = __fsub_rn(w, __fmul_rn(a.lr, upd));
}

// P is the parameter's type when kHasP (p written), unused otherwise
template <typename G, typename P, bool kHasP, int V>
__global__ void adam_kernel(float* __restrict__ w, const G* __restrict__ g,
                            float* __restrict__ m1, float* __restrict__ m2,
                            P* __restrict__ p, int64_t n, AdamArgs a,
                            const float* __restrict__ scal,
                            const uint8_t* __restrict__ skip) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t base = i * V;
  if (base >= n || !scalars(a, scal, skip)) return;
  if (base + V <= n) {
    Pack<float, V> wv = reinterpret_cast<const Pack<float, V>*>(w)[i];
    Pack<float, V> av = reinterpret_cast<const Pack<float, V>*>(m1)[i];
    Pack<float, V> bv = reinterpret_cast<const Pack<float, V>*>(m2)[i];
    const Pack<G, V> gv = reinterpret_cast<const Pack<G, V>*>(g)[i];
    Pack<P, V> pv;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      adam_elem(wv.v[k], load_g(gv.v[k], a.gs), av.v[k], bv.v[k], a);
      if (kHasP) pv.v[k] = ptt::from_f32<P>(wv.v[k]);
    }
    reinterpret_cast<Pack<float, V>*>(w)[i] = wv;
    reinterpret_cast<Pack<float, V>*>(m1)[i] = av;
    reinterpret_cast<Pack<float, V>*>(m2)[i] = bv;
    if (kHasP) reinterpret_cast<Pack<P, V>*>(p)[i] = pv;
  } else {
    for (int64_t j = base; j < n; ++j) {
      float wj = w[j], aj = m1[j], bj = m2[j];
      adam_elem(wj, load_g(g[j], a.gs), aj, bj, a);
      w[j] = wj;
      m1[j] = aj;
      m2[j] = bj;
      if (kHasP) p[j] = ptt::from_f32<P>(wj);
    }
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename G, typename P, bool kHasP>
int launch(float* w, const void* g, float* m1, float* m2, void* p, int64_t n,
           const AdamArgs& a, const float* scal, const uint8_t* skip,
           cudaStream_t stream) {
  constexpr int V = 4;
  const bool vec = aligned(w, 16) && aligned(m1, 16) && aligned(m2, 16) &&
                   aligned(g, sizeof(G) * V) &&
                   (!kHasP || aligned(p, sizeof(P) * V));
  const int threads = 256;
  const int64_t work = vec ? (n + V - 1) / V : n;
  const unsigned blocks = static_cast<unsigned>((work + threads - 1) / threads);
  if (vec)
    adam_kernel<G, P, kHasP, V><<<blocks, threads, 0, stream>>>(
        w, static_cast<const G*>(g), m1, m2, static_cast<P*>(p), n, a, scal,
        skip);
  else
    adam_kernel<G, P, kHasP, 1><<<blocks, threads, 0, stream>>>(
        w, static_cast<const G*>(g), m1, m2, static_cast<P*>(p), n, a, scal,
        skip);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int dispatch_p(float* w, const void* g, float* m1, float* m2, void* p,
               int p_dtype, int64_t n, const AdamArgs& a, const float* sc,
               const uint8_t* sk, cudaStream_t st) {
  if (p == nullptr)
    return launch<G, float, false>(w, g, m1, m2, p, n, a, sc, sk, st);
  switch (p_dtype) {
    case ptt::kBF16:
      return launch<G, __nv_bfloat16, true>(w, g, m1, m2, p, n, a, sc, sk,
                                            st);
    case ptt::kF16:
      return launch<G, __half, true>(w, g, m1, m2, p, n, a, sc, sk, st);
    case ptt::kF32:
      return launch<G, float, true>(w, g, m1, m2, p, n, a, sc, sk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// w, m1, m2: fp32 [n], updated in place; g: [n] of g_dtype; p: [n] of
// p_dtype written with w's new value rounded, or null.  scal: fp32 [4] on
// the device, [lr * lr_scale, 1 - b1^t, 1 - b2^t, gscale]; skip: one byte on the
// device or null, nonzero to write nothing.  decay: 0 none, 1 L2-coupled
// (Adam), 2 decoupled (AdamW).  omb1/omb2 are fp32(1 - beta), computed by
// the caller as the JAX lane computes them.
extern "C" int ptt_adam_update(void* w, const void* g, void* m1, void* m2,
                               void* p, long long n, const void* scal,
                               const void* skip, float b1, float omb1,
                               float b2, float omb2, float eps, float wd,
                               int decay, int g_dtype, int p_dtype,
                               void* stream) {
  if (n <= 0 || scal == nullptr || decay < kNoDecay || decay > kDecoupled)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamArgs a{0.f, 0.f, 0.f, 1.f, b1, omb1, b2, omb2, eps, wd, decay};
  const float* sc = static_cast<const float*>(scal);
  const uint8_t* sk = static_cast<const uint8_t*>(skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(w);
  float* m1f = static_cast<float*>(m1);
  float* m2f = static_cast<float*>(m2);
  switch (g_dtype) {
    case ptt::kF32:
      return dispatch_p<float>(wf, g, m1f, m2f, p, p_dtype, n, a, sc, sk, st);
    case ptt::kBF16:
      return dispatch_p<__nv_bfloat16>(wf, g, m1f, m2f, p, p_dtype, n, a, sc,
                                       sk, st);
    case ptt::kF16:
      return dispatch_p<__half>(wf, g, m1f, m2f, p, p_dtype, n, a, sc, sk,
                                st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
