// Flash attention forward: out = softmax(q k^T * scale [+ masks]) v and
// the fp32 log-sum-exp of every row, for [B, H, S, D] or [B, S, H, D] q
// with H_kv <= H key/value heads (GQA: kv head = q head / (H / H_kv)).
//
// Replaces: paddle_tpu/pallas/flash_attention.py _pallas_flash_fwd /
// _fwd_kernel, with all of its features: the causal mask, an fp32
// additive mask [B|1, H|1, S, S] (a boolean mask arrives as 0 / NEG_INF),
// segment ids [B, S] (packed varlen) and attention dropout by the Pallas
// counter hash (`Features`, flash_common.cuh).
//
// Bound on the H100.  Two products of 2 S^2 D flops per head (halved by a
// causal mask) against 2 S D H (2 + 2 / n_rep) bytes of q, k, v and out:
// at S 4096, D 128 that is ~2000 flops per byte, far above the ~295 where
// the bf16 tensor cores (989 TFLOP/s) bind, so for the Llama training
// shape (B 1, H 32, S 4096, causal) operations bind: 0.139 ms.  At GPT-2's
// (B 8, H 12, S 1024, D 64, causal) bytes bind: 50.7 MB, 0.0151 ms (the
// products 0.0130 ms).  A [B, 1, S, S] fp32 mask adds 4 bytes a live
// score (16.8 MB there, to 0.0201 ms); dropout adds ~12 integer
// operations a live score (0.6 G, ~0.01 ms at the CUDA cores' 67 T/s).
//
// Design.  The TPU kernel streamed K/V blocks through a sequential grid
// axis and carried (m, l, acc) in VMEM scratch; on Hopper one block of
// four warps owns a 64-row q tile of one (batch, head) and loops over
// 64-key K/V tiles itself, double-buffered in shared memory by cp.async.
// Each warp owns 16 q rows.  16-bit inputs: S = q k^T and p v run on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation) with q, k, v read
// by ldmatrix from padded rows (no bank conflicts).  The online softmax
// (m, l, the rescale of the accumulator) is fp32 in registers.  p stays
// in registers between the two products and, to keep p v in fp32 as the
// TPU kernel does (it casts q, k, v to fp32), p is split into a 16-bit
// head and a 16-bit remainder and both are multiplied: v is exact in 16
// bits, so p v loses only ~2^-16 of p.  fp32 inputs take a plain FMA
// kernel (32x32 tiles in shared memory).  Causal: the loop stops at the
// diagonal tile, so dead tiles are never fetched, and blocks are launched
// last q tile first (the longest loops start first).  The ragged tail of
// S is zero-filled on load and masked in the scores, so any S >= 1 works
// (the TPU kernel needed S % 128 == 0).  Features (FEAT = true, its own
// instantiation): every score of a masked call goes through
// `feature_score` (mask and segment ids read from global memory through
// L1, no tile skipping by segment) and the fully-masked guard; dropout
// regenerates the hash per score after the row sums (l sums the undropped
// p, as the Pallas kernel does) and before the head/remainder split.  A
// later PR can move the products to wgmma with TMA loads and a producer
// warp, and stage mask tiles in shared memory.
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;

constexpr int BQ = 64;   // q rows per block (16 per warp)
constexpr int BK = 64;   // keys per K/V tile

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int S, int H, int n_rep, Strides qs,
              Strides ks, Strides vs, Strides os, float scale, bool causal,
              Features f) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);     // [BQ][LD]
  T* k_s = q_s + BQ * LD;                      // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;

  const T* qg = q + b * qs.b + h * qs.h + q0 * qs.s;
  const T* kg = k + b * ks.b + kvh * ks.h;
  const T* vg = v + b * vs.b + kvh * vs.h;

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  load_tile<T, BQ, D>(q_s, qg, qs.s, S - q0, tid);
  load_tile<T, BK, D>(k_s, kg, ks.s, S, tid);
  load_tile<T, BK, D>(v_s, vg, vs.s, S, tid);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile<T, BK, D>(k_s + nb * BK * LD, kg + (k0 + BK) * ks.s, ks.s,
                          S - k0 - BK, tid);
      load_tile<T, BK, D>(v_s + nb * BK * LD, vg + (k0 + BK) * vs.s, vs.s,
                          S - k0 - BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a(qf[kk], q_s, LD, warp * 16, kk * 16, lane);
    }
    const T* kb = k_s + (j & 1) * BK * LD;
    const T* vb = v_s + (j & 1) * BK * LD;

    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t bf[4];
        load_b_nt(bf, kb, LD, nn * 16, kk * 16, lane);
        Mma<T>::run(s[2 * nn], qf[kk], bf);
        Mma<T>::run(s[2 * nn + 1], qf[kk], bf + 2);
      }
    }

    // a mask or segments touch every tile, not only the edges
    const bool edge =
        masked || (k0 + BK > S) || (causal && k0 + BK - 1 > q0);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (edge) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= S || (causal && col > row))
            x = kNegInf;
          else if (masked && row < S)
            x = feature_score(f, x, b, h, S, row, col);
        }
        s[nt][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = guard(expf(s[nt][e] - (e < 2 ? mn_a : mn_b)), s[nt][e]);
      } else {
        s[nt][0] = expf(s[nt][0] - mn_a);
        s[nt][1] = expf(s[nt][1] - mn_a);
        s[nt][2] = expf(s[nt][2] - mn_b);
        s[nt][3] = expf(s[nt][3] - mn_b);
      }
      rs_a += s[nt][0] + s[nt][1];
      rs_b += s[nt][2] + s[nt][3];
    }
    l_a = al_a * l_a + rs_a;
    l_b = al_b * l_b + rs_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= al_a;
      o[i][1] *= al_a;
      o[i][2] *= al_b;
      o[i][3] *= al_b;
    }
    if (drop) {
      // l holds the undropped sum; dropout acts on the p that meets v
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = dropped(f, bh, e < 2 ? row_a : row_b,
                             k0 + nt * 8 + 2 * t4 + (e & 1), s[nt][e]);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // p for keys 16 kk .. 16 kk + 15 as an A fragment, head and remainder
      float pv[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2],
                     s[2 * kk][3], s[2 * kk + 1][0], s[2 * kk + 1][1],
                     s[2 * kk + 1][2], s[2 * kk + 1][3]};
      float lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) lo[e] = pv[e] - Mma<T>::round(pv[e]);
      const uint32_t a_hi[4] = {
          Mma<T>::pack(pv[0], pv[1]), Mma<T>::pack(pv[2], pv[3]),
          Mma<T>::pack(pv[4], pv[5]), Mma<T>::pack(pv[6], pv[7])};
      const uint32_t a_lo[4] = {
          Mma<T>::pack(lo[0], lo[1]), Mma<T>::pack(lo[2], lo[3]),
          Mma<T>::pack(lo[4], lo[5]), Mma<T>::pack(lo[6], lo[7])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t bf[4];
        load_b_kn(bf, vb, LD, kk * 16, nn * 16, lane);
        Mma<T>::run(o[2 * nn], a_hi, bf);
        Mma<T>::run(o[2 * nn], a_lo, bf);
        Mma<T>::run(o[2 * nn + 1], a_hi, bf + 2);
        Mma<T>::run(o[2 * nn + 1], a_lo, bf + 2);
      }
    }
    __syncthreads();   // the next iteration's copy overwrites this buffer
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float L_a = fmaxf(l_a, 1e-30f), L_b = fmaxf(l_b, 1e-30f);
  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + row_a * os.s + col) =
          Mma<T>::pack(o[nt][0] / L_a, o[nt][1] / L_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + row_b * os.s + col) =
          Mma<T>::pack(o[nt][2] / L_b, o[nt][3] / L_b);
  }
  if (t4 == 0) {
    float* lb = lse + static_cast<int64_t>(bh) * S;
    if (row_a < S) lb[row_a] = m_a + logf(L_a);
    if (row_b < S) lb[row_b] = m_b + logf(L_b);
  }
}

// fp32 inputs: the same loop on FMA, 32 q rows x 32 keys per step.  Thread
// (r = tid / 4, c = tid % 4) owns row r's scores for keys c, c + 4, ...
// and its accumulator columns c, c + 4, ... (strided: no bank conflicts).
constexpr int FQ = 32, FK = 32;

template <int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int H, int n_rep, Strides qs,
              Strides ks, Strides vs, Strides os, float scale, bool causal,
              Features f) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [FQ][LD]
  float* k_s = q_s + FQ * LD;                         // [FK][LD]
  float* v_s = k_s + FK * LD;                         // [FK][D]
  float* p_s = v_s + FK * D;                          // [FQ][FK + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = qt * FQ;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int row = q0 + r;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;

  const float* qg = q + b * qs.b + h * qs.h;
  const float* kg = k + b * ks.b + kvh * ks.h;
  const float* vg = v + b * vs.b + kvh * vs.h;
  for (int i = tid; i < FQ * D; i += kThreads) {
    const int rr = i / D, dd = i - rr * D;
    q_s[rr * LD + dd] = q0 + rr < S ? qg[(q0 + rr) * qs.s + dd] : 0.f;
  }
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int n_tiles = (S + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, (q0 + FQ - 1) / FK + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FK;
    __syncthreads();
    for (int i = tid; i < FK * D; i += kThreads) {
      const int kk = i / D, dd = i - kk * D;
      const bool ok = k0 + kk < S;
      k_s[kk * LD + dd] = ok ? kg[(k0 + kk) * ks.s + dd] : 0.f;
      v_s[kk * D + dd] = ok ? vg[(k0 + kk) * vs.s + dd] : 0.f;
    }
    __syncthreads();
    float s[FK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < FK / 4; ++i) {
      const int kk = c + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) dot += q_s[r * LD + dd] * k_s[kk * LD + dd];
      float x = dot * scale;
      const int col = k0 + kk;
      if (col >= S || (causal && col > row))
        x = kNegInf;
      else if (masked && row < S)
        x = feature_score(f, x, b, h, S, row, col);
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < FK / 4; ++i) {
      float p = expf(s[i] - mn);
      if (masked) p = guard(p, s[i]);
      rs += p;
      if (drop) p = dropped(f, bh, row, k0 + c + 4 * i, p);
      p_s[r * (FK + 1) + c + 4 * i] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = alpha * l + rs;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int dd = c + 4 * i;
      float a = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < FK; ++kk) a += p_s[r * (FK + 1) + kk] * v_s[kk * D + dd];
      acc[i] = alpha * acc[i] + a;
    }
  }
  if (row < S) {
    const float L = fmaxf(l, 1e-30f);
    float* ob = out + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) ob[c + 4 * i] = acc[i] / L;
    if (c == 0) lse[static_cast<int64_t>(bh) * S + row] = m + logf(L);
  }
}

struct Call {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int b, h, h_kv, s;
  Strides qs, ks, vs, os;
  float scale;
  bool causal;
  Features f;
  cudaStream_t stream;
};

template <typename T, int D, bool FEAT>
int launch_mma(const Call& a) {
  constexpr int LD = D + 8;
  const size_t smem = sizeof(T) * static_cast<size_t>(BQ + 4 * BK) * LD;
  auto kernel = flash_fwd_mma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + BQ - 1) / BQ, a.b * a.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.s, a.h,
      a.h / a.h_kv, a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool FEAT>
int launch_f32(const Call& a) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(FQ + FK) * (D + 1) + FK * D + FQ * (FK + 1));
  auto kernel = flash_fwd_f32<D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + FQ - 1) / FQ, a.b * a.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.s,
      a.h, a.h / a.h_kv, a.qs, a.ks, a.vs, a.os, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool FEAT>
int dispatch(int dtype, const Call& a) {
  switch (dtype) {
    case ptt::kF32: return launch_f32<D, FEAT>(a);
    case ptt::kBF16: return launch_mma<__nv_bfloat16, D, FEAT>(a);
    case ptt::kF16: return launch_mma<__half, D, FEAT>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FEAT>
int run(int d, int dtype, const Call& a) {
  switch (d) {
    case 32: return dispatch<32, FEAT>(dtype, a);
    case 64: return dispatch<64, FEAT>(dtype, a);
    case 128: return dispatch<128, FEAT>(dtype, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Every value of x as a kept survivor (the check of `survivor`).
__global__ void dropout_rescale_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, long long n,
                                       Features f) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = survivor(f, true, x[i]);
}

}  // namespace

// q, out: [B, H, S, D] views with element strides (b, h, s) in
// strides[0..2] and strides[9..11]; k, v: [B, H_kv, S, D] views with
// strides[3..5] and strides[6..8]; D contiguous.  lse: fp32 [B, H, S].
// D in {32, 64, 128}; one dtype for q, k, v and out.  Features: `mask`
// fp32 with element strides (b, h, q) in mask_strides[0..2] (0 on a
// broadcast dim; keys contiguous) or null; `seg` int32 [B, S] or null;
// `dropout` in [0, 1) with `keep_div` = (float)(1 - dropout) and `seed`.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int h_kv,
                             int s, int d, const long long* strides,
                             float scale, int causal, int dtype,
                             const void* mask, const long long* mask_strides,
                             const void* seg, float dropout, float keep_div,
                             unsigned int seed, void* stream) {
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || s <= 0 ||
      !(dropout >= 0.f && dropout < 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Call a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.lse = static_cast<float*>(lse);
  a.b = b; a.h = h; a.h_kv = h_kv; a.s = s;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.scale = scale;
  a.causal = causal != 0;
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed);
  a.stream = static_cast<cudaStream_t>(stream);
  return a.f.any() ? run<true>(d, dtype, a) : run<false>(d, dtype, a);
}

// out = x / (float)(1 - dropout) rounded once, for n fp32 values, by the
// survivors' rescale that the flash kernels apply to kept values.
extern "C" int ptt_flash_dropout_rescale(const void* x, void* out,
                                         long long n, float dropout,
                                         float keep_div, void* stream) {
  if (n <= 0 || !(dropout >= 0.f && dropout < 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Features f =
      make_features(nullptr, nullptr, nullptr, dropout, keep_div, 0);
  const long long blocks = (n + 255) / 256;
  dropout_rescale_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                               : 4096),
                           256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}
