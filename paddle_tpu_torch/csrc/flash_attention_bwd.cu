// Flash attention backward, as two kernels: dK/dV and dQ.  Both recompute
// p = exp(s * scale - lse) from the forward's fp32 log-sum-exp, so nothing
// O(S^2) is stored; delta = rowsum(dO * O) comes in precomputed (one torch
// op, as the JAX package computes it outside Pallas).
//
// Replaces: paddle_tpu/pallas/flash_attention.py _pallas_flash_bwd, its
// _bwd_dkv_kernel (pallas_call at :578) and _bwd_dq_kernel (:608), with
// their features: the additive mask, segment ids and attention dropout
// (`Features`, flash_common.cuh), the same keep-mask as the forward's.
//
// Bound on the H100: operations.  dK/dV does four products of 2 S^2 D
// flops per head (s, dp, dv, dk) and dQ three (s, dp, dq): with the
// forward's two that is the usual 2.5x the forward, halved by a causal
// mask; bytes are O(S D), far below.  At the Llama training shape (B 1,
// H 32, S 4096, D 128, causal, bf16) the least time of both is 0.347 ms;
// at GPT-2's (B 8, H 12, S 1024, D 64, causal) dK/dV 0.0261 ms and dQ
// 0.0195 ms.  A [B, 1, S, S] fp32 mask adds 4 bytes a live score (16.8 MB
// there), which makes bytes bind: dK/dV 0.0278 ms, dQ 0.0240 ms.  The
// dropout hash (~12 integer operations a live score, on the CUDA cores)
// stays below the products.
//
// Design.  The TPU dK/dV kernel kept one kv block resident and streamed
// (q head of the GQA group, q block) through its innermost sequential grid
// axis into VMEM accumulators.  Here one block of four warps owns 64 keys
// of one (batch, kv head), keeps K and V in shared memory, and loops over
// the n_rep q heads that share the kv head and over their 32-row q tiles
// from the diagonal on (causal), double-buffering q, dO, lse and delta by
// cp.async; each warp accumulates dK and dV for its 16 keys in fp32
// registers and writes them once.  No atomics: the GQA heads are summed
// inside the block.  The dQ kernel is the forward's shape: one block per
// 64-row q tile of one (batch, head), looping over 64-key K/V tiles up to
// the diagonal.  16-bit inputs run the five products on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation); s = q k^T and dp = dO v^T are
// computed transposed in the dK/dV kernel (keys as rows), so p^T and dS^T
// feed the next products straight from registers, rounded to the input's
// 16-bit type as the tensor cores need.  fp32 inputs take plain FMA kernels
// with 32x32 tiles.  Any S >= 1: ragged rows and keys are zero-filled and
// masked.  Features (FEAT = true, its own instantiation), where p is
// recomputed: the mask and segments through `feature_score` and the
// fully-masked guard on every live score; dropout by the forward's hash at
// the same (b * H + q head, q, key): dK/dV feeds the dropped p / (1 - p)
// to dV and the dropped dp / (1 - p) to dS = p (dp - delta) scale with the
// undropped p; dQ drops dp alike.
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

using namespace ptt::flash;

// ---------------------------------------------------------------- dK/dV
constexpr int KB = 64;   // keys per block (16 per warp)
constexpr int QB = 32;   // q rows per step

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int H, int n_rep, Strides qs,
                  Strides ks, Strides vs, Strides dos, Strides dks,
                  Strides dvs, float scale, bool causal, Features f) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);           // [KB][LD]
  T* v_s = k_s + KB * LD;                            // [KB][LD]
  T* q_s = v_s + KB * LD;                            // [2][QB][LD]
  T* do_s = q_s + 2 * QB * LD;                       // [2][QB][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * QB * LD);  // [2][QB]
  float* dl_s = lse_s + 2 * QB;                                 // [2][QB]

  const int h_kv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / h_kv, kvh = bkv - b * h_kv;
  const int k0 = blockIdx.x * KB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;

  load_tile<T, KB, D>(k_s, k + b * ks.b + kvh * ks.h + k0 * ks.s, ks.s,
                      S - k0, tid);
  load_tile<T, KB, D>(v_s, v + b * vs.b + kvh * vs.h + k0 * vs.s, vs.s,
                      S - k0, tid);

  const int nq = (S + QB - 1) / QB;
  const int i0 = causal ? k0 / QB : 0;
  const int per_head = nq - i0;
  const int steps = n_rep * per_head;

  auto prefetch = [&](int step, int buf) {
    const int h = kvh * n_rep + step / per_head;
    const int q0 = (i0 + step % per_head) * QB;
    load_tile<T, QB, D>(q_s + buf * QB * LD,
                        q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, S - q0,
                        tid);
    load_tile<T, QB, D>(do_s + buf * QB * LD,
                        dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
                        S - q0, tid);
    if (tid < QB) {
      const int64_t row = (static_cast<int64_t>(b) * H + h) * S + q0 + tid;
      const bool ok = q0 + tid < S;
      lse_s[buf * QB + tid] = ok ? lse[row] : 0.f;
      dl_s[buf * QB + tid] = ok ? delta[row] : 0.f;
    }
  };
  prefetch(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }
  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      prefetch(st + 1, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = st & 1;
    const int h = kvh * n_rep + st / per_head;   // this step's q head
    const int q0 = (i0 + st % per_head) * QB;
    const T* qb = q_s + buf * QB * LD;
    const T* dob = do_s + buf * QB * LD;
    const float* lb = lse_s + buf * QB;
    const float* db = dl_s + buf * QB;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x QB rows
    float st_[QB / 8][4], dpt[QB / 8][4];
#pragma unroll
    for (int i = 0; i < QB / 8; ++i) {
      st_[i][0] = st_[i][1] = st_[i][2] = st_[i][3] = 0.f;
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, k_s, LD, warp * 16, kk * 16, lane);
      load_a(va, v_s, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < QB / 16; ++nn) {
        uint32_t bq[4], bd[4];
        load_b_nt(bq, qb, LD, nn * 16, kk * 16, lane);
        load_b_nt(bd, dob, LD, nn * 16, kk * 16, lane);
        Mma<T>::run(st_[2 * nn], ka, bq);
        Mma<T>::run(st_[2 * nn + 1], ka, bq + 2);
        Mma<T>::run(dpt[2 * nn], va, bd);
        Mma<T>::run(dpt[2 * nn + 1], va, bd + 2);
      }
    }
    // p^T and dS^T = p^T (dp^T - delta) * scale
#pragma unroll
    for (int nt = 0; nt < QB / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t4 + (e & 1);
        const int qi = q0 + ql;
        const int key = e < 2 ? key_a : key_b;
        const bool live = qi < S && key < S && (!causal || key <= qi);
        float x = st_[nt][e] * scale;
        if (masked && live) x = feature_score(f, x, b, h, S, qi, key);
        float p = live ? expf(x - lb[ql]) : 0.f;
        if (masked) p = guard(p, x);
        float dp = dpt[nt][e];
        if (drop) {
          // dV takes the dropped p; dS the undropped p and dropped dp
          const bool keep = kept(f, b * H + h, qi, key);
          st_[nt][e] = survivor(f, keep, p);
          dp = survivor(f, keep, dp);
        } else {
          st_[nt][e] = p;
        }
        dpt[nt][e] = p * (dp - db[ql]) * scale;
      }
    }
    // dV += p^T dO and dK += dS^T q, the q rows as the reduction
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(st_[2 * kk][0], st_[2 * kk][1]),
          Mma<T>::pack(st_[2 * kk][2], st_[2 * kk][3]),
          Mma<T>::pack(st_[2 * kk + 1][0], st_[2 * kk + 1][1]),
          Mma<T>::pack(st_[2 * kk + 1][2], st_[2 * kk + 1][3])};
      const uint32_t sa[4] = {
          Mma<T>::pack(dpt[2 * kk][0], dpt[2 * kk][1]),
          Mma<T>::pack(dpt[2 * kk][2], dpt[2 * kk][3]),
          Mma<T>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          Mma<T>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, dob, LD, kk * 16, nn * 16, lane);
        load_b_kn(bq, qb, LD, kk * 16, nn * 16, lane);
        Mma<T>::run(dv_acc[2 * nn], pa, bo);
        Mma<T>::run(dv_acc[2 * nn + 1], pa, bo + 2);
        Mma<T>::run(dk_acc[2 * nn], sa, bq);
        Mma<T>::run(dk_acc[2 * nn + 1], sa, bq + 2);
      }
    }
    __syncthreads();   // the next step's copy overwrites this buffer
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (key_a < S) {
      *reinterpret_cast<uint32_t*>(dkb + key_a * dks.s + col) =
          Mma<T>::pack(dk_acc[nt][0], dk_acc[nt][1]);
      *reinterpret_cast<uint32_t*>(dvb + key_a * dvs.s + col) =
          Mma<T>::pack(dv_acc[nt][0], dv_acc[nt][1]);
    }
    if (key_b < S) {
      *reinterpret_cast<uint32_t*>(dkb + key_b * dks.s + col) =
          Mma<T>::pack(dk_acc[nt][2], dk_acc[nt][3]);
      *reinterpret_cast<uint32_t*>(dvb + key_b * dvs.s + col) =
          Mma<T>::pack(dv_acc[nt][2], dv_acc[nt][3]);
    }
  }
}

// ------------------------------------------------------------------- dQ
constexpr int QB2 = 64;   // q rows per block (16 per warp)
constexpr int KB2 = 64;   // keys per K/V tile

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int S,
                 int H, int n_rep, Strides qs, Strides ks, Strides vs,
                 Strides dos, Strides dqs, float scale, bool causal,
                 Features f) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [QB2][LD]
  T* do_s = q_s + QB2 * LD;                  // [QB2][LD]
  T* k_s = do_s + QB2 * LD;                  // [2][KB2][LD]
  T* v_s = k_s + 2 * KB2 * LD;               // [2][KB2][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = qt * QB2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;
  const T* kg = k + b * ks.b + kvh * ks.h;
  const T* vg = v + b * vs.b + kvh * vs.h;

  load_tile<T, QB2, D>(q_s, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s,
                       S - q0, tid);
  load_tile<T, QB2, D>(do_s, dout + b * dos.b + h * dos.h + q0 * dos.s,
                       dos.s, S - q0, tid);
  load_tile<T, KB2, D>(k_s, kg, ks.s, S, tid);
  load_tile<T, KB2, D>(v_s, vg, vs.s, S, tid);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lb = lse + static_cast<int64_t>(bh) * S;
  const float* db = delta + static_cast<int64_t>(bh) * S;
  const float lse_a = row_a < S ? lb[row_a] : 0.f;
  const float lse_b = row_b < S ? lb[row_b] : 0.f;
  const float dl_a = row_a < S ? db[row_a] : 0.f;
  const float dl_b = row_b < S ? db[row_b] : 0.f;

  int n_tiles = (S + KB2 - 1) / KB2;
  if (causal) n_tiles = min(n_tiles, (q0 + QB2 - 1) / KB2 + 1);
  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KB2;
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile<T, KB2, D>(k_s + nb * KB2 * LD, kg + (k0 + KB2) * ks.s, ks.s,
                           S - k0 - KB2, tid);
      load_tile<T, KB2, D>(v_s + nb * KB2 * LD, vg + (k0 + KB2) * vs.s, vs.s,
                           S - k0 - KB2, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = k_s + (j & 1) * KB2 * LD;
    const T* vb = v_s + (j & 1) * KB2 * LD;

    float s[KB2 / 8][4], dp[KB2 / 8][4];
#pragma unroll
    for (int i = 0; i < KB2 / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, q_s, LD, warp * 16, kk * 16, lane);
      load_a(da, do_s, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < KB2 / 16; ++nn) {
        uint32_t bk[4], bv[4];
        load_b_nt(bk, kb, LD, nn * 16, kk * 16, lane);
        load_b_nt(bv, vb, LD, nn * 16, kk * 16, lane);
        Mma<T>::run(s[2 * nn], qa, bk);
        Mma<T>::run(s[2 * nn + 1], qa, bk + 2);
        Mma<T>::run(dp[2 * nn], da, bv);
        Mma<T>::run(dp[2 * nn + 1], da, bv + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < KB2 / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool live = col < S && row < S && (!causal || col <= row);
        float x = s[nt][e] * scale;
        if (masked && live) x = feature_score(f, x, b, h, S, row, col);
        float p = live ? expf(x - (e < 2 ? lse_a : lse_b)) : 0.f;
        if (masked) p = guard(p, x);
        float dpv = dp[nt][e];
        if (drop) dpv = dropped(f, bh, row, col, dpv);
        dp[nt][e] = p * (dpv - (e < 2 ? dl_a : dl_b)) * scale;
      }
    }
    // dQ += dS k, the keys as the reduction
#pragma unroll
    for (int kk = 0; kk < KB2 / 16; ++kk) {
      const uint32_t sa[4] = {
          Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]),
          Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]),
          Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t bk[4];
        load_b_kn(bk, kb, LD, kk * 16, nn * 16, lane);
        Mma<T>::run(dq_acc[2 * nn], sa, bk);
        Mma<T>::run(dq_acc[2 * nn + 1], sa, bk + 2);
      }
    }
    __syncthreads();
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dqb + row_a * dqs.s + col) =
          Mma<T>::pack(dq_acc[nt][0], dq_acc[nt][1]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(dqb + row_b * dqs.s + col) =
          Mma<T>::pack(dq_acc[nt][2], dq_acc[nt][3]);
  }
}

// ------------------------------------------------------- fp32 (FMA) path
// 32 x 32 tiles; thread (r = tid / 4, c = tid % 4) owns row r of the
// block's rows (keys for dK/dV, q rows for dQ), the scores of columns
// c, c + 4, ... and the gradient columns c, c + 4, ...
constexpr int F = 32;

__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < d; ++i) acc += a[i] * b[i];
  return acc;
}

// rows [r0, r0 + F) of a [S, D] view into shared rows of stride ld
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t stride, int r0, int S,
                                              int D, int ld, int tid) {
  for (int i = tid; i < F * D; i += kThreads) {
    const int r = i / D, dd = i - r * D;
    dst[r * ld + dd] = r0 + r < S ? src[(r0 + r) * stride + dd] : 0.f;
  }
}

template <int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int S, int H, int n_rep,
                  Strides qs, Strides ks, Strides vs, Strides dos,
                  Strides dks, Strides dvs, float scale, bool causal,
                  Features f) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);   // [F][LD]
  float* v_s = k_s + F * LD;
  float* q_s = v_s + F * LD;
  float* do_s = q_s + F * LD;
  float* p_s = do_s + F * LD;                         // [F][F + 1]
  float* ds_s = p_s + F * (F + 1);                    // [F][F + 1]
  float* lse_s = ds_s + F * (F + 1);                  // [F]
  float* dl_s = lse_s + F;                            // [F]

  const int h_kv = H / n_rep;
  const int b = blockIdx.y / h_kv, kvh = blockIdx.y - b * h_kv;
  const int k0 = blockIdx.x * F;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int key = k0 + r;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;
  load_rows_f32(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0, S, D, LD, tid);
  load_rows_f32(v_s, v + b * vs.b + kvh * vs.h, vs.s, k0, S, D, LD, tid);

  float dk_acc[D / 4], dv_acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int nq = (S + F - 1) / F;
  const int i0 = causal ? k0 / F : 0;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = kvh * n_rep + rep;
    const int64_t lrow = (static_cast<int64_t>(b) * H + h) * S;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * F;
      __syncthreads();
      load_rows_f32(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S, D, LD, tid);
      load_rows_f32(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, S, D, LD,
                    tid);
      if (tid < F) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[lrow + q0 + tid] : 0.f;
        dl_s[tid] = ok ? delta[lrow + q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < F / 4; ++ii) {
        const int ql = c + 4 * ii, qi = q0 + ql;
        const float s = dot_row(k_s + r * LD, q_s + ql * LD, D);
        const float dp = dot_row(v_s + r * LD, do_s + ql * LD, D);
        const bool live = qi < S && key < S && (!causal || key <= qi);
        float x = s * scale;
        if (masked && live) x = feature_score(f, x, b, h, S, qi, key);
        float p = live ? expf(x - lse_s[ql]) : 0.f;
        if (masked) p = guard(p, x);
        float pv = p, dpv = dp;
        if (drop) {
          const bool keep = kept(f, b * H + h, qi, key);
          pv = survivor(f, keep, p);
          dpv = survivor(f, keep, dp);
        }
        p_s[r * (F + 1) + ql] = pv;
        ds_s[r * (F + 1) + ql] = p * (dpv - dl_s[ql]) * scale;
      }
      __syncwarp();
#pragma unroll
      for (int ii = 0; ii < D / 4; ++ii) {
        const int dd = c + 4 * ii;
        float av = 0.f, ak = 0.f;
#pragma unroll 8
        for (int ql = 0; ql < F; ++ql) {
          av += p_s[r * (F + 1) + ql] * do_s[ql * LD + dd];
          ak += ds_s[r * (F + 1) + ql] * q_s[ql * LD + dd];
        }
        dv_acc[ii] += av;
        dk_acc[ii] += ak;
      }
    }
  }
  if (key < S) {
    float* dkr = dk + b * dks.b + kvh * dks.h + key * dks.s;
    float* dvr = dv + b * dvs.b + kvh * dvs.h + key * dvs.s;
#pragma unroll
    for (int ii = 0; ii < D / 4; ++ii) {
      dkr[c + 4 * ii] = dk_acc[ii];
      dvr[c + 4 * ii] = dv_acc[ii];
    }
  }
}

template <int D, bool FEAT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int S, int H, int n_rep, Strides qs, Strides ks, Strides vs,
                 Strides dos, Strides dqs, float scale, bool causal,
                 Features f) {
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [F][LD]
  float* do_s = q_s + F * LD;
  float* k_s = do_s + F * LD;
  float* v_s = k_s + F * LD;
  float* ds_s = v_s + F * LD;                         // [F][F + 1]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = qt * F;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int row = q0 + r;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;
  load_rows_f32(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S, D, LD, tid);
  load_rows_f32(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, S, D, LD,
                tid);
  const int64_t lrow = static_cast<int64_t>(bh) * S + row;
  const float lse_r = row < S ? lse[lrow] : 0.f;
  const float dl_r = row < S ? delta[lrow] : 0.f;
  const float* kg = k + b * ks.b + kvh * ks.h;
  const float* vg = v + b * vs.b + kvh * vs.h;

  float dq_acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq_acc[i] = 0.f;
  int n_tiles = (S + F - 1) / F;
  if (causal) n_tiles = min(n_tiles, (q0 + F - 1) / F + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F;
    __syncthreads();
    load_rows_f32(k_s, kg, ks.s, k0, S, D, LD, tid);
    load_rows_f32(v_s, vg, vs.s, k0, S, D, LD, tid);
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < F / 4; ++ii) {
      const int kl = c + 4 * ii, col = k0 + kl;
      const float s = dot_row(q_s + r * LD, k_s + kl * LD, D);
      const float dp = dot_row(do_s + r * LD, v_s + kl * LD, D);
      const bool live = col < S && row < S && (!causal || col <= row);
      float x = s * scale;
      if (masked && live) x = feature_score(f, x, b, h, S, row, col);
      float p = live ? expf(x - lse_r) : 0.f;
      if (masked) p = guard(p, x);
      const float dpv = drop ? dropped(f, bh, row, col, dp) : dp;
      ds_s[r * (F + 1) + kl] = p * (dpv - dl_r) * scale;
    }
    __syncwarp();
#pragma unroll
    for (int ii = 0; ii < D / 4; ++ii) {
      const int dd = c + 4 * ii;
      float a = 0.f;
#pragma unroll 8
      for (int kl = 0; kl < F; ++kl) a += ds_s[r * (F + 1) + kl] * k_s[kl * LD + dd];
      dq_acc[ii] += a;
    }
  }
  if (row < S) {
    float* dqr = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int ii = 0; ii < D / 4; ++ii) dqr[c + 4 * ii] = dq_acc[ii];
  }
}

// --------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int b, h, h_kv, s;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale;
  bool causal;
  Features f;
  cudaStream_t stream;
};

template <typename T, int D, bool FEAT>
int launch_dkv_mma(const Args& a) {
  constexpr int LD = D + 8;
  const size_t smem = sizeof(T) * static_cast<size_t>(2 * KB + 4 * QB) * LD +
                      sizeof(float) * 4 * QB;
  auto kernel = flash_bwd_dkv_mma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + KB - 1) / KB, a.b * a.h_kv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.h,
      a.h / a.h_kv, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale,
      a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool FEAT>
int launch_dq_mma(const Args& a) {
  constexpr int LD = D + 8;
  const size_t smem =
      sizeof(T) * static_cast<size_t>(2 * QB2 + 4 * KB2) * LD;
  auto kernel = flash_bwd_dq_mma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + QB2 - 1) / QB2, a.b * a.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.s, a.h, a.h / a.h_kv, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool FEAT>
int launch_dkv_f32(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * static_cast<size_t>(F) * (D + 1) +
                       2 * F * (F + 1) + 2 * F);
  auto kernel = flash_bwd_dkv_f32<D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + F - 1) / F, a.b * a.h_kv);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s, a.h, a.h / a.h_kv, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.scale,
      a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool FEAT>
int launch_dq_f32(const Args& a) {
  const size_t smem =
      sizeof(float) * (4 * static_cast<size_t>(F) * (D + 1) + F * (F + 1));
  auto kernel = flash_bwd_dq_f32<D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, smem);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.s + F - 1) / F, a.b * a.h);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.s, a.h, a.h / a.h_kv,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool FEAT>
int dispatch(bool dkv, int dtype, const Args& a) {
  switch (dtype) {
    case ptt::kF32:
      return dkv ? launch_dkv_f32<D, FEAT>(a) : launch_dq_f32<D, FEAT>(a);
    case ptt::kBF16:
      return dkv ? launch_dkv_mma<__nv_bfloat16, D, FEAT>(a)
                 : launch_dq_mma<__nv_bfloat16, D, FEAT>(a);
    case ptt::kF16:
      return dkv ? launch_dkv_mma<__half, D, FEAT>(a)
                 : launch_dq_mma<__half, D, FEAT>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FEAT>
int run_d(bool dkv, int d, int dtype, const Args& a) {
  switch (d) {
    case 32: return dispatch<32, FEAT>(dkv, dtype, a);
    case 64: return dispatch<64, FEAT>(dkv, dtype, a);
    case 128: return dispatch<128, FEAT>(dkv, dtype, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(bool dkv, int d, int dtype, const Args& a) {
  if (a.b <= 0 || a.h <= 0 || a.h_kv <= 0 || a.h % a.h_kv != 0 ||
      a.s <= 0 || !(a.f.dropout >= 0.f && a.f.dropout < 1.f))
    return static_cast<int>(cudaErrorInvalidValue);
  return a.f.any() ? run_d<true>(dkv, d, dtype, a)
                   : run_d<false>(dkv, d, dtype, a);
}

Strides at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// All tensors are [B, heads, S, D] views, D contiguous, with their element
// strides (b, h, s) in `strides`, three per tensor in argument order:
// q, k, v, dout, then dk, dv (dK/dV) or dq (dQ).  lse and delta: fp32
// [B, H, S].  dk, dv: [B, H_kv, S, D].  D in {32, 64, 128}; one dtype.
// The features as ptt_flash_fwd takes them (the forward's seed).
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int b, int h, int h_kv, int s, int d,
                                 const long long* strides, float scale,
                                 int causal, int dtype, const void* mask,
                                 const long long* mask_strides,
                                 const void* seg, float dropout,
                                 float keep_div, unsigned int seed,
                                 void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk; a.dv = dv;
  a.b = b; a.h = h; a.h_kv = h_kv; a.s = s;
  a.qs = at(strides, 0); a.ks = at(strides, 1); a.vs = at(strides, 2);
  a.dos = at(strides, 3); a.dks = at(strides, 4); a.dvs = at(strides, 5);
  a.scale = scale; a.causal = causal != 0;
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed);
  a.stream = static_cast<cudaStream_t>(stream);
  return run(true, d, dtype, a);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int b, int h,
                                int h_kv, int s, int d,
                                const long long* strides, float scale,
                                int causal, int dtype, const void* mask,
                                const long long* mask_strides,
                                const void* seg, float dropout,
                                float keep_div, unsigned int seed,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.b = b; a.h = h; a.h_kv = h_kv; a.s = s;
  a.qs = at(strides, 0); a.ks = at(strides, 1); a.vs = at(strides, 2);
  a.dos = at(strides, 3); a.dqs = at(strides, 4);
  a.scale = scale; a.causal = causal != 0;
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed);
  a.stream = static_cast<cudaStream_t>(stream);
  return run(false, d, dtype, a);
}
