// Flash attention backward: a delta pass and two kernels, dK/dV and dQ.
// Both kernels recompute p from the forward's fp32 log-sum-exp, so
// nothing O(S^2) is stored; delta = rowsum(dO * O) comes from its own
// one-pass kernel (the JAX package computes it outside Pallas, one jnp
// einsum).
//
// Replaces: paddle_tpu/pallas/flash_attention.py _pallas_flash_bwd, its
// _bwd_dkv_kernel (pallas_call at :578) and _bwd_dq_kernel (:608), with
// their features: the additive mask, segment ids and attention dropout
// (`Features`, flash_common.cuh), the same keep-mask as the forward's;
// and the delta einsum (:540).
//
// Bound on the H100: operations.  dK/dV does four products of 2 S^2 D
// flops per head (s, dp, dv, dk) and dQ three (s, dp, dq): with the
// forward's two that is the usual 2.5x the forward, halved by a causal
// mask; bytes are O(S D), far below.  At the Llama training shape (B 1,
// H 32, S 4096, D 128, causal, bf16) the least time of both is 0.347 ms;
// at GPT-2's (B 8, H 12, S 1024, D 64, causal) dK/dV 0.0261 ms and dQ
// 0.0195 ms.  A [B, 1, S, S] fp32 mask adds 4 bytes a live score (16.8 MB
// there), which makes bytes bind: dK/dV 0.0278 ms, dQ 0.0240 ms.  Two
// deterministic kernels repeat s and dp (seven products against five), so
// the pair reaches at most 71% of the whole backward's bound.  The delta
// pass is bound by bytes (O and dO read once).
//
// Design, 16-bit D 64 and 128 (both training paths): warp-specialised
// Hopper kernels (hopper.cuh).  A block has three warpgroups: a producer,
// whose one issuing warp keeps a ring of stages full by TMA (4-D tensor
// maps over the [B, heads, S, D] views with their strides; the ragged S
// edge is TMA's zero fill) and gives its registers to the consumers
// (setmaxnreg 24 / 240), and two consumer warpgroups of 64 rows each that
// run every product as wgmma (m64nNk16, fp32 accumulation): the score
// products with both operands in shared memory, the gradient products
// with the probabilities or dS as A straight from the score accumulators'
// registers and the streamed tile as the transposed (MN-major) B.  full
// and empty mbarriers hand each stage over.  p = 2^(s scale log2e - lse
// log2e), lse pre-scaled once; the causal and ragged masks run only on
// tiles that cross the diagonal or the S edge.  dQ: one block per 128 q
// rows of one (batch, head), Q and dO resident, 64-key K/V tiles
// streamed, the late (longest) q tiles first.  dK/dV: one block per 128
// keys of one (batch, kv head), K and V resident, (q tile, dO tile, lse,
// delta) streamed over the n_rep q heads and their q tiles from the
// diagonal on, the early (longest) key tiles first; the GQA heads are
// summed inside the block, so there are no atomics and two calls give the
// same bits.  Each output is rounded once and stored through shared
// memory in 16-byte rows.  Features (FEAT = true, its own instantiation):
// the producer stages the fp32 mask tile by TMA with the stage, segment
// ids and the fully-masked guard on every live score, and the dropout
// hash is computed while the dP product is in flight; dK/dV feeds the
// dropped p / (1 - p) to dV and the dropped dp / (1 - p) to dS = p (dp -
// delta) scale with the undropped p; dQ drops dp alike.  The plain
// instantiation runs none of it.
//
// D 32 (16-bit) keeps mma.sync m16n8k16 bodies with 64-key / 32-row
// (dK/dV) and 64-row / 64-key (dQ) tiles double-buffered by cp.async, and
// fp32 inputs keep plain FMA kernels with 32 x 32 tiles; no training path
// takes either.  Any S >= 1: ragged rows and keys are zero-filled and
// masked.
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace ptt::flash;

// ------------------------------------------- mma.sync bodies (16-bit D 32)
// dK/dV
constexpr int KB = 64;   // keys per block (16 per warp)
constexpr int QB = 32;   // q rows per step

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);

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
          const bool keep = kept(f, global_head(f, b, h), qi, key);
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

// dQ
constexpr int QB2 = 64;   // q rows per block (16 per warp)
constexpr int KB2 = 64;   // keys per K/V tile

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);
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
        if (drop) dpv = dropped(f, global_head(f, b, h), row, col, dpv);
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

// ------------------------------------------------- wgmma bodies (D 64, 128)
// The shared pieces (warpgroup roles, TMA maps, the swizzled output
// store, the dropout keep bits) are in flash_hopper.cuh.

// ------------------------------------------------------------------- dQ
// One block owns 128 q rows of one (batch, head): consumer warpgroup w
// the rows 64 w..; Q, dO, lse and delta stay resident while the producer
// streams 64-key K/V tiles (and the fp32 mask tile) through a ring of
// stages.  Per tile: S = Q K^T and dP = dO V^T (both operands in shared
// memory), p = 2^(s scale log2e - lse log2e), dS in registers, dQ += dS K
// (A from registers, K as the transposed B).
constexpr int kDqRows = 128;
constexpr int kDqKeys = 64;

template <int D, bool FEAT>
struct DqSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = FEAT ? 2 : 3;
  static constexpr uint32_t kQPanel = kDqRows * kPanelBytes;
  static constexpr uint32_t kKPanel = kDqKeys * kPanelBytes;
  static constexpr uint32_t kKStage = kPanels * kKPanel;
  static constexpr uint32_t kMaskStage = FEAT ? kDqRows * kDqKeys * 4 : 0;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQ + kPanels * kQPanel;
  static constexpr uint32_t kK = kDo + kPanels * kQPanel;
  static constexpr uint32_t kV = kK + kStages * kKStage;
  static constexpr uint32_t kMask = kV + kStages * kKStage;
  static constexpr uint32_t kBar = kMask + kStages * kMaskStage;
  static constexpr size_t kAlloc = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_mask,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   Strides dqs, int S, int H, int n_rep, float scale,
                   bool causal, Features f) {
  using L = DqSmem<D, FEAT>;
  constexpr int KT = kDqKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bar_qdo = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = bar_qdo + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;   // late rows first
  int n_tiles = (S + KT - 1) / KT;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kDqRows, S) - 1) / KT + 1);
  const bool has_mask = FEAT && f.mask != nullptr;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_qdo, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 2 * kWg);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {                 // ------------------ producer
    hw::regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hw::mbar_arrive_expect_tx(bar_qdo, 2 * L::kPanels * L::kQPanel);
      for (int p = 0; p < L::kPanels; ++p) {
        hw::tma_load_4d(sm + L::kQ + p * L::kQPanel, &tm_q, bar_qdo, 64 * p,
                        q0, h, b);
        hw::tma_load_4d(sm + L::kDo + p * L::kQPanel, &tm_do, bar_qdo,
                        64 * p, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % L::kStages;
        hw::mbar_wait(&empty[st], ((j / L::kStages) & 1) ^ 1);
        hw::mbar_arrive_expect_tx(
            &full[st], 2 * L::kKStage + (has_mask ? L::kMaskStage : 0));
        for (int p = 0; p < L::kPanels; ++p) {
          hw::tma_load_4d(sm + L::kK + st * L::kKStage + p * L::kKPanel,
                          &tm_k, &full[st], 64 * p, j * KT, kvh, b);
          hw::tma_load_4d(sm + L::kV + st * L::kKStage + p * L::kKPanel,
                          &tm_v, &full[st], 64 * p, j * KT, kvh, b);
        }
        if (has_mask)
          hw::tma_load_4d(sm + L::kMask + st * L::kMaskStage, &tm_mask,
                          &full[st], j * KT, q0, f.mask_h ? h : 0,
                          f.mask_b ? b : 0);
      }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  hw::regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWg - 1;
  const int t = threadIdx.x % kWg, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * cw;
  const int ra = row0 + 16 * warp + g, rb = ra + 8;
  const float scale_l2 = scale * kLog2e;
  const float* lb = lse + static_cast<int64_t>(bh) * S;
  const float* db = delta + static_cast<int64_t>(bh) * S;
  const float lse_a = ra < S ? lb[ra] * kLog2e : 0.f;
  const float lse_b = rb < S ? lb[rb] * kLog2e : 0.f;
  const float dl_a = ra < S ? db[ra] : 0.f;
  const float dl_b = rb < S ? db[rb] : 0.f;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;
  if (drop) load_seed(f);
  const int* seg = FEAT && f.seg != nullptr
                       ? f.seg + static_cast<int64_t>(b) * S : nullptr;
  const int seg_a = seg != nullptr && ra < S ? seg[ra] : 0;
  const int seg_b = seg != nullptr && rb < S ? seg[rb] : 0;
  const uint32_t qh_a = hash_q(ra), qh_b = hash_q(rb);
  // the tiles this group needs: keys up to its last live row
  const int wg_tiles =
      row0 >= S ? 0
                : causal ? min(n_tiles, (min(row0 + 63, S - 1)) / KT + 1)
                         : n_tiles;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint64_t q_desc = hw::desc_k_major(sm + L::kQ + 64 * cw * kPanelBytes);
  const uint64_t do_desc =
      hw::desc_k_major(sm + L::kDo + 64 * cw * kPanelBytes);
  hw::mbar_wait(bar_qdo, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % L::kStages;
    hw::mbar_wait(&full[st], (j / L::kStages) & 1);
    if (j < wg_tiles) {
      const int k0 = j * KT;
      unsigned char* k_s = sm + L::kK + st * L::kKStage;
      const uint64_t k_desc = hw::desc_k_major(k_s);
      const uint64_t v_desc = hw::desc_k_major(sm + L::kV + st * L::kKStage);
      float s[KT / 2], dp[KT / 2];
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
        const uint32_t bo = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
        hw::Wgmma<T, KT>::ss(s, q_desc + a, k_desc + bo, kk > 0);
      }
      hw::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
        const uint32_t bo = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
        hw::Wgmma<T, KT>::ss(dp, do_desc + a, v_desc + bo, kk > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                 // S is in; dP still running
      hw::fence_regs(s);
      // element i: row (i & 2 ? rb : ra), key k0 + 8 (i >> 2) + 2 t4 + (i & 1)
      if (!masked) {                       // dropout alone takes it too
        const bool edge = (causal && k0 + KT - 1 > row0) || k0 + KT > S ||
                          row0 + 64 > S;
        if (edge) {
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) {
            const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            const int row = i & 2 ? rb : ra;
            const bool live = col < S && row < S && (!causal || col <= row);
            const float p =
                hw::ex2(fmaf(s[i], scale_l2, -(i & 2 ? lse_b : lse_a)));
            s[i] = live ? p : 0.f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < KT / 2; ++i)
            s[i] = hw::ex2(fmaf(s[i], scale_l2, -(i & 2 ? lse_b : lse_a)));
        }
      } else {
        const float* mask_s = reinterpret_cast<const float*>(
            sm + L::kMask + st * L::kMaskStage);
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int kc = 8 * (i >> 2) + 2 * t4 + (i & 1), col = k0 + kc;
          const int rl = 64 * cw + 16 * warp + g + (i & 2 ? 8 : 0);
          const int row = q0 + rl;
          const bool live = col < S && row < S && (!causal || col <= row);
          float x = s[i] * scale;
          if (masked && live) {
            if (seg != nullptr && seg[col] != (i & 2 ? seg_b : seg_a))
              x = kNegInf;
            if (has_mask) x += mask_s[rl * KT + kc];
          }
          float p = live ? hw::ex2(fmaf(x, kLog2e, -(i & 2 ? lse_b : lse_a)))
                         : 0.f;
          if (masked) p = guard(p, x);
          s[i] = p;
        }
      }
      uint32_t keep = 0;                   // the hash runs beside dP
      if (drop)
        keep = keep_bits<KT / 2>(
            f, hash_head(f, global_head(f, b, h)),
            [&](int i, uint32_t& qh, uint32_t& kh) {
              qh = i & 2 ? qh_b : qh_a;
              kh = hash_k(k0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
            });
      hw::wgmma_wait<0>();
      hw::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        float dpv = dp[i];
        if (drop) dpv = survivor(f, (keep >> i) & 1u, dpv);
        dp[i] = s[i] * (dpv - (i & 2 ? dl_b : dl_a)) * scale;
      }
      uint32_t ds[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        ds[kk][0] = Mma<T>::pack(dp[8 * kk], dp[8 * kk + 1]);
        ds[kk][1] = Mma<T>::pack(dp[8 * kk + 2], dp[8 * kk + 3]);
        ds[kk][2] = Mma<T>::pack(dp[8 * kk + 4], dp[8 * kk + 5]);
        ds[kk][3] = Mma<T>::pack(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
      const uint64_t kt_desc = hw::desc_mn_major(k_s, L::kKPanel);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hw::Wgmma<T, D, 1>::rs(acc, ds[kk],
                               kt_desc + ((kk * 16 * kPanelBytes) >> 4), 1);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }
    hw::mbar_arrive(&empty[st]);
  }
  // dQ rounded once, through this group's (now unused) Q rows
  store_rows<T, D>(acc, sm + L::kQ + 64 * cw * kPanelBytes, L::kQPanel,
                   dq + b * dqs.b + h * dqs.h, dqs.s, row0, S, 1 + cw);
}

// ---------------------------------------------------------------- dK/dV
// One block owns 128 keys of one (batch, kv head): consumer warpgroup w
// the keys 64 w..; K and V stay resident while the producer streams a
// ring of (q tile, dO tile, lse log2e, delta, the fp32 mask tile) over the
// n_rep q heads of the group and their q tiles from the diagonal on.  Per
// stage, keys as the rows: S^T = K Q^T and dP^T = V dO^T, then dV +=
// P~^T dO and dK += dS^T Q (A from registers, dO and Q as the transposed
// B).  The GQA heads are summed inside the block: no atomics.
constexpr int kDkvKeys = 128;

template <int D, bool FEAT>
struct DkvSmem {
  // q rows a stage; at D 128 with features 64 rows spill (the features'
  // registers beside 2 x 64 accumulators and two 64 x 64 score tiles)
  static constexpr int QT = D == 128 && FEAT ? 32 : 64;
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = FEAT ? 2 : 3;
  static constexpr uint32_t kKPanel = kDkvKeys * kPanelBytes;
  static constexpr uint32_t kQPanel = QT * kPanelBytes;
  static constexpr uint32_t kQStage = kPanels * kQPanel;
  static constexpr uint32_t kMaskStage = FEAT ? QT * kDkvKeys * 4 : 0;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kPanels * kKPanel;
  static constexpr uint32_t kQ = kV + kPanels * kKPanel;
  static constexpr uint32_t kDo = kQ + kStages * kQStage;
  static constexpr uint32_t kMask = kDo + kStages * kQStage;
  static constexpr uint32_t kRows = kMask + kStages * kMaskStage;
  static constexpr uint32_t kBar = kRows + kStages * 2 * QT * 4;
  static constexpr size_t kAlloc = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Strides dks, Strides dvs, int S,
                    int H, int n_rep, float scale, bool causal, Features f) {
  using L = DkvSmem<D, FEAT>;
  constexpr int QT = L::QT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + L::kStages;

  const int h_kv = H / n_rep;
  const int bkv = blockIdx.x;
  const int b = bkv / h_kv, kvh = bkv - b * h_kv;
  const int k0 = blockIdx.y * kDkvKeys;   // the longest key tiles first
  const int nq = (S + QT - 1) / QT;
  const int i0 = causal ? k0 / QT : 0;
  const int per_head = nq - i0;
  const int steps = n_rep * per_head;
  const bool has_mask = FEAT && f.mask != nullptr;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_kv, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hw::mbar_init(&full[s], 32);         // the producer warp's lanes
      hw::mbar_init(&empty[s], 2 * kWg);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWg) {                 // ------------------ producer
    hw::regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hw::mbar_arrive_expect_tx(bar_kv, 2 * L::kPanels * L::kKPanel);
        for (int p = 0; p < L::kPanels; ++p) {
          hw::tma_load_4d(sm + L::kK + p * L::kKPanel, &tm_k, bar_kv,
                          64 * p, k0, kvh, b);
          hw::tma_load_4d(sm + L::kV + p * L::kKPanel, &tm_v, bar_kv,
                          64 * p, k0, kvh, b);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int st = t % L::kStages;
        hw::mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);
        const int h = kvh * n_rep + t / per_head;
        const int q0 = (i0 + t % per_head) * QT;
        float* rows = reinterpret_cast<float*>(sm + L::kRows) + st * 2 * QT;
        const int64_t base = (static_cast<int64_t>(b) * H + h) * S;
        for (int r = lane; r < QT; r += 32) {
          const bool ok = q0 + r < S;
          rows[r] = ok ? lse[base + q0 + r] * kLog2e : 0.f;
          rows[QT + r] = ok ? delta[base + q0 + r] : 0.f;
        }
        if (lane == 0) {
          hw::mbar_arrive_expect_tx(
              &full[st], 2 * L::kQStage + (has_mask ? L::kMaskStage : 0));
          for (int p = 0; p < L::kPanels; ++p) {
            hw::tma_load_4d(sm + L::kQ + st * L::kQStage + p * L::kQPanel,
                            &tm_q, &full[st], 64 * p, q0, h, b);
            hw::tma_load_4d(sm + L::kDo + st * L::kQStage + p * L::kQPanel,
                            &tm_do, &full[st], 64 * p, q0, h, b);
          }
          if (has_mask)
            hw::tma_load_4d(sm + L::kMask + st * L::kMaskStage, &tm_mask,
                            &full[st], k0, q0, f.mask_h ? h : 0,
                            f.mask_b ? b : 0);
        } else {
          hw::mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  hw::regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWg - 1;
  const int t = threadIdx.x % kWg, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + 64 * cw;
  const int key_a = kw0 + 16 * warp + g, key_b = key_a + 8;
  const float scale_l2 = scale * kLog2e;
  const bool masked = FEAT && f.masked();
  const bool drop = FEAT && f.dropout > 0.f;
  if (drop) load_seed(f);
  const int* seg = FEAT && f.seg != nullptr
                       ? f.seg + static_cast<int64_t>(b) * S : nullptr;
  const int seg_a = seg != nullptr && key_a < S ? seg[key_a] : 0;
  const int seg_b = seg != nullptr && key_b < S ? seg[key_b] : 0;
  const uint32_t kh_a = hash_k(key_a), kh_b = hash_k(key_b);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t k_desc = hw::desc_k_major(sm + L::kK + 64 * cw * kPanelBytes);
  const uint64_t v_desc = hw::desc_k_major(sm + L::kV + 64 * cw * kPanelBytes);
  hw::mbar_wait(bar_kv, 0);

  for (int step = 0; step < steps; ++step) {
    const int st = step % L::kStages;
    hw::mbar_wait(&full[st], (step / L::kStages) & 1);
    const int h = kvh * n_rep + step / per_head;
    const int q0 = (i0 + step % per_head) * QT;
    // nothing to do when every q row of the tile precedes every key
    if (kw0 < S && !(causal && q0 + QT - 1 < kw0)) {
      unsigned char* q_s = sm + L::kQ + st * L::kQStage;
      unsigned char* do_s = sm + L::kDo + st * L::kQStage;
      const uint64_t q_desc = hw::desc_k_major(q_s);
      const uint64_t do_desc = hw::desc_k_major(do_s);
      const float* rows =
          reinterpret_cast<const float*>(sm + L::kRows) + st * 2 * QT;
      float s[QT / 2], dp[QT / 2];
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
        const uint32_t bo = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
        hw::Wgmma<T, QT>::ss(s, k_desc + a, q_desc + bo, kk > 0);
      }
      hw::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
        const uint32_t bo = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
        hw::Wgmma<T, QT>::ss(dp, v_desc + a, do_desc + bo, kk > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                 // S^T is in; dP^T still running
      hw::fence_regs(s);
      // element i: key (i & 2 ? key_b : key_a), q q0 + 8 (i >> 2) + 2 t4
      // + (i & 1)
      if (!masked) {                       // dropout alone takes it too
        const bool edge = (causal && kw0 + 63 > q0) || q0 + QT > S ||
                          kw0 + 64 > S;
        if (edge) {
#pragma unroll
          for (int i = 0; i < QT / 2; ++i) {
            const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1), qi = q0 + qc;
            const int key = i & 2 ? key_b : key_a;
            const bool live = qi < S && key < S && (!causal || key <= qi);
            const float p = hw::ex2(fmaf(s[i], scale_l2, -rows[qc]));
            s[i] = live ? p : 0.f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < QT / 2; ++i) {
            const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
            s[i] = hw::ex2(fmaf(s[i], scale_l2, -rows[qc]));
          }
        }
      } else {
        const float* mask_s = reinterpret_cast<const float*>(
            sm + L::kMask + st * L::kMaskStage);
#pragma unroll
        for (int i = 0; i < QT / 2; ++i) {
          const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1), qi = q0 + qc;
          const int kl = 64 * cw + 16 * warp + g + (i & 2 ? 8 : 0);
          const int key = k0 + kl;
          const bool live = qi < S && key < S && (!causal || key <= qi);
          float x = s[i] * scale;
          if (masked && live) {
            if (seg != nullptr && seg[qi] != (i & 2 ? seg_b : seg_a))
              x = kNegInf;
            if (has_mask) x += mask_s[qc * kDkvKeys + kl];
          }
          float p = live ? hw::ex2(fmaf(x, kLog2e, -rows[qc])) : 0.f;
          if (masked) p = guard(p, x);
          s[i] = p;
        }
      }
      uint32_t keep = 0;                   // the hash runs beside dP^T
      if (drop)
        keep = keep_bits<QT / 2>(
            f, hash_head(f, global_head(f, b, h)),
            [&](int i, uint32_t& qh, uint32_t& kh) {
              qh = hash_q(q0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
              kh = i & 2 ? kh_b : kh_a;
            });
      hw::wgmma_wait<0>();
      hw::fence_regs(dp);
      // dS^T = p (dp - delta) scale with the dropped dp; dV takes the
      // dropped p
#pragma unroll
      for (int i = 0; i < QT / 2; ++i) {
        const int qc = 8 * (i >> 2) + 2 * t4 + (i & 1);
        float dpv = dp[i];
        if (drop) {
          const bool k = (keep >> i) & 1u;
          dpv = survivor(f, k, dpv);
          dp[i] = s[i] * (dpv - rows[QT + qc]) * scale;
          s[i] = survivor(f, k, s[i]);
        } else {
          dp[i] = s[i] * (dpv - rows[QT + qc]) * scale;
        }
      }
      uint32_t pa[QT / 16][4], sa[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = Mma<T>::pack(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          sa[kk][e] =
              Mma<T>::pack(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      }
      const uint64_t dot_desc = hw::desc_mn_major(do_s, L::kQPanel);
      const uint64_t qt_desc = hw::desc_mn_major(q_s, L::kQPanel);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hw::Wgmma<T, D, 1>::rs(dv_acc, pa[kk],
                               dot_desc + ((kk * 16 * kPanelBytes) >> 4), 1);
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk)
        hw::Wgmma<T, D, 1>::rs(dk_acc, sa[kk],
                               qt_desc + ((kk * 16 * kPanelBytes) >> 4), 1);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(dv_acc);
      hw::fence_regs(dk_acc);
    }
    hw::mbar_arrive(&empty[st]);
  }
  // rounded once, through this group's (now unused) K and V rows
  store_rows<T, D>(dk_acc, sm + L::kK + 64 * cw * kPanelBytes, L::kKPanel,
                   dk + b * dks.b + kvh * dks.h, dks.s, kw0, S, 1 + cw);
  store_rows<T, D>(dv_acc, sm + L::kV + 64 * cw * kPanelBytes, L::kKPanel,
                   dv + b * dvs.b + kvh * dvs.h, dvs.s, kw0, S, 1 + cw);
}

// ---------------------------------------------------------------- delta
// delta = rowsum(dO * O) in fp32 [B, H, S] in one pass: D / (16 bytes)
// lanes a row, each one 16-byte load of O and of dO, then a butterfly sum
// over the row's lanes.  Bound: bytes (O and dO read once).
constexpr int kDeltaThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                float* __restrict__ delta, int S, int H, int64_t rows,
                Strides os, Strides dos) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = D / kVec;           // 2..32, a power of two
  constexpr int kRows = kDeltaThreads / kLanes;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = 0.f;
  if (row < rows) {
    int64_t bh;
    int s;
    if (rows <= INT32_MAX) {               // 32-bit division where it fits
      const int r = static_cast<int>(row);
      bh = r / S;
      s = r - static_cast<int>(bh) * S;
    } else {
      bh = row / S;
      s = static_cast<int>(row - bh * S);
    }
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - b * H);
    const uint4 o = *reinterpret_cast<const uint4*>(
        out + b * os.b + h * os.h + s * os.s + part * kVec);
    const uint4 d = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + h * dos.h + s * dos.s + part * kVec);
    const T* ov = reinterpret_cast<const T*>(&o);
    const T* dv = reinterpret_cast<const T*>(&d);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc = fmaf(ptt::to_f32(dv[e]), ptt::to_f32(ov[e]), acc);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && part == 0) delta[row] = acc;
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
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);
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
          const bool keep = kept(f, global_head(f, b, h), qi, key);
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
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);
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
      const float dpv = drop ? dropped(f, global_head(f, b, h), row, col, dp)
                             : dp;
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
int launch_dq_wgmma(const Args& a) {
  using L = DqSmem<D, FEAT>;
  auto kernel = flash_bwd_dq_wgmma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, L::kAlloc);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tdo, tmask;
  cudaError_t err;
  if ((err = head_map<T>(&tq, a.q, a.qs, a.b, a.h, a.s, D, kDqRows)) ||
      (err = head_map<T>(&tk, a.k, a.ks, a.b, a.h_kv, a.s, D, kDqKeys)) ||
      (err = head_map<T>(&tv, a.v, a.vs, a.b, a.h_kv, a.s, D, kDqKeys)) ||
      (err = head_map<T>(&tdo, a.dout, a.dos, a.b, a.h, a.s, D, kDqRows)) ||
      (err = mask_map(&tmask, a.f, a.b, a.h, a.s, kDqKeys, kDqRows)))
    return static_cast<int>(err);
  dim3 grid(a.b * a.h, (a.s + kDqRows - 1) / kDqRows);
  kernel<<<grid, kWgmmaThreads, L::kAlloc, a.stream>>>(
      tq, tk, tv, tdo, tmask, a.lse, a.delta, static_cast<T*>(a.dq), a.dqs,
      a.s, a.h, a.h / a.h_kv, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool FEAT>
int launch_dkv_wgmma(const Args& a) {
  using L = DkvSmem<D, FEAT>;
  auto kernel = flash_bwd_dkv_wgmma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, L::kAlloc);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tdo, tmask;
  cudaError_t err;
  if ((err = head_map<T>(&tq, a.q, a.qs, a.b, a.h, a.s, D, L::QT)) ||
      (err = head_map<T>(&tk, a.k, a.ks, a.b, a.h_kv, a.s, D, kDkvKeys)) ||
      (err = head_map<T>(&tv, a.v, a.vs, a.b, a.h_kv, a.s, D, kDkvKeys)) ||
      (err = head_map<T>(&tdo, a.dout, a.dos, a.b, a.h, a.s, D, L::QT)) ||
      (err = mask_map(&tmask, a.f, a.b, a.h, a.s, kDkvKeys, L::QT)))
    return static_cast<int>(err);
  dim3 grid(a.b * a.h_kv, (a.s + kDkvKeys - 1) / kDkvKeys);
  kernel<<<grid, kWgmmaThreads, L::kAlloc, a.stream>>>(
      tq, tk, tv, tdo, tmask, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.dks, a.dvs, a.s, a.h, a.h / a.h_kv, a.scale,
      a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

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

// 16-bit inputs: D 64 and 128 take the wgmma bodies, D 32 the mma.sync ones
template <typename T, int D, bool FEAT>
int launch_16bit(bool dkv, const Args& a) {
  if constexpr (D == 32)
    return dkv ? launch_dkv_mma<T, D, FEAT>(a) : launch_dq_mma<T, D, FEAT>(a);
  else
    return dkv ? launch_dkv_wgmma<T, D, FEAT>(a)
               : launch_dq_wgmma<T, D, FEAT>(a);
}

template <int D, bool FEAT>
int dispatch(bool dkv, int dtype, const Args& a) {
  switch (dtype) {
    case ptt::kF32:
      return dkv ? launch_dkv_f32<D, FEAT>(a) : launch_dq_f32<D, FEAT>(a);
    case ptt::kBF16:
      return launch_16bit<__nv_bfloat16, D, FEAT>(dkv, a);
    case ptt::kF16:
      return launch_16bit<__half, D, FEAT>(dkv, a);
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
      a.s <= 0 || !(a.f.dropout >= 0.f && a.f.dropout < 1.f) ||
      (a.f.dropout > 0.f && a.f.seed_ptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return a.f.any() ? run_d<true>(dkv, d, dtype, a)
                   : run_d<false>(dkv, d, dtype, a);
}

template <typename T>
int launch_delta(const void* out, const void* dout, void* delta, int b,
                 int h, int s, int d, Strides os, Strides dos,
                 cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(b) * h * s;
  auto go = [&](auto kernel, int lanes) {
    const int64_t per_block = kDeltaThreads / lanes;
    const int64_t blocks = (rows + per_block - 1) / per_block;
    kernel<<<static_cast<unsigned>(blocks), kDeltaThreads, 0, stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout),
        static_cast<float*>(delta), s, h, rows, os, dos);
    return static_cast<int>(cudaGetLastError());
  };
  constexpr int kVec = 16 / sizeof(T);
  switch (d) {
    case 32: return go(flash_bwd_delta<T, 32>, 32 / kVec);
    case 64: return go(flash_bwd_delta<T, 64>, 64 / kVec);
    case 128: return go(flash_bwd_delta<T, 128>, 128 / kVec);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Strides at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// All tensors are [B, heads, S, D] views, D contiguous, with their element
// strides (b, h, s) in `strides`, three per tensor in argument order:
// q, k, v, dout, then dk, dv (dK/dV) or dq (dQ).  lse and delta: fp32
// [B, H, S].  dk, dv: [B, H_kv, S, D].  D in {32, 64, 128}; one dtype;
// for 16-bit D 64 and 128 (the TMA maps) 16-byte aligned bases and
// strides.  The features as ptt_flash_fwd takes them (the forward's
// seed); for 16-bit D 64 and 128 the mask's non-broadcast strides are
// positive multiples of 4 elements and its base 16-byte aligned.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int b, int h, int h_kv, int s, int d,
                                 const long long* strides, float scale,
                                 int causal, int dtype, const void* mask,
                                 const long long* mask_strides,
                                 const void* seg, float dropout,
                                 float keep_div, const void* seed,
                                 int hash_b0, int hash_h0, int hash_heads,
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
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed,
                      hash_b0, hash_h0, hash_heads);
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
                                float keep_div, const void* seed,
                                int hash_b0, int hash_h0, int hash_heads,
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
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed,
                      hash_b0, hash_h0, hash_heads);
  a.stream = static_cast<cudaStream_t>(stream);
  return run(false, d, dtype, a);
}

// delta = rowsum(dout * out) as fp32 [B, H, S]: out and dout [B, H, S, D]
// views (strides as above, out then dout), 16-byte aligned rows.
extern "C" int ptt_flash_bwd_delta(const void* out, const void* dout,
                                   void* delta, int b, int h, int s, int d,
                                   const long long* strides, int dtype,
                                   void* stream) {
  if (b <= 0 || h <= 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides os = at(strides, 0), dos = at(strides, 1);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_delta<float>(out, dout, delta, b, h, s, d, os, dos, st);
    case ptt::kBF16:
      return launch_delta<__nv_bfloat16>(out, dout, delta, b, h, s, d, os,
                                         dos, st);
    case ptt::kF16:
      return launch_delta<__half>(out, dout, delta, b, h, s, d, os, dos, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
