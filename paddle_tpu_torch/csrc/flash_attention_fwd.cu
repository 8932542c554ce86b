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
// Design, 16-bit D 64 and 128 (both training paths): a warp-specialised
// Hopper kernel (hopper.cuh, flash_hopper.cuh), built like the backward's
// dQ kernel.  One block owns 128 q rows of one (batch, head), the late
// (longest) causal tiles first, and has three warpgroups: a producer,
// whose one issuing warp loads the Q tile once and keeps a ring of K/V
// stages full by TMA (4-D tensor maps over the [B, heads, S, D] views with
// their strides; the ragged S edge is TMA's zero fill) and gives its
// registers to the consumers (setmaxnreg), and two consumer warpgroups of
// 64 q rows each.  Per stage: S = Q K^T by wgmma with both operands in
// shared memory; the online softmax in registers on scores in log2 units
// (scale log2e folded into the exponent's FMA on interior tiles), with
// exp2 (m, l and the accumulator's rescale in fp32); then O += P V by
// wgmma with P straight from the score accumulators' registers as the A
// operand and V as the transposed (MN-major) B.  A consumer runs one tile
// ahead: it issues S of tile j with the P V of tile j - 1, so the softmax
// of tile j overlaps that product, and the two consumers take turns to
// issue (named barriers), so one's products run while the other computes
// its softmax.  full and empty mbarriers hand each stage over.  The causal
// and ragged-edge masks run only on tiles that cross the diagonal or the
// S edge; a causal block never fetches a tile past its diagonal.
//
// p V in fp32, as the Pallas kernel keeps it: p meets V as a 16-bit head
// and the 16-bit rounding of its remainder, two products from registers,
// so p loses ~2^-17 (three products a tile against the bound's two).  p
// rounded once (2^-9 in bf16) puts ~2e-3 of each output row off the fp32
// result, and the backward's delta = rowsum(dO O) carries it into dS =
// p (dP - delta): where dQ's row is small (few keys, dP ~ delta) the
// forward + backward then land 2-20% of the row off the plain pair, past
// the 16-bit tolerance (PERF.md, PR 7).  The output is divided by
// max(l, 1e-30), rounded once and stored through shared memory in 16-byte
// rows; lse = m + log l (natural log, fp32), which the backward reads.
// Three stages of 128 keys, with features of 64 keys (the mask tile beside
// them).  Features (FEAT = true, its own instantiation; the plain one runs
// none of this code): the producer stages the fp32 mask tile with each K/V
// stage by TMA, segment ids and the fully-masked guard apply on every live
// score, and the dropout hash (the split hash of flash_common.cuh) is
// computed while the S product is in flight; l sums the undropped p, P V
// the kept p, and the survivors' rescale (`survivor`, the backward's
// 1 / (1 - p)) is applied once to each output before the division by l,
// so forward and backward drop the same elements bit for bit.
//
// D 32 (16-bit) keeps an mma.sync body: four warps own a 64-row q tile
// and loop over 64-key K/V tiles double-buffered by cp.async; there p is
// split into a 16-bit head and a 16-bit remainder and both meet v, so p v
// loses only ~2^-16 of p.  fp32 inputs take a plain FMA body (32 x 32
// tiles in shared memory).  No training path takes either.  Any S >= 1:
// ragged rows and keys are zero-filled and masked.
#include <cmath>
#include <cstdint>

#include "flash_hopper.cuh"

namespace {

using namespace ptt::flash;

// ------------------------------------------------- mma.sync body (D 32)
constexpr int BQ = 64;   // q rows per block (16 per warp)
constexpr int BK = 64;   // keys per K/V tile

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);

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
          s[nt][e] = dropped(f, global_head(f, b, h), e < 2 ? row_a : row_b,
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

// ------------------------------------------------------ fp32 (FMA) body
// fp32 inputs: the same loop on FMA, 32 q rows x 32 keys per step.  Thread
// (r = tid / 4, c = tid % 4) owns row r's scores for keys c, c + 4, ...
// and its accumulator columns c, c + 4, ... (strided: no bank conflicts).
constexpr int FQ = 32, FK = 32;

template <int D, bool FEAT>
__global__ void __launch_bounds__(kThreads, 1)
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
  if (drop) load_seed(f);

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
      if (drop) p = dropped(f, global_head(f, b, h), row, k0 + c + 4 * i, p);
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

// ------------------------------------------ wgmma body (16-bit D 64, 128)
constexpr int kFwdRows = 128;   // q rows a block: 64 a consumer warpgroup
constexpr int kSched = 3;       // named barriers of the issue turns (3, 4)
constexpr float kLn2 = 0.6931471805599453f;
// a masked score in log2 units at NEG_INF: the running max starts there,
// so a fully masked row's lse is NEG_INF as in the Pallas kernel
constexpr float kNegInfL2 = kNegInf * kLog2e;

template <int D, bool FEAT>
struct FwdSmem {
  static constexpr int KT = FEAT ? 64 : 128;   // keys a stage
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = 3;
  static constexpr uint32_t kQPanel = kFwdRows * kPanelBytes;
  static constexpr uint32_t kKPanel = KT * kPanelBytes;
  static constexpr uint32_t kKStage = kPanels * kKPanel;
  static constexpr uint32_t kMaskStage = FEAT ? kFwdRows * KT * 4 : 0;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kPanels * kQPanel;
  static constexpr uint32_t kV = kK + kStages * kKStage;
  static constexpr uint32_t kMask = kV + kStages * kKStage;
  static constexpr uint32_t kBar = kMask + kStages * kMaskStage;
  static constexpr size_t kAlloc = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <typename T, int D, bool FEAT>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_mask,
                T* __restrict__ out, float* __restrict__ lse, Strides os,
                int S, int H, int n_rep, float scale, bool causal,
                Features f) {
  using L = FwdSmem<D, FEAT>;
  constexpr int KT = L::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + L::kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;  // late rows first
  int n_tiles = (S + KT - 1) / KT;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kFwdRows, S) - 1) / KT + 1);
  const bool has_mask = FEAT && f.mask != nullptr;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_q, 1);
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
      hw::mbar_arrive_expect_tx(bar_q, L::kPanels * L::kQPanel);
      for (int p = 0; p < L::kPanels; ++p)
        hw::tma_load_4d(sm + L::kQ + p * L::kQPanel, &tm_q, bar_q, 64 * p,
                        q0, h, b);
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
  // m in log2 units; l the thread's share of its rows' sums
  float m_a = kNegInfL2, m_b = kNegInfL2, l_a = 0.f, l_b = 0.f;
  const uint64_t q_desc = hw::desc_k_major(sm + L::kQ + 64 * cw * kPanelBytes);
  float s[KT / 2];       // this tile's scores, then its p
  // the previous tile's p as P V's A operand: its 16-bit head (pf[0 ..
  // KT / 4)) and the 16-bit rounding of its remainder (the rest)
  uint32_t pf[KT / 2];
  int pv_st = 0;         // the stage of that tile's V

  // S = Q K^T of the tile in stage st into s
  auto issue_s = [&](int st) {
    const uint64_t k_desc = hw::desc_k_major(sm + L::kK + st * L::kKStage);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
      const uint32_t bo = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
      hw::Wgmma<T, KT>::ss(s, q_desc + a, k_desc + bo, kk > 0);
    }
    hw::wgmma_commit();
  };
  // O += P V for the tile whose p is in pf (after its rescale); `pv_done`
  // waits for it and hands its stage back
  auto issue_pv = [&]() {
    const uint64_t vt_desc =
        hw::desc_mn_major(sm + L::kV + pv_st * L::kKStage, L::kKPanel);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint64_t b = vt_desc + ((kk * 16 * kPanelBytes) >> 4);
      hw::Wgmma<T, D, 1>::rs(acc, pf + 4 * kk, b, 1);
      hw::Wgmma<T, D, 1>::rs(acc, pf + KT / 4 + 4 * kk, b, 1);
    }
    hw::wgmma_commit();
  };
  auto pv_done = [&]() {
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(pf);    // no new p is written before the product read it
    hw::mbar_arrive(&empty[pv_st]);
  };
  // the dropout keep bits of the tile at k0 (computed beside S)
  auto hash = [&](int k0) -> uint32_t {
    uint32_t keep = 0;
    if constexpr (FEAT) {
      static_assert(KT / 2 <= 32, "one keep bit a score of the thread");
      if (drop)
        keep = keep_bits<KT / 2>(
            f, hash_head(f, global_head(f, b, h)),
            [&](int i, uint32_t& qh, uint32_t& kh) {
              qh = i & 2 ? qh_b : qh_a;
              kh = hash_k(k0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
            });
    }
    return keep;
  };
  // The online softmax of the scores in s (the tile at k0 in stage st):
  // m and l updated, p (dropped, with dropout) in s; returns the rows'
  // rescale of the accumulator in al_a, al_b.  Element i: row (i & 2 ?
  // rb : ra), key k0 + 8 (i >> 2) + 2 t4 + (i & 1).  Scores become log2
  // units: scaled here (`fac` 1) or, on interior tiles with a positive
  // scale, inside the exponent's FMA (`fac`).
  auto softmax = [&](int k0, int st, uint32_t keep, float& al_a,
                     float& al_b) {
    float fac = 1.f;
    if (!masked) {                         // dropout alone takes it too
      const bool edge = (causal && k0 + KT - 1 > row0) || k0 + KT > S;
      if (edge) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          const int row = i & 2 ? rb : ra;
          const bool live = col < S && (!causal || col <= row);
          s[i] = live ? s[i] * scale_l2 : -INFINITY;
        }
      } else if (scale_l2 > 0.f) {
        fac = scale_l2;
      } else {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) s[i] *= scale_l2;
      }
    } else {
      const float* mask_s = reinterpret_cast<const float*>(
          sm + L::kMask + st * L::kMaskStage);
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int kc = 8 * (i >> 2) + 2 * t4 + (i & 1), col = k0 + kc;
        const int rl = 64 * cw + 16 * warp + g + (i & 2 ? 8 : 0);
        const bool live = col < S && (!causal || col <= q0 + rl);
        float x = s[i] * scale;
        if (live) {
          if (seg != nullptr && seg[col] != (i & 2 ? seg_b : seg_a))
            x = kNegInf;
          if (has_mask) x += mask_s[rl * KT + kc];
        }
        s[i] = live ? x * kLog2e : -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < KT / 2; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a * fac);
    const float mn_b = fmaxf(m_b, mx_b * fac);
    al_a = hw::ex2(m_a - mn_a);
    al_b = hw::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      float p = hw::ex2(fmaf(s[i], fac, -(i & 2 ? mn_b : mn_a)));
      // fully masked rows: a score at NEG_INF has probability 0
      if (masked && !(s[i] > kNegInfL2 * 0.5f)) p = 0.f;
      if (i & 2)
        rs_b += p;
      else
        rs_a += p;
      // l holds the undropped sum; dropout acts on the p that meets v
      // (the survivors' 1 / (1 - p) is applied to the output)
      if constexpr (FEAT) {
        if (drop && !((keep >> i) & 1u)) p = 0.f;
      }
      s[i] = p;
    }
    l_a = al_a * l_a + rs_a;
    l_b = al_b * l_b + rs_b;
  };
  // the accumulator rescaled, then p as a 16-bit head and remainder
  // (16 keys a product step)
  auto to_pf = [&](float al_a, float al_b, int st) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= i & 2 ? al_b : al_a;
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) {
      const float a = s[2 * i], b = s[2 * i + 1];
      pf[i] = Mma<T>::pack(a, b);
      pf[KT / 4 + i] =
          Mma<T>::pack(a - Mma<T>::round(a), b - Mma<T>::round(b));
    }
    pv_st = st;
  };
  // The two consumers take turns 0..n_tiles to issue products (named
  // barriers kSched + w; group 0 first): one group's products run while
  // the other computes its softmax.  Turn t of a group issues S of tile t
  // and P V of tile t - 1, as far as the group has them; a group with
  // fewer tiles still takes every turn, so the turns pair up.
  auto turn_begin = [&]() { hw::named_sync(kSched + cw, 2 * kWg); };
  auto turn_end = [&](int t) {   // group 1's last turn has no successor
    if (cw == 0 || t < n_tiles) hw::named_arrive(kSched + 1 - cw, 2 * kWg);
  };
  if (cw == 1) hw::named_arrive(kSched, 2 * kWg);
  hw::mbar_wait(bar_q, 0);

  // One tile ahead: S of tile j is issued with the P V of tile j - 1, so
  // the softmax of tile j overlaps that product.  Each issue, from the
  // fence to its wait, is straight-line code (no branch inside a wgmma
  // pipeline stage).
  if (wg_tiles > 0) {
    hw::mbar_wait(&full[0], 0);
    turn_begin();
    hw::wgmma_fence();
    issue_s(0);
    turn_end(0);
    const uint32_t keep = hash(0);
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    float al_a, al_b;
    softmax(0, 0, keep, al_a, al_b);
    to_pf(al_a, al_b, 0);
  }
  for (int j = 1; j < wg_tiles; ++j) {
    const int st = j % L::kStages;
    hw::mbar_wait(&full[st], (j / L::kStages) & 1);
    turn_begin();
    hw::wgmma_fence();
    issue_s(st);
    issue_pv();
    turn_end(j);
    const uint32_t keep = hash(j * KT);
    hw::wgmma_wait<1>();                   // S is in; P V still running
    hw::fence_regs(s);
    float al_a, al_b;
    softmax(j * KT, st, keep, al_a, al_b);
    pv_done();
    to_pf(al_a, al_b, st);
  }
  if (wg_tiles > 0) {                      // the last tile's P V
    turn_begin();
    hw::wgmma_fence();
    issue_pv();
    turn_end(wg_tiles);
    pv_done();
  } else {
    turn_begin();
    turn_end(0);
  }
  for (int j = wg_tiles; j < n_tiles; ++j) {   // tiles this group skips
    const int st = j % L::kStages;
    hw::mbar_wait(&full[st], (j / L::kStages) & 1);
    hw::mbar_arrive(&empty[st]);
    turn_begin();
    turn_end(j + 1);
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float L_a = fmaxf(l_a, 1e-30f), L_b = fmaxf(l_b, 1e-30f);
  if constexpr (FEAT) {
    if (drop) {                            // the survivors' rescale
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = survivor(f, true, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] /= i & 2 ? L_b : L_a;
  if (t4 == 0) {
    float* lb = lse + static_cast<int64_t>(bh) * S;
    if (ra < S) lb[ra] = m_a * kLn2 + logf(L_a);
    if (rb < S) lb[rb] = m_b * kLn2 + logf(L_b);
  }
  // out rounded once, through this group's (now unused) Q rows
  store_rows<T, D>(acc, sm + L::kQ + 64 * cw * kPanelBytes, L::kQPanel,
                   out + b * os.b + h * os.h, os.s, row0, S, 1 + cw);
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

template <typename T, int D, bool FEAT>
int launch_wgmma(const Call& a) {
  using L = FwdSmem<D, FEAT>;
  auto kernel = flash_fwd_wgmma<T, D, FEAT>;
  static const cudaError_t e = allow_smem(kernel, L::kAlloc);  // once
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv, tmask;
  cudaError_t err;
  if ((err = head_map<T>(&tq, a.q, a.qs, a.b, a.h, a.s, D, kFwdRows)) ||
      (err = head_map<T>(&tk, a.k, a.ks, a.b, a.h_kv, a.s, D, L::KT)) ||
      (err = head_map<T>(&tv, a.v, a.vs, a.b, a.h_kv, a.s, D, L::KT)) ||
      (err = mask_map(&tmask, a.f, a.b, a.h, a.s, L::KT, kFwdRows)))
    return static_cast<int>(err);
  dim3 grid(a.b * a.h, (a.s + kFwdRows - 1) / kFwdRows);
  kernel<<<grid, kWgmmaThreads, L::kAlloc, a.stream>>>(
      tq, tk, tv, tmask, static_cast<T*>(a.out), a.lse, a.os, a.s, a.h,
      a.h / a.h_kv, a.scale, a.causal, a.f);
  return static_cast<int>(cudaGetLastError());
}

// 16-bit inputs: D 64 and 128 take the wgmma body, D 32 the mma.sync one
template <typename T, int D, bool FEAT>
int launch_16bit(const Call& a) {
  if constexpr (D == 32)
    return launch_mma<T, D, FEAT>(a);
  else
    return launch_wgmma<T, D, FEAT>(a);
}

template <int D, bool FEAT>
int dispatch(int dtype, const Call& a) {
  switch (dtype) {
    case ptt::kF32: return launch_f32<D, FEAT>(a);
    case ptt::kBF16: return launch_16bit<__nv_bfloat16, D, FEAT>(a);
    case ptt::kF16: return launch_16bit<__half, D, FEAT>(a);
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
// D in {32, 64, 128}; one dtype for q, k, v and out; for 16-bit D 64 and
// 128 (the TMA maps, the 16-byte stores) 16-byte aligned bases and
// strides.  Features: `mask` fp32 with element strides (b, h, q) in
// mask_strides[0..2] (0 on a broadcast dim; keys contiguous) or null; for
// 16-bit D 64 and 128 its non-broadcast strides positive multiples of 4
// elements and its base 16-byte aligned; `seg` int32 [B, S] or null;
// `dropout` in [0, 1) with `keep_div` = (float)(1 - dropout) and `seed`,
// with dropout a pointer to the seed in device memory (the low 32 bits of
// an int32 or int64; every kernel reads it when it runs, so a captured
// launch takes the value the caller wrote before the replay).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int h_kv,
                             int s, int d, const long long* strides,
                             float scale, int causal, int dtype,
                             const void* mask, const long long* mask_strides,
                             const void* seg, float dropout, float keep_div,
                             const void* seed, int hash_b0, int hash_h0,
                             int hash_heads, void* stream) {
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || s <= 0 ||
      !(dropout >= 0.f && dropout < 1.f) ||
      (dropout > 0.f && seed == nullptr))
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
  a.f = make_features(mask, mask_strides, seg, dropout, keep_div, seed,
                      hash_b0, hash_h0, hash_heads);
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
      make_features(nullptr, nullptr, nullptr, dropout, keep_div, nullptr,
                    0, 0, 0);
  const long long blocks = (n + 255) / 256;
  dropout_rescale_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                               : 4096),
                           256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}
