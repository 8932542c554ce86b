// Paged decode attention: one new query token per row against a paged KV
// cache, with GQA, over float pools or quantized (int8 / fp8 e4m3) pools
// with one float32 scale per cached token row.
//
// Replaces: paddle_tpu/pallas/flash_attention.py paged_decode_attention /
// _paged_decode_kernel, both variants (``quant`` False and True).
//
// Bound on the H100 (3.35 TB/s): bytes.  Each row reads the K and V of its
// live tokens once: 2 * H_kv * D * bytes per token per layer, 16 KB for
// Llama-2 7B in bf16 and 8 KB (+ 8 bytes of scales) in int8 or fp8.  Four
// rows of 100-620 cached tokens are 25 MB in bf16, ~7.5 us a layer, and
// half that quantized.  The arithmetic is 4 * H * D flops per cached
// token (plus the dequantizing multiply): 1 flop per byte without GQA and
// at most n_rep = 8 with it, far below the ~295 flops per byte where the
// tensor cores would bind, so the design spends nothing on them.
//
// What held the first design back (one block per (kv head, row)): 128
// blocks at the 7B serving shape and 32 at 70B's GQA heads on a card of
// 132 SMs, each walking its whole row alone; every 16-token tile a chain
// of four __syncthreads() (stage, scores, softmax, p.V) with nothing
// overlapped; a softmax update run by n_rep threads while the rest waited;
// scalar 1- or 2-byte loads, ~8 KB in flight a block.  It reached ~0.06
// TB/s, 2% of the bound.
//
// This design (flash-decoding):
// - The cached sequence is cut into splits of `split_tokens` positions, a
//   multiple of the page size; the grid is (split, kv head x query-head
//   group, row).  The host picks the split from what it knows without
//   reading `offsets` (capacity, batch, heads, SM count: plan_splits in
//   kernels/paged_decode.py), so the call can be captured in a CUDA graph
//   whose offsets change between replays.  A split that starts past
//   offsets[b] returns at once.
// - A block serves one kv head's n_rep query heads (at most 8 a block), so
//   every K/V byte is read once.  It loads its split's live page ids into
//   shared memory once; table entries past the row's offset are never
//   read.  Each warp takes a stripe of the split's tokens; a group of
//   `lanes` lanes takes one token, each lane 16 bytes of its K row and V
//   row (8 bf16/fp16, 16 int8/fp8, 2 x 4 fp32; 8 bytes of int8/fp8 when
//   n_rep is 8, so that q and the accumulator stay in registers) with one
//   vector load, or element by element where D * elem is not a multiple of
//   the vector (the scalar tail).  fp8 codes are converted two at a time
//   (__nv_cvt_fp8x2_to_halfraw2), int8 and 16-bit ones in registers, then
//   multiplied by the row's scale in fp32 before the dot (the Pallas
//   body's ``kf * ks``).
// - q lives in registers, spread over the group's lanes; scores are lane
//   partial sums reduced by shuffles; each lane keeps its group's online
//   softmax (m, l, acc[n_rep, its 16 bytes of D]) in fp32 registers, in
//   base 2 (scores scaled by scale * log2 e).  No barrier inside the loop.
// - Loads run one stage ahead: the next stage's K/V rows (1-4 tokens a
//   lane group) are issued before the current stage's arithmetic, 32 KB a
//   block in flight at the 7B serving shape (4 warps x 2 stages x 8
//   tokens x 512 bytes).
// - At the end the groups of a warp merge by shuffles, the warps through
//   shared memory, in a fixed order.  With one split the block writes the
//   output, acc / max(l, 1e-30) rounded once to q's type.  Otherwise it
//   writes an fp32 partial (m, l, acc) to scratch the wrapper allocated,
//   and a second kernel merges each (row, head)'s live splits (counted from
//   offsets[b] on the device: a dead split's scratch is never read) in
//   split order.  No atomics: two calls give the same bits.
// A free row (page table all 0, offset 0) reads position 0 of scratch page
// 0 and returns finite values.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename TKV>
constexpr bool kQuantized =
    std::is_same<TKV, int8_t>::value || std::is_same<TKV, __nv_fp8_e4m3>::value;

template <int S>
struct RawOf;
template <>
struct RawOf<1> { using T = uint8_t; };
template <>
struct RawOf<2> { using T = uint16_t; };
template <>
struct RawOf<4> { using T = uint32_t; };

// What a lane holds of one token's row: kElems elements in kWords 32-bit
// words; kTok tokens a lane group loads a stage.  Registers bound the
// sizes: q and acc take 2 * NREP * kElems floats, two stages of K and V
// 4 * kTok * kWords words (at most 4 * kStageWords).  The stage shrinks as
// n_rep grows so that no instantiation spills (ptxas -v, chip_smoke.py's
// build phase): 4 tokens of 16 bytes without GQA, 2 with it, 1 for 8-bit
// pools at n_rep 3-4 and for fp32 pools with GQA.
template <typename TKV, int NREP>
struct Geo {
  static constexpr int kSize = sizeof(TKV);
  static constexpr int kElems = (kSize == 1 && NREP < 8) ? 16 : 8;
  static constexpr int kWords = kElems * kSize / 4;
  static constexpr int kStageWords =
      NREP == 1 ? 16 : (kSize == 1 && NREP >= 4 ? 4 : 8);
  static constexpr int kTokFit = kStageWords / kWords;
  static constexpr int kTok = kTokFit < 1 ? 1 : (kTokFit > 4 ? 4 : kTokFit);
};

template <typename TKV, int NREP>
struct Stage {
  using G = Geo<TKV, NREP>;
  uint32_t k[G::kTok][G::kWords];
  uint32_t v[G::kTok][G::kWords];
  float ks[G::kTok], vs[G::kTok];
};

// The lane's elements d0 .. d0 + kElems of a row: one or two vector loads,
// or element by element (masked at d) where the row is not vector-aligned.
template <typename TKV, int W>
__device__ __forceinline__ void load_row(uint32_t (&w)[W], const TKV* row,
                                         int d0, int d, bool vec) {
  constexpr int S = sizeof(TKV);
  constexpr int E = W * 4 / S;
  if (vec && d0 < d) {
    if constexpr (W >= 4) {
      const uint4* p = reinterpret_cast<const uint4*>(row + d0);
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 x = __ldg(p + i);
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(row + d0));
      w[0] = x.x;
      w[1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u;
  if (vec) return;
  using R = typename RawOf<S>::T;
  const R* r = reinterpret_cast<const R*>(row);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int dd = d0 + e;
    if (dd < d)
      w[e * S / 4] |= static_cast<uint32_t>(r[dd]) << (8 * ((e * S) % 4));
  }
}

__device__ __forceinline__ float2 half2_bits_to_float2(uint32_t bits) {
  __half2_raw raw;
  raw.x = static_cast<unsigned short>(bits & 0xffffu);
  raw.y = static_cast<unsigned short>(bits >> 16);
  return __half22float2(__half2(raw));
}

// Words of TKV elements (element 0 in the low bits) to floats.
template <typename TKV, int W>
__device__ __forceinline__ void decode(const uint32_t (&w)[W],
                                       float (&f)[W * 4 / sizeof(TKV)]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (std::is_same<TKV, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else if constexpr (std::is_same<TKV, __half>::value) {
      const float2 p = half2_bits_to_float2(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    } else if constexpr (std::is_same<TKV, int8_t>::value) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * i + k] =
            static_cast<float>(static_cast<int8_t>((w[i] >> (8 * k)) & 0xffu));
    } else {  // fp8 e4m3: two codes at a time, exact through half
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu),
            __NV_E4M3);
        const float2 p = __half22float2(__half2(h));
        f[4 * i + 2 * j] = p.x;
        f[4 * i + 2 * j + 1] = p.y;
      }
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, int dtype, size_t i) {
  switch (dtype) {
    case ptt::kBF16:
      return ptt::to_f32(static_cast<const __nv_bfloat16*>(q)[i]);
    case ptt::kF16:
      return ptt::to_f32(static_cast<const __half*>(q)[i]);
    default:
      return static_cast<const float*>(q)[i];
  }
}

__device__ __forceinline__ void store_out(void* out, int dtype, size_t i,
                                          float v) {
  switch (dtype) {
    case ptt::kBF16:
      static_cast<__nv_bfloat16*>(out)[i] = ptt::from_f32<__nv_bfloat16>(v);
      break;
    case ptt::kF16:
      static_cast<__half*>(out)[i] = ptt::from_f32<__half>(v);
      break;
    default:
      static_cast<float*>(out)[i] = v;
  }
}

// One lane's walk over its warp's stripe of a split: q, the online softmax
// (m, l) and acc in registers, base 2.  Token t of the split is position
// t_begin + t; a lane group of `lanes` lanes takes one token at a time.
template <typename TKV, int NREP>
struct Walker {
  using G = Geo<TKV, NREP>;
  using St = Stage<TKV, NREP>;
  static constexpr int E = G::kElems, W = G::kWords, TOK = G::kTok;
  const TKV* k_pool;
  const TKV* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* pages;              // the split's live page ids (shared)
  int page_size, h_kv, kvh, d, d0, lanes, per_warp, grp, n_tok;
  bool vec;
  float scale_log2;
  float qr[NREP][E];
  float m[NREP], l[NREP], acc[NREP][E];

  __device__ __forceinline__ void load(St& s, int base) const {
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      const int t = base + u * per_warp + grp;
      if (t < n_tok) {
        const int pi = t / page_size;
        const size_t row = static_cast<size_t>(pages[pi]) * page_size +
                           (t - pi * page_size);
        const size_t g = (row * h_kv + kvh) * static_cast<size_t>(d);
        load_row<TKV, W>(s.k[u], k_pool + g, d0, d, vec);
        load_row<TKV, W>(s.v[u], v_pool + g, d0, d, vec);
        if constexpr (kQuantized<TKV>) {
          s.ks[u] = __ldg(k_scale + row);
          s.vs[u] = __ldg(v_scale + row);
        }
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) s.k[u][i] = s.v[u][i] = 0u;
        if constexpr (kQuantized<TKV>) s.ks[u] = s.vs[u] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void consume(const St& s, int base) {
    float p[TOK][NREP];
    bool ok[TOK];
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      ok[u] = base + u * per_warp + grp < n_tok;
      float kf[E];
      decode<TKV, W>(s.k[u], kf);
      if constexpr (kQuantized<TKV>) {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] *= s.ks[u];
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[r][e], kf[e], dot);
        p[u][r] = dot;
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < NREP; ++r)
          p[u][r] += __shfl_xor_sync(kFull, p[u][r], o);
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        p[u][r] = ok[u] ? p[u][r] * scale_log2 : kNeg;
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < TOK; ++u) mx = fmaxf(mx, p[u][r]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < TOK; ++u) {
        p[u][r] = ok[u] ? exp2f(p[u][r] - mx) : 0.f;
        sum += p[u][r];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      float vf[E];
      decode<TKV, W>(s.v[u], vf);
      if constexpr (kQuantized<TKV>) {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] *= s.vs[u];
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p[u][r], vf[e], acc[r][e]);
    }
  }

  // merge the warp's lane groups (butterfly: every group gets the result)
  __device__ __forceinline__ void merge_groups() {
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float mo = __shfl_xor_sync(kFull, m[r], o);
        const float lo = __shfl_xor_sync(kFull, l[r], o);
        const float mx = fmaxf(m[r], mo);
        const float wa = exp2f(m[r] - mx), wo = exp2f(mo - mx);
        l[r] = l[r] * wa + lo * wo;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(kFull, acc[r][e], o);
          acc[r][e] = acc[r][e] * wa + ao * wo;
        }
        m[r] = mx;
      }
    }
  }
};

// grid (n_splits, h_kv * n_groups, b).  k_scale, v_scale: float32
// [P, page_size] for a quantized pool, else null.  part_acc: fp32
// [b, h, n_splits, d] and part_ml [b, h, n_splits, 2] when n_splits > 1.
template <typename TKV, int NREP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const void* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ page_table,
                   const int* __restrict__ offsets, void* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int n_pages, int page_size, int h_kv, int n_rep, int d,
                   int lanes, int split_tokens, int n_splits,
                   float scale_log2, int q_dtype, bool vec) {
  using Wk = Walker<TKV, NREP>;
  constexpr int E = Wk::E, TOK = Wk::TOK;
  extern __shared__ float smem[];
  float* red = smem;                               // [kWarps][NREP][d]
  float* ml = red + kWarps * NREP * d;             // [kWarps][NREP][2]
  int* pages = reinterpret_cast<int*>(ml + kWarps * NREP * 2);

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_groups = gridDim.y / h_kv;
  const int kvh = blockIdx.y / n_groups;
  const int qg = blockIdx.y - kvh * n_groups;
  const int h = h_kv * n_rep;
  const int head0 = kvh * n_rep + qg * NREP;
  const int reps = min(NREP, n_rep - qg * NREP);
  const int off = offsets[b];
  const int t_begin = split * split_tokens;
  if (n_splits > 1 && t_begin > off) return;       // a dead split
  const int t_end =
      min(min(t_begin + split_tokens, n_pages * page_size), off + 1);
  const int n_tok = max(t_end - t_begin, 0);
  const int p0 = t_begin / page_size;
  const int live_pages = n_tok > 0 ? (t_end - 1) / page_size - p0 + 1 : 0;
  const int* pt = page_table + static_cast<size_t>(b) * n_pages + p0;
  for (int i = threadIdx.x; i < live_pages; i += kThreads) pages[i] = pt[i];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Wk wk;
  wk.k_pool = k_pool;
  wk.v_pool = v_pool;
  wk.k_scale = k_scale;
  wk.v_scale = v_scale;
  wk.pages = pages;
  wk.page_size = page_size;
  wk.h_kv = h_kv;
  wk.kvh = kvh;
  wk.d = d;
  wk.lanes = lanes;
  wk.d0 = (lane & (lanes - 1)) * E;
  wk.grp = lane / lanes;
  wk.per_warp = 32 / lanes;                        // tokens a warp takes at once
  wk.n_tok = n_tok;
  wk.vec = vec;
  wk.scale_log2 = scale_log2;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      wk.qr[r][e] = (r < reps && wk.d0 + e < d)
                        ? load_q(q, q_dtype,
                                 (static_cast<size_t>(b) * h + head0 + r) * d +
                                     wk.d0 + e)
                        : 0.f;
    wk.m[r] = kNeg;
    wk.l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) wk.acc[r][e] = 0.f;
  }
  __syncthreads();

  // one stage ahead: the next rows are in flight during this stage's math
  const int per_stage = wk.per_warp * TOK;
  const int stride = kWarps * per_stage;
  typename Wk::St sa, sb;
  int base = warp * per_stage;
  wk.load(sa, base);
  for (; base < n_tok; base += 2 * stride) {
    wk.load(sb, base + stride);
    wk.consume(sa, base);
    wk.load(sa, base + 2 * stride);
    wk.consume(sb, base + stride);
  }
  wk.merge_groups();

  if (wk.grp == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (wk.d0 + e < d) red[(warp * NREP + r) * d + wk.d0 + e] = wk.acc[r][e];
      if (wk.d0 == 0) {
        ml[(warp * NREP + r) * 2] = wk.m[r];
        ml[(warp * NREP + r) * 2 + 1] = wk.l[r];
      }
    }
  }
  __syncthreads();
  // merge the warps in warp order
  for (int i = threadIdx.x; i < reps * d; i += kThreads) {
    const int r = i / d, dd = i - r * d;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[(w * NREP + r) * 2]);
    float lsum = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(ml[(w * NREP + r) * 2] - mx);
      lsum += ml[(w * NREP + r) * 2 + 1] * wt;
      sum += red[(w * NREP + r) * d + dd] * wt;
    }
    const size_t row = static_cast<size_t>(b) * h + head0 + r;
    if (n_splits == 1) {
      store_out(out, q_dtype, row * d + dd, sum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t pi = row * n_splits + split;
      part_acc[pi * d + dd] = sum;
      if (dd == 0) {
        part_ml[2 * pi] = mx;
        part_ml[2 * pi + 1] = lsum;
      }
    }
  }
}

// grid (h, b): the live splits of each (row, head), in split order.
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ offsets, void* __restrict__ out,
                   int h, int d, int split_tokens, int n_splits, int q_dtype) {
  const int head = blockIdx.x, b = blockIdx.y;
  const int off = offsets[b];
  const int live = off < 0 ? 0 : min(off / split_tokens + 1, n_splits);
  const size_t row = static_cast<size_t>(b) * h + head;
  const float* mlr = part_ml + row * n_splits * 2;
  const float* accr = part_acc + row * n_splits * d;
  float mx = kNeg;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, mlr[2 * i]);
  float lsum = 0.f;
  for (int i = 0; i < live; ++i) lsum += mlr[2 * i + 1] * exp2f(mlr[2 * i] - mx);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float sum = 0.f;
    for (int i = 0; i < live; ++i)
      sum += accr[static_cast<size_t>(i) * d + dd] * exp2f(mlr[2 * i] - mx);
    store_out(out, q_dtype, row * d + dd, sum / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* offsets;
  void* out;
  float* part_acc;
  float* part_ml;
  int b, h, h_kv, d, page_size, n_pages, split_tokens, n_splits, q_dtype;
  float scale;
  cudaStream_t stream;
};

template <typename TKV, int NREP>
int launch(const Args& a) {
  using G = Geo<TKV, NREP>;
  const int n_rep = a.h / a.h_kv;
  const int chunks = (a.d + G::kElems - 1) / G::kElems;
  int lanes = 1;
  while (lanes < chunks) lanes <<= 1;
  if (lanes > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = a.d % G::kElems == 0 &&
                   reinterpret_cast<uintptr_t>(a.k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v_pool) % 16 == 0;
  const int n_groups = (n_rep + NREP - 1) / NREP;
  const size_t smem = sizeof(float) * kWarps * NREP * (a.d + 2) +
                      sizeof(int) * (a.split_tokens / a.page_size);
  auto kernel = paged_decode_split<TKV, NREP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(a.n_splits, a.h_kv * n_groups, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool),
      a.k_scale, a.v_scale, a.page_table, a.offsets, a.out, a.part_acc,
      a.part_ml, a.n_pages, a.page_size, a.h_kv, n_rep, a.d, lanes,
      a.split_tokens, a.n_splits, a.scale * kLog2e, a.q_dtype, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return static_cast<int>(e);
  paged_decode_merge<<<dim3(a.h, a.b), kMergeThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, a.offsets, a.out, a.h, a.d, a.split_tokens,
      a.n_splits, a.q_dtype);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int launch_rep(const Args& a) {
  const int n_rep = a.h / a.h_kv;
  if (n_rep == 1) return launch<TKV, 1>(a);
  if (n_rep == 2) return launch<TKV, 2>(a);
  if (n_rep <= 4) return launch<TKV, 4>(a);
  return launch<TKV, 8>(a);     // n_rep > 8: groups of 8 query heads
}

}  // namespace

// q, out: [b, h, d] of q_dtype; k_pool, v_pool: [P, page_size, h_kv, d] of
// kv_dtype; k_scale, v_scale: float32 [P, page_size] when kv_dtype is kI8 or
// kF8E4M3, else null; page_table: int32 [b, n_pages]; offsets: int32 [b].
// The sequence is cut into n_splits splits of split_tokens positions (a
// multiple of page_size, n_splits * split_tokens >= n_pages * page_size);
// with n_splits > 1, part_acc (fp32 [b, h, n_splits, d]) and part_ml (fp32
// [b, h, n_splits, 2]) are scratch, else null.
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* page_table,
                                const void* offsets, void* out, void* part_acc,
                                void* part_ml, int b, int h, int h_kv, int d,
                                int page_size, int n_pages, int split_tokens,
                                int n_splits, float scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (b <= 0 || h_kv <= 0 || h % h_kv != 0 || d <= 0 || page_size <= 0 ||
      n_pages <= 0 || split_tokens <= 0 || split_tokens % page_size != 0 ||
      n_splits <= 0 ||
      static_cast<long long>(n_splits) * split_tokens <
          static_cast<long long>(n_pages) * page_size ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (q_dtype != ptt::kF32 && q_dtype != ptt::kBF16 && q_dtype != ptt::kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  // a quantized pool comes with its scales, a float pool without
  const bool quant = kv_dtype == ptt::kI8 || kv_dtype == ptt::kF8E4M3;
  if (quant != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(offsets), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml), b,
               h, h_kv, d, page_size, n_pages, split_tokens, n_splits, q_dtype,
               scale, static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case ptt::kF32: return launch_rep<float>(a);
    case ptt::kBF16: return launch_rep<__nv_bfloat16>(a);
    case ptt::kF16: return launch_rep<__half>(a);
    case ptt::kI8: return launch_rep<int8_t>(a);
    case ptt::kF8E4M3: return launch_rep<__nv_fp8_e4m3>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
