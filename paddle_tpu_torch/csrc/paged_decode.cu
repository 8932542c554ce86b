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
// rows of 512 cached tokens are 32 MB in bf16, ~9.8 us a layer, and half
// that quantized.  The arithmetic is 4 * H * D flops per cached token
// (plus the dequantizing multiply), ~1 flop per byte without GQA and
// n_rep flops per byte with it: far below the ~295 flops per byte where
// the tensor cores would bind.
//
// Design: one block per (kv head, batch row), serving the row's n_rep
// query heads, so every K/V byte is read from device memory once whatever
// the GQA ratio.  The block reads its own page ids from page_table[b, :]
// and its offset (the TPU kernel got them by scalar prefetch), walks only
// the live pages j <= offsets[b] / page_size, and inside the last page
// only the positions <= offsets[b]: nothing past the offset is read, which
// is the causal mask.  Each page is staged in shared memory in tiles of
// up to 16 tokens as fp32 [tile, D] K and V; a quantized pool's values are
// converted to fp32 and multiplied by their row's fp32 scale as they are
// staged (the Pallas body's ``kf * ks``, before the dot).  Scores use one
// warp per (query head, token) with a shuffle reduction; the online
// softmax keeps its running max m, sum l and the accumulator acc[n_rep, D]
// in fp32 in shared memory.  The output is acc / max(l, 1e-30), as the TPU
// kernel's finalize, rounded once to q's type.  A row whose page table is
// all 0 (a free slot riding the static batch at offset 0) reads position
// 0 of scratch page 0 and returns finite values.  No tensor cores, no
// TMA, one element a thread per load: at decode the kernel is bound by
// bytes, and making it reach that bound is later work.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

template <typename TKV>
constexpr bool kQuantized =
    std::is_same<TKV, int8_t>::value || std::is_same<TKV, __nv_fp8_e4m3>::value;

// k_scale, v_scale: float32 [P, page_size] for a quantized pool, else null.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ offsets, TQ* __restrict__ out,
                    int n_pages, int page_size, int h_kv, int n_rep, int d,
                    float scale, int tile) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h = h_kv * n_rep;
  float* q_s = smem;                  // [n_rep, d]
  float* acc = q_s + n_rep * d;       // [n_rep, d]
  float* k_s = acc + n_rep * d;       // [tile, d]
  float* v_s = k_s + tile * d;        // [tile, d]
  float* s_s = v_s + tile * d;        // [n_rep, tile]
  float* m_s = s_s + n_rep * tile;    // [n_rep]
  float* l_s = m_s + n_rep;           // [n_rep]
  float* a_s = l_s + n_rep;           // [n_rep] rescale of this tile

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  const TQ* qb = q + (static_cast<size_t>(b) * h +
                      static_cast<size_t>(kvh) * n_rep) * d;
  for (int i = tid; i < n_rep * d; i += blockDim.x) {
    q_s[i] = ptt::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < n_rep; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int off = offsets[b];
  const int* pt = page_table + static_cast<size_t>(b) * n_pages;
  const int live_pages = off / page_size + 1;
  for (int j = 0; j < live_pages; ++j) {
    const size_t page = static_cast<size_t>(pt[j]);
    const int page_live = min(page_size, off - j * page_size + 1);
    for (int t0 = 0; t0 < page_live; t0 += tile) {
      const int n_tok = min(tile, page_live - t0);
      for (int i = tid; i < n_tok * d; i += blockDim.x) {
        const int t = i / d, dd = i - t * d;
        const size_t row = page * page_size + t0 + t;
        const size_t g = (row * h_kv + kvh) * static_cast<size_t>(d) + dd;
        if constexpr (kQuantized<TKV>) {
          k_s[i] = ptt::to_f32(k_pool[g]) * k_scale[row];
          v_s[i] = ptt::to_f32(v_pool[g]) * v_scale[row];
        } else {
          k_s[i] = ptt::to_f32(k_pool[g]);
          v_s[i] = ptt::to_f32(v_pool[g]);
        }
      }
      __syncthreads();
      for (int p = warp; p < n_rep * n_tok; p += n_warps) {
        const int r = p / n_tok, t = p - r * n_tok;
        float dot = 0.f;
        for (int dd = lane; dd < d; dd += 32) dot += q_s[r * d + dd] * k_s[t * d + dd];
        dot = ptt::warp_sum(dot);
        if (lane == 0) s_s[r * tile + t] = dot * scale;
      }
      __syncthreads();
      for (int r = tid; r < n_rep; r += blockDim.x) {
        const float m_prev = m_s[r];
        float m_new = m_prev;
        for (int t = 0; t < n_tok; ++t) m_new = fmaxf(m_new, s_s[r * tile + t]);
        float sum = 0.f;
        for (int t = 0; t < n_tok; ++t) {
          const float pr = expf(s_s[r * tile + t] - m_new);
          s_s[r * tile + t] = pr;
          sum += pr;
        }
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
      __syncthreads();
      for (int i = tid; i < n_rep * d; i += blockDim.x) {
        const int r = i / d, dd = i - r * d;
        float a = acc[i] * a_s[r];
        for (int t = 0; t < n_tok; ++t) a += s_s[r * tile + t] * v_s[t * d + dd];
        acc[i] = a;
      }
      __syncthreads();
    }
  }
  TQ* ob = out + (static_cast<size_t>(b) * h + static_cast<size_t>(kvh) * n_rep) * d;
  for (int i = tid; i < n_rep * d; i += blockDim.x) {
    const int r = i / d;
    ob[i] = ptt::from_f32<TQ>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale,
           const int* page_table, const int* offsets, void* out, int b,
           int h, int h_kv, int d, int page_size, int n_pages, float scale,
           cudaStream_t stream) {
  const int n_rep = h / h_kv;
  const int tile = page_size < 16 ? page_size : 16;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(n_rep) * d + 2 * tile * d +
                       n_rep * tile + 3 * n_rep);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(h_kv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), k_scale, v_scale, page_table, offsets,
      static_cast<TQ*>(out), n_pages, page_size, h_kv, n_rep, d, scale,
      tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool,
              const void* v_pool, const float* ks, const float* vs,
              const int* pt, const int* off, void* out, int b, int h,
              int h_kv, int d, int psz, int n_pages, float scale,
              cudaStream_t s) {
  // a quantized pool comes with its scales, a float pool without
  if ((kv_dtype == ptt::kI8 || kv_dtype == ptt::kF8E4M3) != (ks != nullptr) ||
      (ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_dtype) {
    case ptt::kF32:
      return launch<TQ, float>(q, k_pool, v_pool, ks, vs, pt, off, out, b, h,
                               h_kv, d, psz, n_pages, scale, s);
    case ptt::kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, ks, vs, pt, off, out,
                                       b, h, h_kv, d, psz, n_pages, scale, s);
    case ptt::kF16:
      return launch<TQ, __half>(q, k_pool, v_pool, ks, vs, pt, off, out, b, h,
                                h_kv, d, psz, n_pages, scale, s);
    case ptt::kI8:
      return launch<TQ, int8_t>(q, k_pool, v_pool, ks, vs, pt, off, out, b, h,
                                h_kv, d, psz, n_pages, scale, s);
    case ptt::kF8E4M3:
      return launch<TQ, __nv_fp8_e4m3>(q, k_pool, v_pool, ks, vs, pt, off, out,
                                       b, h, h_kv, d, psz, n_pages, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: [b, h, d] of q_dtype; k_pool, v_pool: [P, page_size, h_kv, d] of
// kv_dtype; k_scale, v_scale: float32 [P, page_size] when kv_dtype is kI8 or
// kF8E4M3, else null; page_table: int32 [b, n_pages]; offsets: int32 [b].
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* page_table,
                                const void* offsets, void* out, int b, int h,
                                int h_kv, int d, int page_size, int n_pages,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (b <= 0 || h_kv <= 0 || h % h_kv != 0 || d <= 0 || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pt = static_cast<const int*>(page_table);
  const int* off = static_cast<const int*>(offsets);
  switch (q_dtype) {
    case ptt::kF32:
      return launch_kv<float>(kv_dtype, q, k_pool, v_pool, ks, vs, pt, off, out,
                              b, h, h_kv, d, page_size, n_pages, scale, s);
    case ptt::kBF16:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, ks, vs, pt,
                                      off, out, b, h, h_kv, d, page_size,
                                      n_pages, scale, s);
    case ptt::kF16:
      return launch_kv<__half>(kv_dtype, q, k_pool, v_pool, ks, vs, pt, off, out,
                               b, h, h_kv, d, page_size, n_pages, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
