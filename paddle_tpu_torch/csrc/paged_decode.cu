// Paged decode attention: one new query token per row against a paged KV
// cache, with GQA.
//
// Replaces: paddle_tpu/pallas/flash_attention.py paged_decode_attention /
// _paged_decode_kernel (float pools; the int8/fp8 variant is not ported
// yet).
//
// Bound on the H100 (3.35 TB/s): bytes.  Each row reads the K and V of its
// live tokens once: 2 * H_kv * D * bytes per token per layer, 16 KB for
// Llama-2 7B in bf16.  Four rows of 512 cached tokens are 32 MB, ~9.8 us a
// layer.  The arithmetic is 4 * H * D flops per cached token, ~1 flop per
// byte without GQA and n_rep flops per byte with it: far below the ~295
// flops per byte where the tensor cores would bind.
//
// Design: one block per (kv head, batch row), serving the row's n_rep
// query heads, so every K/V byte is read from device memory once whatever
// the GQA ratio.  The block reads its own page ids from page_table[b, :]
// and its offset (the TPU kernel got them by scalar prefetch), walks only
// the live pages j <= offsets[b] / page_size, and inside the last page
// only the positions <= offsets[b]: nothing past the offset is read, which
// is the causal mask.  Each page is staged in shared memory in tiles of
// up to 16 tokens as fp32 [tile, D] K and V; scores use one warp per
// (query head, token) with a shuffle reduction; the online softmax keeps
// its running max m, sum l and the accumulator acc[n_rep, D] in fp32 in
// shared memory.  The output is acc / max(l, 1e-30), as the TPU kernel's
// finalize, cast to q's type.  A row whose page table is all 0 (a free
// slot riding the static batch at offset 0) reads position 0 of scratch
// page 0 and returns finite values.  No tensor cores, no TMA: at decode
// the kernel is bound by bytes, and making it reach that bound is later
// work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
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
        const size_t g =
            ((page * page_size + t0 + t) * h_kv + kvh) * static_cast<size_t>(d) + dd;
        k_s[i] = ptt::to_f32(k_pool[g]);
        v_s[i] = ptt::to_f32(v_pool[g]);
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
      static_cast<const TKV*>(v_pool), page_table, offsets,
      static_cast<TQ*>(out), n_pages, page_size, h_kv, n_rep, d, scale,
      tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool,
              const void* v_pool, const int* page_table, const int* offsets,
              void* out, int b, int h, int h_kv, int d, int page_size,
              int n_pages, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case ptt::kF32:
      return launch<TQ, float>(q, k_pool, v_pool, page_table, offsets, out, b, h,
                               h_kv, d, page_size, n_pages, scale, stream);
    case ptt::kBF16:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, page_table, offsets, out,
                                       b, h, h_kv, d, page_size, n_pages, scale,
                                       stream);
    case ptt::kF16:
      return launch<TQ, __half>(q, k_pool, v_pool, page_table, offsets, out, b, h,
                                h_kv, d, page_size, n_pages, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: [b, h, d] of q_dtype; k_pool, v_pool: [P, page_size, h_kv, d] of
// kv_dtype; page_table: int32 [b, n_pages]; offsets: int32 [b].
extern "C" int ptt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* page_table,
                                const void* offsets, void* out, int b, int h,
                                int h_kv, int d, int page_size, int n_pages,
                                float scale, int q_dtype, int kv_dtype,
                                void* stream) {
  if (b <= 0 || h_kv <= 0 || h % h_kv != 0 || d <= 0 || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* off = static_cast<const int*>(offsets);
  switch (q_dtype) {
    case ptt::kF32:
      return launch_kv<float>(kv_dtype, q, k_pool, v_pool, pt, off, out, b, h, h_kv,
                              d, page_size, n_pages, scale, s);
    case ptt::kBF16:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, pt, off, out, b,
                                      h, h_kv, d, page_size, n_pages, scale, s);
    case ptt::kF16:
      return launch_kv<__half>(kv_dtype, q, k_pool, v_pool, pt, off, out, b, h, h_kv,
                               d, page_size, n_pages, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
