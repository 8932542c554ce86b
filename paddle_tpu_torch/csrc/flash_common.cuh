// Shared pieces of the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile geometry, the strides of one tensor, the
// 16-bit tensor-core product (mma.sync m16n8k16, fp32 accumulation),
// ldmatrix fragment loads and cp.async tile copies; and the optional score
// features of all three kernels (`Features`: the additive mask, segment
// ids and attention dropout of paddle_tpu/pallas/flash_attention.py
// _apply_masks and _dropout_uniform).
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t4):
//   A 16x16 row-major: a0 (g, 2t4..+1)  a1 (g+8, 2t4..)  a2 (g, 8+2t4..)
//                      a3 (g+8, 8+2t4..)
//   B 16x8  (k, n):    b0 (k = 2t4..+1, n = g)  b1 (k = 8+2t4.., n = g)
//   C 16x8  fp32:      c0, c1 (g, 2t4..+1)      c2, c3 (g+8, 2t4..+1)
// so the C fragments of two neighbouring 8-column tiles are, element for
// element, the A fragment of the next product over those 16 columns
// (packed to 16 bits): probabilities never leave registers.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr float kNegInf = -1e30f;   // the Pallas kernels' NEG_INF
constexpr int kThreads = 128;       // four warps per block

// Element strides of a [B, H, S, D] view (D contiguous): both layouts of
// the public op, [B, H, S, D] and [B, S, H, D], are such views.
struct Strides {
  int64_t b, h, s;
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // two floats rounded to one 32-bit register, `lo` in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 16-bit matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives (row l / 4, columns 2 (l % 4) .. +1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane l receives (rows 2 (l % 4) .. +1,
// column l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment (16 rows x 16 columns) of a row-major tile in shared memory
// with row stride `ld` elements, rows r0.., columns c0..
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int ld,
                                       int r0, int c0, int lane) {
  const int row = r0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = c0 + ((lane >> 4) << 3);
  ldmatrix_x4(a, tile + row * ld + col);
}

// B fragments of two neighbouring n-tiles (b[0..1] for n0.., b[2..3] for
// n0+8..) for a product over k = c0..c0+15, where B[k][n] = tile[n][k]
// (the tile holds B transposed: keys x head dim for Q K^T).
template <typename T>
__device__ __forceinline__ void load_b_nt(uint32_t* b, const T* tile, int ld,
                                          int n0, int c0, int lane) {
  const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int col = c0 + (((lane >> 3) & 1) << 3);
  ldmatrix_x4(b, tile + row * ld + col);
}

// B fragments of two neighbouring n-tiles for k = k0..k0+15 where
// B[k][n] = tile[k][n] (the tile holds B itself: keys x head dim for P V).
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const T* tile, int ld,
                                          int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = n0 + ((lane >> 4) << 3);
  ldmatrix_x4_trans(b, tile + row * ld + col);
}

// 16-byte asynchronous copy global -> shared; `full` false fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows 0..ROWS-1 of a [rows, D] tile (row stride `stride` elements) into
// shared memory with row stride D + 8; rows at or past `valid` are zero.
// `valid` >= 1, so a clamped row address is always inside the tensor.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int valid,
                                          int tid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool ok = r < valid;
    const int rs = ok ? r : valid - 1;
    cp_async16(dst + r * kLd + c, src + rs * stride + c, ok);
  }
}

// ------------------------------------------------------------- features
// The optional inputs of a call, passed to every kernel by value.  A
// kernel instantiated with FEAT = false never reads them (the plain causal
// path is the code it was before the features).
struct Features {
  // fp32 additive mask [B|1, H|1, S, S]: element strides of its batch,
  // head and query dims (0 on a broadcast dim, so a [1, 1, S, S] mask is
  // never expanded); keys contiguous.  nullptr: none
  const float* mask;
  int64_t mask_b, mask_h, mask_q;
  const int* seg;      // int32 segment ids [B, S], contiguous; nullptr: none
  float dropout;       // the drop probability; 0: none
  // the call's dropout seed: the low 32 bits of an int32 or int64 in
  // device memory (a CUDA graph replays the launch, and the caller
  // rewrites the value between replays), read by `load_seed` into `seed`
  const uint32_t* seed_ptr;
  uint32_t seed;
  uint32_t keep_min;   // ceil(dropout 2^24): the least kept (hash >> 8)
  double keep_rcp;     // 1 / (double)keep_div, rounded once: the
                       // survivors' factor (keep_div = (float)(1 - p))
  // the hash's head index of (batch row b, q head h) is (b + hash_b0) *
  // hash_heads + hash_h0 + h: a call over a part of a larger batch or
  // head range (a dp or mp rank's) draws the masks of its global rows
  // and heads; (0, 0, H) is the local b * H + h
  int hash_b0, hash_h0, hash_heads;
  __host__ __device__ bool masked() const {
    return mask != nullptr || seg != nullptr;
  }
  __host__ __device__ bool any() const { return masked() || dropout > 0.f; }
};

// The features of a call from the C entry points' arguments.
inline Features make_features(const void* mask,
                              const long long* mask_strides,
                              const void* seg, float dropout,
                              float keep_div, const void* seed,
                              int hash_b0, int hash_h0, int hash_heads) {
  Features f{};
  f.mask = static_cast<const float*>(mask);
  if (mask != nullptr) {
    f.mask_b = mask_strides[0];
    f.mask_h = mask_strides[1];
    f.mask_q = mask_strides[2];
  }
  f.seg = static_cast<const int*>(seg);
  f.dropout = dropout;
  f.seed_ptr = static_cast<const uint32_t*>(seed);
  f.seed = 0;
  f.keep_min = static_cast<uint32_t>(
      std::ceil(static_cast<double>(dropout) * 16777216.0));
  f.keep_rcp = 1.0 / static_cast<double>(keep_div);
  f.hash_b0 = hash_b0;
  f.hash_h0 = hash_h0;
  f.hash_heads = hash_heads;
  return f;
}

// The seed of a call with dropout, read once by each thread at the start
// of a kernel body (little-endian: the low word of an int64 comes first).
__device__ __forceinline__ void load_seed(Features& f) {
  f.seed = *f.seed_ptr;
}

// The Pallas kernels' counter hash (_dropout_uniform), bit for bit, over
// (seed, head, q position, key position), all uint32 with wrapping
// products; `head` is the flattened b * H + q head (`global_head`: of the
// global batch and heads) and the positions are
// absolute, so the keep-mask depends on neither the tiling nor the kernel.
// It is split for a tile: `qh` = q position x 0x9E3779B1 and `kh` = key
// position x 0x85EBCA77 (once per row and per column), `sh` = seed + head
// x 0x27D4EB2F (once per head).  The uniform u = (x >> 8) 2^-24 is exact,
// so the keep test u >= p holds exactly when (x >> 8) >= ceil(p 2^24).
__device__ __forceinline__ uint32_t hash_q(int qp) {
  return static_cast<uint32_t>(qp) * 0x9E3779B1u;
}
__device__ __forceinline__ uint32_t hash_k(int kp) {
  return static_cast<uint32_t>(kp) * 0x85EBCA77u;
}
// The hash's head index of batch row b, q head h of a call.
__device__ __forceinline__ uint32_t global_head(const Features& f, int b,
                                                int h) {
  return static_cast<uint32_t>(b + f.hash_b0) *
             static_cast<uint32_t>(f.hash_heads) +
         static_cast<uint32_t>(f.hash_h0 + h);
}
__device__ __forceinline__ uint32_t hash_head(const Features& f,
                                              uint32_t head) {
  return f.seed + head * 0x27D4EB2Fu;
}
__device__ __forceinline__ bool kept_split(const Features& f, uint32_t sh,
                                           uint32_t qh, uint32_t kh) {
  uint32_t x = (qh + kh) ^ sh;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  return (x >> 8) >= f.keep_min;
}

// Whether dropout keeps the score at (head, qp, kp): u >= p.
__device__ __forceinline__ bool kept(const Features& f, uint32_t head,
                                     int qp, int kp) {
  return kept_split(f, hash_head(f, head), hash_q(qp), hash_k(kp));
}

// A kept value divided by c = (float)(1 - p) and rounded once, a dropped
// one 0, as the Pallas kernels do; computed as one product in double, bit
// for bit __fdiv_rn(x, c).  The exact quotient of two floats is never a
// midpoint of two floats (that would take an odd 25-bit significand times
// c's to fit in 24 bits) and lies at least 2^-49 (relative) from one; x
// times 1 / c rounded to double is within 2^-52 of it, so rounding that
// to float rounds the quotient correctly, subnormal quotients and
// overflow included (the double neither overflows nor goes subnormal).
// tests/test_torch_cuda.py holds it against IEEE division bit for bit.
__device__ __forceinline__ float survivor(const Features& f, bool keep,
                                          float x) {
  return keep ? __double2float_rn(static_cast<double>(x) * f.keep_rcp)
              : 0.f;
}

// Dropout of `x` at (head, qp, kp).
__device__ __forceinline__ float dropped(const Features& f, uint32_t head,
                                         int qp, int kp, float x) {
  return survivor(f, kept(f, head, qp, kp), x);
}

// The scaled score `x` of a live pair (both positions inside S, causally
// visible) of batch b, q head h under the mask and segments, in the
// Pallas order: NEG_INF where the segments differ, then + the mask.
__device__ __forceinline__ float feature_score(const Features& f, float x,
                                               int b, int h, int S, int qp,
                                               int kp) {
  if (f.seg != nullptr) {
    const int* sb = f.seg + static_cast<int64_t>(b) * S;
    if (sb[qp] != sb[kp]) x = kNegInf;
  }
  if (f.mask != nullptr)
    x += f.mask[b * f.mask_b + h * f.mask_h + qp * f.mask_q + kp];
  return x;
}

// Fully masked rows (mask or segments only): where the score sits at
// NEG_INF the probability is 0, not exp(0) against a NEG_INF max or lse.
__device__ __forceinline__ float guard(float p, float x) {
  return x > kNegInf * 0.5f ? p : 0.f;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it has
// to ask).  Callers keep the result in a function-local static, so the
// attribute is set once per kernel, outside any CUDA-graph capture that
// follows.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
}  // namespace ptt
