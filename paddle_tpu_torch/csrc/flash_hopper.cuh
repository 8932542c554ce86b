// The pieces that the warp-specialised flash kernels (wgmma bodies of
// flash_attention_fwd.cu and flash_attention_bwd.cu, 16-bit D 64 and 128)
// share on top of hopper.cuh: the roles of a block's warpgroups, the TMA
// element types, the 1024-byte-aligned dynamic shared memory, the store of
// a 64-row accumulator through a swizzled tile in 16-byte rows, the
// dropout keep bits of a thread's scores, and the host-side tensor maps of
// a [B, heads, S, D] view and of the fp32 mask.
#pragma once

#include <cstring>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace ptt {
namespace flash {

namespace hw = ptt::hopper;

// Three warpgroups: a producer (one warp issues every copy; the group
// gives its registers to the others) and two consumers of 64 rows each.
constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kWgmmaThreads = 3 * kWg;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPanelBytes = 128;           // one swizzled row of a panel

template <typename T>
struct Tma;
template <>
struct Tma<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Tma<__half> {
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// The dynamic shared memory of a block, its shared address rounded up to
// 1024 bytes (the 128-byte swizzle's period); 1 KB more is allocated.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (hw::smem_u32(raw) & 1023u)) & 1023u;
  return raw + pad;
}

// Rows `r` and `r + 8` of one thread's 64 x D accumulator, rounded once
// to T, into `stage` (the group's 64 rows of a swizzled tile, panels
// `panel` bytes apart), then rows row0.. (< S) of `out` (row stride `ld`
// elements) by 16-byte stores.  Barrier `bar` syncs the warpgroup.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           unsigned char* stage,
                                           uint32_t panel, T* out,
                                           int64_t ld, int row0, int S,
                                           int bar) {
  const int t = threadIdx.x % kWg, warp = t >> 5, lane = t & 31;
  const int r = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(
        stage + hw::swizzled_offset(r, 8 * j + c0, panel)) =
        Mma<T>::pack(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(
        stage + hw::swizzled_offset(r + 8, 8 * j + c0, panel)) =
        Mma<T>::pack(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hw::named_sync(bar, kWg);
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  for (int i = t; i < 64 * kChunks; i += kWg) {
    const int rr = i / kChunks, cc = i - rr * kChunks;
    if (row0 + rr < S)
      *reinterpret_cast<uint4*>(out + (row0 + rr) * ld + cc * 8) =
          *reinterpret_cast<const uint4*>(
              stage + hw::swizzled_offset(rr, cc * 8, panel));
  }
}

// The dropout keep bits of a thread's scores (bit i: accumulator element
// i), the forward's hash at (b * H + q head, q position, key position):
// `hashes(i, qh, kh)` gives element i's split hash of its q and key
// positions (`kept_split`), `sh` the head's.
template <int N, typename Hashes>
__device__ __forceinline__ uint32_t keep_bits(const Features& f, uint32_t sh,
                                              Hashes hashes) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t qh, kh;
    hashes(i, qh, kh);
    bits |= static_cast<uint32_t>(kept_split(f, sh, qh, kh)) << i;
  }
  return bits;
}

// The TMA map of a 16-bit [B, heads, S, D] view (element strides `st`),
// boxes of 64 columns x `rows` rows in the 128-byte swizzle.
template <typename T>
cudaError_t head_map(CUtensorMap* map, const void* p, const Strides& st,
                     int b, int heads, int s, int d, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st.s) * sizeof(T),
                               static_cast<uint64_t>(st.h) * sizeof(T),
                               static_cast<uint64_t>(st.b) * sizeof(T)};
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return hw::tensor_map_4d(map, Tma<T>::kType, sizeof(T), p, dims, strides,
                           box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The TMA map of the fp32 mask [B|1, H|1, S, S] (a broadcast dim has
// stride 0 and size 1), boxes of `keys` x `rows`; no mask: zeros.
inline cudaError_t mask_map(CUtensorMap* map, const Features& f, int b, int h,
                     int s, int keys, int rows) {
  if (f.mask == nullptr) {
    memset(map, 0, sizeof(*map));
    return cudaSuccess;
  }
  const uint64_t dims[4] = {static_cast<uint64_t>(s),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(f.mask_h ? h : 1),
                            static_cast<uint64_t>(f.mask_b ? b : 1)};
  const uint64_t strides[3] = {static_cast<uint64_t>(f.mask_q) * 4,
                               static_cast<uint64_t>(f.mask_h) * 4,
                               static_cast<uint64_t>(f.mask_b) * 4};
  const uint32_t box[4] = {static_cast<uint32_t>(keys),
                           static_cast<uint32_t>(rows), 1, 1};
  return hw::tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, f.mask,
                           dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace flash
}  // namespace ptt
