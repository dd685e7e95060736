// Tile pieces shared by the cross-attention forward (cross_attention.cu) and
// its dK/dV backward (cross_attention_bwd.cu).
//
// Both kernels cut queries and keys into tiles of kTile rows and stage the
// tiles into shared memory with cp.async (16-byte copies where a matrix's
// width is a multiple of 4 floats and its base is 16-byte aligned, 4-byte
// copies otherwise; rows past the matrix and columns past its width are
// filled with zeros by the copy itself). A block of kThreads threads is a
// 16 x 16 grid: thread (ty, tx) owns rows ty * 4 + i and columns tx + 16 j
// of every 64 x 64 product, so one operand read from shared memory feeds
// four rows or four columns.
//
// A (query tile, key tile) pair keeps no (query, key) pair when the positive
// tags of the two tiles cannot meet: `may_keep` tests whether the ranges
// [min, max] of the positive tags overlap, a conservative test (a pair it
// passes may still keep nothing, and then takes the full product with the
// per-pair mask, which is exact either way). The test reads the tags from
// global memory, so a block stages only what a tile pair needs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace att {

constexpr int kTile = 64;       // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kSub = 4;         // rows a thread owns in a tile product
constexpr float kMasked = -1000.f;

// Row stride in floats of a tile DP floats wide: a multiple of 4, so rows
// start on 16 bytes, and an odd number of 16-byte words, so 8 threads
// reading float4s of 8 consecutive rows hit 32 distinct banks.
__host__ __device__ constexpr int stride_of(int DP) { return DP + 4; }

// Output columns tx + 16 j of a DP-wide row that a thread owns.
__host__ __device__ constexpr int col_groups(int DP) { return (DP + 15) / 16; }

template <int DP>
__device__ __forceinline__ bool owns_col(int j, int tx) {
  return j < col_groups(DP) - 1 || DP % 16 == 0 || tx < DP % 16;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Rows [r0, r0 + kTile) of a (rows, width) matrix into dst [kTile][stride],
// columns [0, DP); zeros past `rows` and past `width`.
template <int DP>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int r0,
                                           int rows, int width, bool vec) {
  constexpr int S = stride_of(DP);
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = threadIdx.x; i < kTile * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4, g = r0 + r;
      const bool in = g < rows && c < width;
      cp_async16(dst + r * S + c, in ? src + (size_t)g * width + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, g = r0 + r;
      const bool in = g < rows && c < width;
      cp_async4(dst + r * S + c, in ? src + (size_t)g * width + c : src, in ? 4 : 0);
    }
  }
}

// Entries [r0, r0 + kTile) of a vector of length `rows` (zeros past it).
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src, int r0,
                                          int rows) {
  if (threadIdx.x < kTile) {
    const int g = r0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, g < rows ? src + g : src, g < rows ? 4 : 0);
  }
}

// [lo, hi] of the positive tags among entries [r0, r0 + kTile) of a tag
// vector of length `rows` (lo > hi: none), the same in every lane of the
// calling warp. Read straight from global memory, so a block decides what to
// stage before it stages it.
struct TagRange {
  float lo, hi;
};

__device__ __forceinline__ TagRange tag_range(const float* __restrict__ tags, int r0, int rows) {
  const int lane = threadIdx.x & 31;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = lane; i < kTile; i += 32) {
    const float t = r0 + i < rows ? __ldg(tags + r0 + i) : 0.f;
    if (t > 0.f) {
      lo = fminf(lo, t);
      hi = fmaxf(hi, t);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return {lo, hi};
}

__device__ __forceinline__ bool may_keep(TagRange a, TagRange b) {
  return a.lo <= a.hi && b.lo <= b.hi && a.lo <= b.hi && b.lo <= a.hi;
}

// Reductions over the 16 threads (tx) that share a row ty.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float lane4(float4 a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// Tiles a block walks: split s of `splits` over `tiles` tiles, in order.
__device__ __forceinline__ void split_range(int s, int tiles_per_split, int tiles, int* t0,
                                            int* t1) {
  *t0 = s * tiles_per_split;
  *t1 = min(*t0 + tiles_per_split, tiles);
}

// 16-byte copies are allowed for a matrix of this width at this address.
inline bool vec_ok(const void* p, int width) {
  return width % 4 == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace att
