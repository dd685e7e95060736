// Masked ligand<->receptor cross-attention, backward: dQ, and dK with dV.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// equidock_public_tpu/ops/pallas/cross_attention.py (called through
// `_bwd_call` / `_vjp_bwd`). With the forward's logits
//   mask = (q_tag[n] > 0) & (q_tag[n] == k_tag[m]),
//   a    = mask * (q_n . k_m) - 1000 * (1 - mask),
// the saved lse_n = logsumexp_m(a), the output cotangent dO and
// delta_n = rowsum(dO_n * O_n) (taken outside, as in the JAX package):
//   w    = exp(a - lse_n)
//   ds   = w * (dO_n . v_m - delta_n) * mask
//   dQ_n = sum_m ds k_m,   dK_m = sum_n ds q_n,   dV_m = sum_n w dO_n.
// Keys run over exactly m < M, as in the forward. Padded query rows (tag 0)
// have mask 0 everywhere: they add nothing to dQ or dK, but still add
// w dO_n to dV, exactly as the formula says.
//
// Bound on an H100 at the training batch (B = 10, N = M = 512, D = Dv = 64,
// 70-274 valid nodes a side, about 11% of the pairs kept): dQ needs
// 2 (2D + Dv) and dK/dV 2 (2D + 2Dv) f32 operations a kept pair, plus
// w dO for the keys of rows that keep none; each kernel moves under 10 MB.
// dQ is bound by bytes at about 2 us, dK/dV by operations at about 6 us.
// The logits are recomputed in each kernel instead of being stored.
//
// Both kernels use the forward's tile design (csrc/cross_attention.cu,
// csrc/attention_tiles.cuh): 64-row tiles of queries and keys, a (query
// tile, key tile) pair tested from the tags in global memory before it is
// staged (att::may_keep), 4 x 4 register-blocked f32 products from shared
// memory, and a split of the walked axis whose partial sums a combine
// kernel adds in split order. No atomics: two launches give the same bits.
// All in f32 FMA, no TF32; widths pad to DP = 16, 64, 72 or 96 (72 for
// layer 0).
//
// dQ (`cross_attention_dq_kernel`), query-stationary: a block owns one
// 64-row query tile and one split of the key tiles. A tile pair that keeps
// no (query, key) pair has ds = 0 on every pair and adds exactly nothing to
// dQ, so the block skips it unstaged; a query tile with no positive tag
// stages nothing and writes a zero partial. The block stages its Q, dO,
// query tags, lse and delta once, with the first key tile that may keep a
// pair, and walks those key tiles through a two-stage cp.async ring (K, V
// and the key tags). For each: S = Q K^T and dP = dO V^T as 4 x 4 register
// blocks, ds = keep ? w (dP - delta) : 0 with the per-pair mask through
// shared memory, then dQ += ds K, 4 queries x DP/16 channels a thread.
// The key tiles are dealt to the splits in turn, so the tiles that keep
// pairs (the valid keys sit at the front) spread over all splits; on an
// H100 this was faster than contiguous runs at 2-4 splits.
//
// dK/dV (`cross_attention_dkv_kernel`), key-stationary: a block owns one
// 64-key tile and one split of the query tiles, which it walks through a
// two-stage cp.async ring (dO and lse for a query tile that keeps nothing
// with the key tile; Q, tags and delta too for the others, and, with the
// first of them, the key and value rows). For each query tile:
//  - if no (query, key) pair of the two tiles can be kept, ds = 0, so dK
//    gets nothing, and every key of the tile gets the same dV term
//    u = sum_n exp(-1000 - lse_n) dO_n (1/M dO_n on padded rows, 0 on rows
//    that keep a logit well above -1000): each thread adds its share of u
//    over 4 rows, and the 16 shares meet once at the end, in a fixed order;
//  - else S = K Q^T and dP = V dO^T as 4 x 4 register blocks, P and ds
//    with the per-pair mask go through shared memory, and dV += P dO,
//    dK += ds Q, 4 keys x DP/16 channels a thread.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

// Shared memory (floats) of the dQ kernel: the query and dO tiles, two
// stages of key and value tiles, ds [64 queries][64 keys], the query tags,
// lse, delta and two stages of key tags.
__host__ __device__ constexpr int dq_smem_floats(int DP) {
  return 6 * att::kTile * att::stride_of(DP) + att::kTile * att::stride_of(att::kTile) +
         5 * att::kTile;
}

template <int DP>
__global__ void __launch_bounds__(att::kThreads)
cross_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ q_tag,
                          const float* __restrict__ k_tag, const float* __restrict__ lse,
                          const float* __restrict__ dout, const float* __restrict__ delta,
                          float* __restrict__ part, int N, int M, int D, int Dv, bool vec_qk,
                          bool vec_o) {
  constexpr int T = att::kTile, R = att::kSub;
  constexpr int S = att::stride_of(DP), SP = att::stride_of(att::kTile);
  constexpr int CJ = att::col_groups(DP);
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [64][S] query rows
  float* sO = sQ + T * S;              // [64][S] dO rows
  float* sK = sO + T * S;              // [2][64][S] key rows
  float* sV = sK + 2 * T * S;          // [2][64][S] value rows
  float* sG = sV + 2 * T * S;          // [64 queries][SP] ds
  float* sQt = sG + T * SP;            // [64] query tags
  float* sL = sQt + T;                 // [64] lse
  float* sDl = sL + T;                 // [64] delta
  float* sKt = sDl + T;                // [2][64] key tags

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int n0 = blockIdx.x * T;
  const int key_tiles = (M + T - 1) / T;
  q += (size_t)b * N * D;
  dout += (size_t)b * N * Dv;
  q_tag += (size_t)b * N;
  lse += (size_t)b * N;
  delta += (size_t)b * N;
  k += (size_t)b * M * D;
  v += (size_t)b * M * Dv;
  k_tag += (size_t)b * M;

  // A key tile that keeps no (query, key) pair with the query tile has
  // ds = 0 on every pair, so it adds nothing to dQ: the block tests each
  // tile from the tags in global memory and stages only those that may keep
  // something. A query tile with no positive tag stages nothing at all.
  const att::TagRange q_range = att::tag_range(q_tag, n0, N);
  auto next_kept = [&](int t) {
    while (t < key_tiles && !att::may_keep(q_range, att::tag_range(k_tag, t * T, M)))
      t += splits;
    return t;
  };
  auto stage_keys = [&](int t, int stage_idx) {
    att::stage_tile<DP>(sK + stage_idx * T * S, k, t * T, M, D, vec_qk);
    att::stage_tile<DP>(sV + stage_idx * T * S, v, t * T, M, Dv, vec_o);
    att::stage_vec(sKt + stage_idx * T, k_tag, t * T, M);
    att::cp_async_commit();
  };

  float acc[R][CJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // The key tiles are dealt to the splits in turn (split s takes tiles s,
  // s + splits, ...): the valid keys sit at the front of each protein, so
  // contiguous runs would leave the tiles that keep pairs to the first splits.
  int t = q_range.lo <= q_range.hi ? next_kept(split) : key_tiles;
  if (t < key_tiles) {
    att::stage_tile<DP>(sQ, q, n0, N, D, vec_qk);
    att::stage_tile<DP>(sO, dout, n0, N, Dv, vec_o);
    att::stage_vec(sQt, q_tag, n0, N);
    att::stage_vec(sL, lse, n0, N);
    att::stage_vec(sDl, delta, n0, N);
    stage_keys(t, 0);
  }
  for (int buf = 0; t < key_tiles; buf ^= 1) {
    const int next = next_kept(t + splits);
    if (next < key_tiles) {
      stage_keys(next, buf ^ 1);
      att::cp_async_wait<1>();
    } else {
      att::cp_async_wait<0>();
    }
    __syncthreads();
    const float* tK = sK + buf * T * S;
    const float* tV = sV + buf * T * S;
    const float* tKt = sKt + buf * T;

    // S = Q K^T and dP = dO V^T: queries ty * 4 + i, keys tx + 16 j.
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qa[R], kb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qa[i] = att::ld4(sQ + (ty * R + i) * S + d);
#pragma unroll
      for (int j = 0; j < R; ++j) kb[j] = att::ld4(tK + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = att::dot4(qa[i], kb[j], s[i][j]);
    }
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 oa[R], vb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) oa[i] = att::ld4(sO + (ty * R + i) * S + d);
#pragma unroll
      for (int j = 0; j < R; ++j) vb[j] = att::ld4(tV + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) dp[i][j] = att::dot4(oa[i], vb[j], dp[i][j]);
    }
    // ds with the per-pair mask (rows past N and keys past M have tag 0).
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int nl = ty * R + i;
      const float qt = sQt[nl], ls = sL[nl], dl = sDl[nl];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool keep = qt > 0.f && qt == tKt[tx + 16 * j];
        sG[nl * SP + tx + 16 * j] = keep ? expf(s[i][j] - ls) * (dp[i][j] - dl) : 0.f;
      }
    }
    __syncthreads();
    // dQ += ds K: queries ty * 4 + i, channels tx + 16 j.
#pragma unroll 2
    for (int c = 0; c < T; c += 4) {
      float4 g[R];
#pragma unroll
      for (int i = 0; i < R; ++i) g[i] = att::ld4(sG + (ty * R + i) * SP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float kk[CJ];
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          kk[j] = att::owns_col<DP>(j, tx) ? tK[(c + cc) * S + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float gi = att::lane4(g[i], cc);
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(gi, kk[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                     // this stage and sG are free again
    t = next;
  }

  const size_t slot = (size_t)b * splits + split;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int n = n0 + ty * R + i;
    if (n >= N) continue;
    const size_t row = slot * N + n;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) part[row * D + c] = acc[i][j];
    }
  }
}

// One thread per (b, n, channel): the splits of dQ summed in order.
__global__ void cross_attention_dq_combine_kernel(const float* __restrict__ part,
                                                  float* __restrict__ dq, int B, int N, int D,
                                                  int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * N * D) return;
  const size_t row = idx / D;
  const float* p = part + ((row / N) * splits * N + row % N) * D + idx % D;
  const size_t step = (size_t)N * D;           // from one split to the next
  float s = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) s += p[sp * step];
  dq[idx] = s;
}

// Shared memory (floats) of the dK/dV kernel: the key and value tiles, two
// stages of query and dO tiles, P and ds [64 keys][64 queries], the key
// tags, two stages of query tags, lse and delta.
__host__ __device__ constexpr int dkv_smem_floats(int DP) {
  return 6 * att::kTile * att::stride_of(DP) + 2 * att::kTile * att::stride_of(att::kTile) +
         7 * att::kTile;
}

template <int DP>
__global__ void __launch_bounds__(att::kThreads)
cross_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ q_tag,
                           const float* __restrict__ k_tag, const float* __restrict__ lse,
                           const float* __restrict__ dout, const float* __restrict__ delta,
                           float* __restrict__ part_k, float* __restrict__ part_v, int N,
                           int M, int D, int Dv, int tiles_per_split, bool vec_qk,
                           bool vec_o) {
  constexpr int T = att::kTile, R = att::kSub;
  constexpr int S = att::stride_of(DP), SP = att::stride_of(att::kTile);
  constexpr int CJ = att::col_groups(DP);
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                    // [64][S] key rows
  float* sV = sK + T * S;              // [64][S] value rows
  float* sQ = sV + T * S;              // [2][64][S] query rows
  float* sO = sQ + 2 * T * S;          // [2][64][S] dO rows
  float* sP = sO + 2 * T * S;          // [64 keys][SP] w
  float* sG = sP + T * SP;             // [64 keys][SP] ds
  float* sKt = sG + T * SP;            // [64] key tags
  float* sQt = sKt + T;                // [2][64] query tags
  float* sL = sQt + 2 * T;             // [2][64] lse
  float* sDl = sL + 2 * T;             // [2][64] delta

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int m0 = blockIdx.x * T;
  const int query_tiles = (N + T - 1) / T;
  int t0, t1;
  att::split_range(split, tiles_per_split, query_tiles, &t0, &t1);
  q += (size_t)b * N * D;
  dout += (size_t)b * N * Dv;
  q_tag += (size_t)b * N;
  lse += (size_t)b * N;
  delta += (size_t)b * N;
  k += (size_t)b * M * D;
  v += (size_t)b * M * Dv;
  k_tag += (size_t)b * M;

  // Each query tile's test comes from the tags in global memory before the
  // tile is staged: a tile that keeps nothing with the key tile stages only
  // dO and lse, and the key tile is staged with the first tile that may
  // keep something.
  const att::TagRange k_range = att::tag_range(k_tag, m0, M);
  bool k_staged = false;
  auto stage = [&](int t, int stage_idx, bool mixed) {
    if (mixed && !k_staged) {
      att::stage_tile<DP>(sK, k, m0, M, D, vec_qk);
      att::stage_tile<DP>(sV, v, m0, M, Dv, vec_o);
      att::stage_vec(sKt, k_tag, m0, M);
      k_staged = true;
    }
    if (mixed) {
      att::stage_tile<DP>(sQ + stage_idx * T * S, q, t * T, N, D, vec_qk);
      att::stage_vec(sQt + stage_idx * T, q_tag, t * T, N);
      att::stage_vec(sDl + stage_idx * T, delta, t * T, N);
    }
    att::stage_tile<DP>(sO + stage_idx * T * S, dout, t * T, N, Dv, vec_o);
    att::stage_vec(sL + stage_idx * T, lse, t * T, N);
    att::cp_async_commit();
  };
  bool mixed = att::may_keep(att::tag_range(q_tag, t0 * T, N), k_range);
  stage(t0, 0, mixed);

  float acc_k[R][CJ], acc_v[R][CJ], u[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    u[j] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    bool next_mixed = false;
    if (t + 1 < t1) {
      next_mixed = att::may_keep(att::tag_range(q_tag, (t + 1) * T, N), k_range);
      stage(t + 1, buf ^ 1, next_mixed);
      att::cp_async_wait<1>();
    } else {
      att::cp_async_wait<0>();
    }
    __syncthreads();
    const float* tQ = sQ + buf * T * S;
    const float* tO = sO + buf * T * S;
    const float* tQt = sQt + buf * T;
    const float* tL = sL + buf * T;
    const float* tDl = sDl + buf * T;
    const int n0 = t * T;

    if (!mixed) {
      // ds = 0; every key gets u = sum_n exp(-1000 - lse_n) dO_n: this
      // thread's share over rows ty * 4 + i.
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int nl = ty * R + i;
        const float w = n0 + nl < N ? expf(att::kMasked - tL[nl]) : 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          if (att::owns_col<DP>(j, tx)) u[j] = fmaf(w, tO[nl * S + tx + 16 * j], u[j]);
      }
    } else {
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 ka[R], qb[R];
#pragma unroll
        for (int i = 0; i < R; ++i) ka[i] = att::ld4(sK + (ty * R + i) * S + d);
#pragma unroll
        for (int j = 0; j < R; ++j) qb[j] = att::ld4(tQ + (tx + 16 * j) * S + d);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = att::dot4(ka[i], qb[j], s[i][j]);
      }
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 va[R], ob[R];
#pragma unroll
        for (int i = 0; i < R; ++i) va[i] = att::ld4(sV + (ty * R + i) * S + d);
#pragma unroll
        for (int j = 0; j < R; ++j) ob[j] = att::ld4(tO + (tx + 16 * j) * S + d);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) dp[i][j] = att::dot4(va[i], ob[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float kt = sKt[ty * R + i];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int nl = tx + 16 * j;
          const float qt = tQt[nl];
          const bool keep = qt > 0.f && qt == kt;      // rows past N have tag 0
          const float w =
              n0 + nl < N ? expf((keep ? s[i][j] : att::kMasked) - tL[nl]) : 0.f;
          sP[(ty * R + i) * SP + nl] = w;
          sG[(ty * R + i) * SP + nl] = keep ? w * (dp[i][j] - tDl[nl]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < T; c += 4) {
        float4 pw[R], pg[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pw[i] = att::ld4(sP + (ty * R + i) * SP + c);
          pg[i] = att::ld4(sG + (ty * R + i) * SP + c);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float oo[CJ], qq[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const bool own = att::owns_col<DP>(j, tx);
            oo[j] = own ? tO[(c + cc) * S + tx + 16 * j] : 0.f;
            qq[j] = own ? tQ[(c + cc) * S + tx + 16 * j] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float wi = att::lane4(pw[i], cc), gi = att::lane4(pg[i], cc);
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
              acc_v[i][j] = fmaf(wi, oo[j], acc_v[i][j]);
              acc_k[i][j] = fmaf(gi, qq[j], acc_k[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();                     // this stage and sP / sG are free again
    mixed = next_mixed;
  }

  // u: the 16 row groups' shares, summed in order, added to every key's dV.
  float* sU = sP;                        // [16][DP]
#pragma unroll
  for (int j = 0; j < CJ; ++j)
    if (att::owns_col<DP>(j, tx)) sU[ty * DP + tx + 16 * j] = u[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    if (!att::owns_col<DP>(j, tx)) continue;
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) total += sU[g * DP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i) acc_v[i][j] += total;
  }

  const size_t slot = (size_t)b * splits + split;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty * R + i;
    if (m >= M) continue;
    const size_t row = slot * M + m;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) part_k[row * D + c] = acc_k[i][j];
      if (c < Dv) part_v[row * Dv + c] = acc_v[i][j];
    }
  }
}

// One thread per (b, m, channel of dK then dV): the splits summed in order.
__global__ void cross_attention_dkv_combine_kernel(const float* __restrict__ part_k,
                                                   const float* __restrict__ part_v,
                                                   float* __restrict__ dk,
                                                   float* __restrict__ dv, int B, int M,
                                                   int D, int Dv, int splits) {
  const int W = D + Dv;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * M * W) return;
  const size_t row = idx / W;
  const int c = (int)(idx % W);
  const bool is_k = c < D;
  const int width = is_k ? D : Dv, cc = is_k ? c : c - D;
  const float* part = (is_k ? part_k : part_v) + ((row / M) * splits * M + row % M) * width + cc;
  const size_t step = (size_t)M * width;          // from one split to the next
  float s = 0.f;
#pragma unroll 4
  for (int p = 0; p < splits; ++p) s += part[p * step];
  (is_k ? dk : dv)[row * width + cc] = s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <int DP>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* q_tag,
                      const float* k_tag, const float* lse, const float* dout,
                      const float* delta, float* part, int B, int N, int M, int D, int Dv,
                      int splits, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dq_smem_floats(DP);
  static bool configured = false;
  cudaError_t err = allow_smem(cross_attention_dq_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  if (splits > (M + att::kTile - 1) / att::kTile) return cudaErrorInvalidValue;  // an empty split
  const dim3 grid((N + att::kTile - 1) / att::kTile, splits, B);
  cross_attention_dq_kernel<DP><<<grid, att::kThreads, smem, stream>>>(
      q, k, v, q_tag, k_tag, lse, dout, delta, part, N, M, D, Dv,
      att::vec_ok(q, D) && att::vec_ok(k, D), att::vec_ok(v, Dv) && att::vec_ok(dout, Dv));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* q_tag,
                       const float* k_tag, const float* lse, const float* dout,
                       const float* delta, float* part_k, float* part_v, int B, int N, int M,
                       int D, int Dv, int splits, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dkv_smem_floats(DP);
  static bool configured = false;
  cudaError_t err = allow_smem(cross_attention_dkv_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int query_tiles = (N + att::kTile - 1) / att::kTile;
  const int per_split = (query_tiles + splits - 1) / splits;
  if ((splits - 1) * per_split >= query_tiles) return cudaErrorInvalidValue;  // an empty split
  const dim3 grid((M + att::kTile - 1) / att::kTile, splits, B);
  cross_attention_dkv_kernel<DP><<<grid, att::kThreads, smem, stream>>>(
      q, k, v, q_tag, k_tag, lse, dout, delta, part_k, part_v, N, M, D, Dv, per_split,
      att::vec_ok(q, D) && att::vec_ok(k, D), att::vec_ok(v, Dv) && att::vec_ok(dout, Dv));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays: q (B, N, D), k (B, M, D),
// v (B, M, Dv), q_tag (B, N), k_tag (B, M), lse (B, N) from the forward,
// dout (B, N, Dv), delta (B, N); scratch part (B, splits, N, D): each
// split's partial dQ. The key tiles are dealt to the `splits` splits in
// turn; splits <= the number of key tiles. D, Dv <= 96. Returns the
// cudaError_t of the launch.
int equidock_cross_attention_dq(const void* q, const void* k, const void* v,
                                const void* q_tag, const void* k_tag, const void* lse,
                                const void* dout, const void* delta, void* part, int B,
                                int N, int M, int D, int Dv, int splits, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || Dv <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int w = D > Dv ? D : Dv;
#define DQ_ARGS                                                                    \
  (const float*)q, (const float*)k, (const float*)v, (const float*)q_tag,          \
      (const float*)k_tag, (const float*)lse, (const float*)dout,                  \
      (const float*)delta, (float*)part, B, N, M, D, Dv, splits, (cudaStream_t)stream
  if (w <= 16) return (int)launch_dq<16>(DQ_ARGS);
  if (w <= 64) return (int)launch_dq<64>(DQ_ARGS);
  if (w <= 72) return (int)launch_dq<72>(DQ_ARGS);
  if (w <= 96) return (int)launch_dq<96>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

// The dQ backward's second pass: dq (B, N, D), the splits' partials summed
// in split order.
int equidock_cross_attention_dq_combine(const void* part, void* dq, int B, int N, int D,
                                        int splits, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * N * D;
  const int threads = 256;
  cross_attention_dq_combine_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                                      (cudaStream_t)stream>>>((const float*)part, (float*)dq,
                                                              B, N, D, splits);
  return (int)cudaGetLastError();
}

// As above; scratch part_k (B, splits, M, D) and part_v (B, splits, M, Dv):
// each split's partial dK and dV. The query tiles are cut into `splits`
// runs of equal length, none empty.
int equidock_cross_attention_dkv(const void* q, const void* k, const void* v,
                                 const void* q_tag, const void* k_tag, const void* lse,
                                 const void* dout, const void* delta, void* part_k,
                                 void* part_v, int B, int N, int M, int D, int Dv, int splits,
                                 void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || Dv <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int w = D > Dv ? D : Dv;
#define DKV_ARGS                                                                   \
  (const float*)q, (const float*)k, (const float*)v, (const float*)q_tag,          \
      (const float*)k_tag, (const float*)lse, (const float*)dout,                  \
      (const float*)delta, (float*)part_k, (float*)part_v, B, N, M, D, Dv, splits, \
      (cudaStream_t)stream
  if (w <= 16) return (int)launch_dkv<16>(DKV_ARGS);
  if (w <= 64) return (int)launch_dkv<64>(DKV_ARGS);
  if (w <= 72) return (int)launch_dkv<72>(DKV_ARGS);
  if (w <= 96) return (int)launch_dkv<96>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}

// The dK/dV backward's second pass: dk (B, M, D) and dv (B, M, Dv), the
// splits' partials summed in split order.
int equidock_cross_attention_dkv_combine(const void* part_k, const void* part_v, void* dk,
                                         void* dv, int B, int M, int D, int Dv, int splits,
                                         void* stream) {
  if (B <= 0 || M <= 0 || D <= 0 || Dv <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * M * (D + Dv);
  const int threads = 256;
  cross_attention_dkv_combine_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                                       (cudaStream_t)stream>>>(
      (const float*)part_k, (const float*)part_v, (float*)dk, (float*)dv, B, M, D, Dv, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
