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
// Both are bound by operations, at 2-6 us. The logits are recomputed in
// each kernel instead of being stored.
//
// dQ (`cross_attention_dq_kernel`): a block owns kRows query rows (q and dO
// rows staged in shared memory), its kWarps warps split the keys in 32-key
// chunks; per chunk each lane holds one key row, then one value row, in
// registers and scores them against the block's rows (broadcast reads),
// giving ds for 32 keys at once; then the warp walks the chunk's keys,
// reading each key row from global memory (coalesced) and adding ds * k
// into per-lane channel accumulators. The kWarps partial sums of each row
// meet in shared memory in a fixed order. Widths up to DP = 64 or 96 lanes.
//
// dK/dV (`cross_attention_dkv_kernel`), the forward's tile design
// (csrc/cross_attention.cu, csrc/attention_tiles.cuh) turned key-stationary:
// a block owns one 64-key tile and one split of the query tiles, which it
// tests from the tags in global memory and walks through a two-stage
// cp.async ring (dO and lse for a query tile that keeps nothing with the key
// tile; Q, tags and delta too for the others, and, with the first of them,
// the key and value rows). For each query tile:
//  - if no (query, key) pair of the two tiles can be kept (att::may_keep),
//    ds = 0, so dK gets nothing, and every key of the tile gets the same
//    dV term u = sum_n exp(-1000 - lse_n) dO_n (1/M dO_n on padded rows, 0
//    on rows that keep a logit well above -1000): each thread adds its
//    share of u over 4 rows, and the 16 shares meet once at the end, in a
//    fixed order;
//  - else S = K Q^T and dP = V dO^T as 4 x 4 register blocks, P and ds
//    with the per-pair mask go through shared memory, and dV += P dO,
//    dK += ds Q, 4 keys x DP/16 channels a thread.
// Each block writes its keys' partial dK and dV to a scratch slot of its
// split; the combine kernel sums the splits in split order. No atomics: two
// launches give the same bits. All in f32 FMA, no TF32; widths pad to
// DP = 16, 64, 72 or 96 (72 for layer 0).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

// The dQ kernel's layout.
constexpr int kRows = 4;                  // query rows a block owns
constexpr int kWarps = 8;                 // warps per block, splitting the keys
constexpr int kThreads = 32 * kWarps;

// Shared memory: the block's rows twice ([2][kRows][DP]: q and dO), then
// per warp a chunk [32][DP + 1] (padded: 32 lanes reading 32 rows hit 32
// banks). The final merge reuses the chunks.
__host__ __device__ constexpr int smem_floats(int DP) {
  return 2 * kRows * DP + kWarps * 32 * (DP + 1);
}

// Copy rows [r0, r0 + 32) of a (rows, width) matrix into a padded chunk.
template <int DP>
__device__ __forceinline__ void stage_chunk(float* chunk, const float* __restrict__ src,
                                            int r0, int rows, int width, int lane) {
  __syncwarp();        // the warp is done with the chunk's previous contents
  for (int i = lane; i < 32 * DP; i += 32) {
    const int rr = i / DP, d = i % DP, r = r0 + rr;
    chunk[rr * (DP + 1) + d] = r < rows && d < width ? src[(size_t)r * width + d] : 0.f;
  }
  __syncwarp();
}

template <int DP>
__device__ __forceinline__ float dot_row(const float* a, const float (&b)[DP]) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    s0 = fmaf(a[d], b[d], s0);
    s1 = fmaf(a[d + 1], b[d + 1], s1);
    s2 = fmaf(a[d + 2], b[d + 2], s2);
    s3 = fmaf(a[d + 3], b[d + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// Sum the kWarps partial rows acc[kRows][C] of every warp and store row r
// (when r0 + r < rows) to out (rows, width).
template <int DP>
__device__ __forceinline__ void merge_store(float* part, const float (&acc)[kRows][DP / 32],
                                            float* __restrict__ out, int r0, int rows,
                                            int width, int warp, int lane) {
  constexpr int C = DP / 32;
  __syncthreads();     // every warp is done with its chunk
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < C; ++i) part[(warp * kRows + r) * DP + lane + 32 * i] = acc[r][i];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    if (r0 + r >= rows || d >= width) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[(w * kRows + r) * DP + d];
    out[(size_t)(r0 + r) * width + d] = s;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
cross_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ q_tag,
                          const float* __restrict__ k_tag, const float* __restrict__ lse,
                          const float* __restrict__ dout, const float* __restrict__ delta,
                          float* __restrict__ dq, int N, int M, int D, int Dv) {
  extern __shared__ float smem[];
  constexpr int C = DP / 32;
  float* sQ = smem;                        // [kRows][DP]
  float* sO = smem + kRows * DP;           // [kRows][DP] dO rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* chunk = smem + 2 * kRows * DP + warp * 32 * (DP + 1);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  q += (size_t)b * N * D;
  dout += (size_t)b * N * Dv;
  k += (size_t)b * M * D;
  v += (size_t)b * M * Dv;
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, n = row0 + r;
    sQ[i] = n < N && d < D ? q[(size_t)n * D + d] : 0.f;
    sO[i] = n < N && d < Dv ? dout[(size_t)n * Dv + d] : 0.f;
  }
  float qt[kRows], ls[kRows], dl[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool in = row0 + r < N;
    const size_t n = (size_t)b * N + row0 + r;
    qt[r] = in ? q_tag[n] : 0.f;
    ls[r] = in ? lse[n] : 0.f;
    dl[r] = in ? delta[n] : 0.f;
  }
  __syncthreads();

  float acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < C; ++i) acc[r][i] = 0.f;

  for (int j0 = warp * 32; j0 < M; j0 += kWarps * 32) {
    const int j = j0 + lane;
    const bool in = j < M;
    const float kt = in ? k_tag[(size_t)b * M + j] : 0.f;
    float row[DP];
    float s[kRows], ds[kRows];

    stage_chunk<DP>(chunk, k, j0, M, D, lane);
#pragma unroll
    for (int d = 0; d < DP; ++d) row[d] = chunk[lane * (DP + 1) + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dot_row<DP>(sQ + r * DP, row);

    stage_chunk<DP>(chunk, v, j0, M, Dv, lane);
#pragma unroll
    for (int d = 0; d < DP; ++d) row[d] = chunk[lane * (DP + 1) + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dw = dot_row<DP>(sO + r * DP, row);
      const bool mk = in && qt[r] > 0.f && qt[r] == kt;
      const float w = expf((mk ? s[r] : -1000.f) - ls[r]);
      ds[r] = mk ? w * (dw - dl[r]) : 0.f;
    }

    const int nj = min(32, M - j0);
    for (int jj = 0; jj < nj; ++jj) {
      const float* k_row = k + (size_t)(j0 + jj) * D;
      float kk[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int d = lane + 32 * i;
        kk[i] = d < D ? k_row[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int i = 0; i < C; ++i) acc[r][i] = fmaf(dsj, kk[i], acc[r][i]);
      }
    }
  }
  merge_store<DP>(smem + 2 * kRows * DP, acc, dq + (size_t)b * N * D, row0, N, D, warp,
                  lane);
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
                      const float* delta, float* dq, int B, int N, int M, int D, int Dv,
                      cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats(DP);
  static bool configured = false;
  cudaError_t err = allow_smem(cross_attention_dq_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, B);
  cross_attention_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, q_tag, k_tag, lse, dout, delta, dq, N, M, D, Dv);
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
// dout (B, N, Dv), delta (B, N); output dq (B, N, D). D, Dv <= 96.
// Returns the cudaError_t of the launch.
int equidock_cross_attention_dq(const void* q, const void* k, const void* v,
                                const void* q_tag, const void* k_tag, const void* lse,
                                const void* dout, const void* delta, void* dq, int B,
                                int N, int M, int D, int Dv, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || Dv <= 0) return (int)cudaErrorInvalidValue;
  const int w = D > Dv ? D : Dv;
#define DQ_ARGS                                                                    \
  (const float*)q, (const float*)k, (const float*)v, (const float*)q_tag,          \
      (const float*)k_tag, (const float*)lse, (const float*)dout,                  \
      (const float*)delta, (float*)dq, B, N, M, D, Dv, (cudaStream_t)stream
  if (w <= 64) return (int)launch_dq<64>(DQ_ARGS);
  if (w <= 96) return (int)launch_dq<96>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
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
