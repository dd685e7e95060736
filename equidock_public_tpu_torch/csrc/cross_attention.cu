// Masked ligand<->receptor cross-attention, forward.
//
// Replaces the TPU kernel `_fwd_kernel` of equidock_public_tpu/ops/pallas/cross_attention.py
// (called through `_fwd_call` / `cross_attention_fused`). For query row n
// and key m of one complex:
//   mask = (q_tag[n] > 0) & (q_tag[n] == k_tag[m])
//   a    = mask * (q_n . k_m) - 1000 * (1 - mask)      (no 1/sqrt(d) scale)
//   o_n  = softmax_m(a) V,   lse_n = logsumexp_m(a).
// Tags are 0/1 node masks, or (segment id + 1) * mask for packed slots, the
// JAX package's encoding. Keys run over exactly m < M: keys past M are
// excluded, never given -1000, so a query row with no valid key averages
// all M values (lse = -1000 + log M), as the plain version does.
//
// Bound on an H100 at the serving shape (N = 512, M = 1024, D = Dv = 64,
// 172 x 548 pairs kept, 18%): the kept pairs need 24 MFLOP of f32 FMA and
// the 340 padded rows a mean of V each; with under 1 MB of traffic that is
// 0.7 us, bound by operations. At the training batch (B = 10, 512 x 512,
// 70-274 valid nodes a side) about 11% of the pairs are kept.
//
// Design (csrc/attention_tiles.cuh for the tile pieces). Queries and keys
// are cut into 64-row tiles; a block owns one query tile and one split of
// the key tiles (grid: query tiles x splits x B). The wrapper picks the
// number of splits so that the grid fills the card: at the serving shape 8
// query tiles take 16 splits (one key tile a block, 128 blocks). The block
// tests each tile pair from the tags in global memory, stages its key tiles
// in a two-stage cp.async ring (V only for a pair that keeps nothing; K,
// the key tags and, once, the query tile for the others), and keeps an
// online softmax (max m, sum l, 4 x DP/16 accumulators a thread) for its 64
// rows over its key tiles:
//  - a tile pair whose positive tags cannot meet (att::may_keep) has the
//    constant logit -1000 on every valid key; its update needs only the
//    tile's key count and the column sums of V:
//      m' = max(m, -1000), l' = l e^(m-m') + cnt e^(-1000-m'),
//      acc' = acc e^(m-m') + e^(-1000-m') sum_m V_m,
//    so padded rows and whole padded tiles cost a column sum, not two
//    products, and rows whose kept logits all lie below -896 come out right
//    with no special case;
//  - any other pair takes S = Q K^T as 4 x 4 register blocks from shared
//    memory (float4 reads along D; each operand read feeds four products),
//    the per-pair mask, keys past M at -inf (left out), then P through
//    shared memory and acc += P V, again 4 x DP/16 a thread.
// Each block writes its rows' (m, l, acc) to a scratch slot of its split;
// the combine kernel merges the splits of each row in split order (max,
// then the rescaled sums in a fixed order), writes o = acc / l and
// lse = m + log l. No atomics: the forward is deterministic. All in f32
// FMA, no TF32. Widths pad to DP = 16, 64, 72 or 96 (72 for layer 0's 69);
// columns past D and Dv are zeros in shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

using namespace att;

// Shared memory (floats): the query tile, two stages of key and value
// tiles, P [64 queries][64 keys], the query tags, two stages of key tags,
// V's column sums.
__host__ __device__ constexpr int fwd_smem_floats(int DP) {
  return 5 * kTile * stride_of(DP) + kTile * stride_of(kTile) + 3 * kTile + DP;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
cross_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ q_tag,
                           const float* __restrict__ k_tag, float* __restrict__ part_m,
                           float* __restrict__ part_l, float* __restrict__ part_acc, int N,
                           int M, int D, int Dv, int tiles_per_split, bool vec_qk,
                           bool vec_v) {
  constexpr int S = stride_of(DP), SP = stride_of(kTile);
  constexpr int CJ = col_groups(DP);
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                   // [64][S]
  float* sK = sQ + kTile * S;                         // [2][64][S]
  float* sV = sK + 2 * kTile * S;                     // [2][64][S]
  float* sP = sV + 2 * kTile * S;                     // [64][SP]
  float* sQt = sP + kTile * SP;                       // [64]
  float* sKt = sQt + kTile;                           // [2][64]
  float* sCol = sKt + 2 * kTile;                      // [DP]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int n0 = blockIdx.x * kTile;
  const int key_tiles = (M + kTile - 1) / kTile;
  int t0, t1;
  split_range(split, tiles_per_split, key_tiles, &t0, &t1);
  q += (size_t)b * N * D;
  q_tag += (size_t)b * N;
  k += (size_t)b * M * D;
  v += (size_t)b * M * Dv;
  k_tag += (size_t)b * M;

  // Each key tile's test comes from the tags in global memory before the
  // tile is staged: a tile pair that keeps nothing stages only V, and the
  // query tile is staged with the first pair that may keep something.
  const TagRange q_range = tag_range(q_tag, n0, N);
  bool q_staged = false;
  auto stage = [&](int t, int stage_idx, bool mixed) {
    if (mixed && !q_staged) {
      stage_tile<DP>(sQ, q, n0, N, D, vec_qk);
      stage_vec(sQt, q_tag, n0, N);
      q_staged = true;
    }
    if (mixed) {
      stage_tile<DP>(sK + stage_idx * kTile * S, k, t * kTile, M, D, vec_qk);
      stage_vec(sKt + stage_idx * kTile, k_tag, t * kTile, M);
    }
    stage_tile<DP>(sV + stage_idx * kTile * S, v, t * kTile, M, Dv, vec_v);
    cp_async_commit();
  };
  bool mixed = may_keep(q_range, tag_range(k_tag, t0 * kTile, M));
  stage(t0, 0, mixed);

  float m_run[kSub], l_run[kSub], acc[kSub][CJ];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    bool next_mixed = false;
    if (t + 1 < t1) {
      next_mixed = may_keep(q_range, tag_range(k_tag, (t + 1) * kTile, M));
      stage(t + 1, buf ^ 1, next_mixed);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tK = sK + buf * kTile * S;
    const float* tV = sV + buf * kTile * S;
    const float* tKt = sKt + buf * kTile;
    const int cnt = min(kTile, M - t * kTile);       // valid keys of the tile

    if (!mixed) {
      // Constant logit -1000 on the tile's cnt keys: column sums of V (rows
      // past M are zeros), in a fixed order.
      if (tid < DP) {
        float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 4
        for (int r = 0; r < kTile; r += 4) {
          c0 += tV[r * S + tid];
          c1 += tV[(r + 1) * S + tid];
          c2 += tV[(r + 2) * S + tid];
          c3 += tV[(r + 3) * S + tid];
        }
        sCol[tid] = (c0 + c1) + (c2 + c3);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float mn = fmaxf(m_run[i], kMasked);
        const float corr = expf(m_run[i] - mn), e = expf(kMasked - mn);
        l_run[i] = fmaf(l_run[i], corr, (float)cnt * e);
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          if (owns_col<DP>(j, tx)) acc[i][j] = fmaf(acc[i][j], corr, e * sCol[tx + 16 * j]);
        m_run[i] = mn;
      }
    } else {
      float s[kSub][kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 qa[kSub], kb[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) qa[i] = ld4(sQ + (ty * kSub + i) * S + d);
#pragma unroll
        for (int j = 0; j < kSub; ++j) kb[j] = ld4(tK + (tx + 16 * j) * S + d);
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
      }
      float kt[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) kt[j] = tKt[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float qt = sQt[ty * kSub + i];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool keep = qt > 0.f && qt == kt[j];
          s[i][j] = tx + 16 * j < cnt ? (keep ? s[i][j] : kMasked) : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        const float mn = fmaxf(m_run[i], row_max16(mx));
        const float corr = expf(m_run[i] - mn);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          rs += s[i][j];
        }
        l_run[i] = fmaf(l_run[i], corr, row_sum16(rs));
        m_run[i] = mn;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) sP[(ty * kSub + i) * SP + tx + 16 * j] = s[i][j];
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < kTile; c += 4) {
        float4 p[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) p[i] = ld4(sP + (ty * kSub + i) * SP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vv[CJ];
#pragma unroll
          for (int j = 0; j < CJ; ++j)
            vv[j] = owns_col<DP>(j, tx) ? tV[(c + cc) * S + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kSub; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(lane4(p[i], cc), vv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                     // this stage is free for tile t + 2
    mixed = next_mixed;
  }

  const size_t slot = (size_t)b * splits + split;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int n = n0 + ty * kSub + i;
    if (n >= N) continue;
    const size_t row = slot * N + n;
    if (tx == 0) {
      part_m[row] = m_run[i];
      part_l[row] = l_run[i];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv) part_acc[row * Dv + c] = acc[i][j];
    }
  }
}

// One thread per (b, n, channel): merge the splits of row n in split order.
__global__ void cross_attention_combine_kernel(const float* __restrict__ part_m,
                                               const float* __restrict__ part_l,
                                               const float* __restrict__ part_acc,
                                               float* __restrict__ o, float* __restrict__ lse,
                                               int B, int N, int Dv, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * N * Dv) return;
  const size_t row = idx / Dv;
  const int c = (int)(idx % Dv);
  const size_t b = row / N, n = row % N;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[(b * splits + s) * N + n]);
  float l = 0.f, x = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = (b * splits + s) * N + n;
    const float w = expf(part_m[r] - mx);
    l = fmaf(part_l[r], w, l);
    x = fmaf(part_acc[r * Dv + c], w, x);
  }
  o[idx] = x / l;
  if (c == 0) lse[row] = mx + logf(l);
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* q_tag,
                   const float* k_tag, float* pm, float* pl, float* pacc, int B, int N,
                   int M, int D, int Dv, int splits, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * fwd_smem_floats(DP);
  static bool configured = false;    // the attribute is set once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_attention_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int key_tiles = (M + kTile - 1) / kTile;
  const int per_split = (key_tiles + splits - 1) / splits;
  if ((splits - 1) * per_split >= key_tiles) return cudaErrorInvalidValue;   // an empty split
  const dim3 grid((N + kTile - 1) / kTile, splits, B);
  cross_attention_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, q_tag, k_tag, pm, pl, pacc, N, M, D, Dv, per_split,
      vec_ok(q, D) && vec_ok(k, D), vec_ok(v, Dv));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays: q (B, N, D), k (B, M, D),
// v (B, M, Dv), q_tag (B, N), k_tag (B, M); scratch part_m and part_l
// (B, splits, N) and part_acc (B, splits, N, Dv). The key tiles are cut into
// `splits` runs of equal length, none empty. D, Dv <= 96. Returns the
// cudaError_t of the launch.
int equidock_cross_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* q_tag, const void* k_tag, void* part_m,
                                 void* part_l, void* part_acc, int B, int N, int M, int D,
                                 int Dv, int splits, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || Dv <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int w = D > Dv ? D : Dv;
#define ATT_ARGS                                                                      \
  (const float*)q, (const float*)k, (const float*)v, (const float*)q_tag,             \
      (const float*)k_tag, (float*)part_m, (float*)part_l, (float*)part_acc, B, N, M, \
      D, Dv, splits, (cudaStream_t)stream
  if (w <= 16) return (int)launch<16>(ATT_ARGS);
  if (w <= 64) return (int)launch<64>(ATT_ARGS);
  if (w <= 72) return (int)launch<72>(ATT_ARGS);
  if (w <= 96) return (int)launch<96>(ATT_ARGS);
#undef ATT_ARGS
  return (int)cudaErrorInvalidValue;
}

// The forward's second pass: o (B, N, Dv) and lse (B, N) from the splits'
// (m, l, acc), merged in split order.
int equidock_cross_attention_combine(const void* part_m, const void* part_l,
                                     const void* part_acc, void* o, void* lse, int B, int N,
                                     int Dv, int splits, void* stream) {
  if (B <= 0 || N <= 0 || Dv <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * N * Dv;
  const int threads = 256;
  cross_attention_combine_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                                   (cudaStream_t)stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, (float*)o,
      (float*)lse, B, N, Dv, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
