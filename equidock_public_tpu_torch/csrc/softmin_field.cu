// Soft-min distance field of the body-intersection loss: the sums
//   S[b, m] = sum_n a_mask[b, n] * exp(-|x[b, m] - a[b, n]|^2 / sigma)
// for every query point x_m against the other protein's points a_n, and
// their backward for the cotangent c = dL/dS:
//   dx[b, m] = (-2 / sigma) c_m sum_n w_mn (x_m - a_n)
//   dA[b, n] = ( 2 / sigma) sum_m c_m w_mn (x_m - a_n),
//   w_mn = a_mask_n exp(-|x_m - a_n|^2 / sigma); a_mask gets no gradient.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// equidock_public_tpu/ops/pallas/softmin_field.py (called through `_fwd` and
// `_vjp_bwd`, `softmin_field_sums`, `body_intersection_loss_fused`). The
// loss turns S into G = -sigma log(1e-3 + S) outside, in PyTorch.
//
// Design. The TPU kernel holds the whole other protein in VMEM and expands
// |x - a|^2 = |x|^2 + |a|^2 - 2 x.a to use one thin MXU product. Here the
// difference x - a is taken directly: on coordinates of tens of A the
// expanded form cancels about 1e-3 A^2 in f32, the direct one does not.
//
// Both kernels are one template over a "role": own points p with weights
// pw (or none), the other set q with weights qw, and D sums a point:
//   forward   own x (no weight), other a with a_mask, D = 1: S_m
//   backward  own x with c, other a with a_mask, D = 3: dx_m
//             own a with a_mask, other x with c, D = 3: dA_n
// (with d = p - q, dA_n = (2/sigma) mask_n sum_m c_m e (x_m - a_n)
// = (-2/sigma) mask_n sum_m c_m e d, so both backward roles scale the same
// sum by -2/sigma times the own weight). The backward is one launch whose
// grid holds the clusters of both roles.
//
//  - Own tiles: 32 LP own points, LP a lane of every warp (lanes on
//    consecutive points). A CLUSTER of `splits` blocks owns one tile; each
//    block holds W warps, each warp one KEY RANGE of the same own tile, so a
//    tile has R = splits x W key ranges. A thread keeps LP x D sums; the
//    key loop is unrolled 8 deep, so 8 LP exponentials are in flight. The
//    wrapper (ops/cuda/softmin_field.py::softmin_tile_plan) picks LP = 1,
//    W = 8 and splits giving each range about 6 of the other set's tiles:
//    1 at the training batch, 2 at 3072 x 3072 (a sweep on an H100,
//    scripts/softmin_tiles_check.py); the kernel is built for LP 1, 2, 4
//    and W 4, 8, 16, at most 128 registers a thread (ptxas at the defaults:
//    68 forward, 80 backward, no spills).
//  - Other-set tiles of 32 points, one a lane. Each block first reads the
//    other set's weights of its batch element (all loads in flight at once)
//    and flags each tile that holds a weight != 0. The kept tiles, in order,
//    are dealt to the R key ranges in turn: kept tile k goes to range
//    k mod R (range = rank x W + warp), so a batch element with many valid
//    points spreads over every range instead of lengthening one. A tile
//    whose weights are all 0 is neither loaded nor visited.
//  - A warp stages its tile's 32 points (float4: x, y, z, weight) in its
//    own slot of shared memory, prefetching the next tile's into registers
//    while it walks the 32 points for its LP own points; points past the
//    set carry weight 0 and add exactly 0.
//  - Backward: an own tile whose own weights (c, or a_mask) are all 0 writes
//    zeros and stages nothing (its output is exactly 0).
//  - Combine, in a fixed order, without atomics: each warp writes its
//    partial sums to shared memory; the block adds its W warps' partials in
//    warp order; after a cluster barrier each block of the cluster takes a
//    slice of the tile's outputs and adds the `splits` blocks' partials in
//    rank order through distributed shared memory, scales and writes them.
//    Every output has one owner; two launches give the same bits.
// Arithmetic a pair: 3 differences, the squared norm (a multiply and two
// FMAs), one multiply by -1/sigma folded in before `expf` (no division),
// then one FMA into S (forward) or a multiply and 3 FMAs (backward). `expf`
// is the accurate one; no fast-math intrinsics.
//
// Bound on an H100 at the training batch (B = 10, M = N = 512, 70 to 274
// of 512 points valid a side; chip_smoke.py::softmin_cost): the forward does
// 12 f32 operations a (query, valid key) pair, one of them the exponential:
// 10 x 512 x about 170 pairs x 12 = 10 MFLOP, 0.15 us at 67 TFLOP/s; its
// bytes (x, a, a_mask in, S out: about 0.1 MB) take 0.04 us at 3.35 TB/s.
// The backward recomputes the weight in both roles and adds three
// multiply-adds: 17 operations a (query with c != 0, valid key) pair in each
// role, 34 a pair, about 0.15 us. Both are bound by operations; at that size
// a launch and two dependent load latencies (weights, then points) cost
// more than the arithmetic. At 3072 x 3072 (B = 2, 80% / 90% valid) the
// forward's 17 M pairs are 3.0 us of operations, the backward's 2 x 13.6 M
// pairs 6.9 us.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kKeyTile = 32;      // points of the other set a tile, one a lane
constexpr int kMaxSplits = 8;     // blocks of a cluster (the portable cluster size)
constexpr int kFlagLoads = 16;    // weight loads a thread keeps in flight for the flags
constexpr int kMaxFlagBytes = 160 * 1024;   // kept flags, one byte an other-set tile

struct Role {
  const float* own_p;   // (B, n_own, 3)
  const float* own_w;   // (B, n_own), or nullptr: every own point counts
  const float* oth_p;   // (B, n_oth, 3)
  const float* oth_w;   // (B, n_oth)
  float* out;           // (B, n_own, D)
  int n_own, n_oth;
};

__device__ __forceinline__ float4 load_point(const float* __restrict__ p,
                                             const float* __restrict__ w, int t, int lane,
                                             int n) {
  const int j = t * kKeyTile + lane;
  if (t < 0 || j >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p + (size_t)j * 3;
  return make_float4(q[0], q[1], q[2], w[j]);
}

// 16 / W blocks of 32 W threads an SM: at most 128 registers a thread at
// every block width.
template <int D, int LP, int W>
__global__ void __launch_bounds__(32 * W, 16 / W)
softmin_tiles_kernel(Role r0, Role r1, int clusters0, float neg_inv_sigma, float sigma) {
  constexpr int kThreads = 32 * W;
  constexpr int kOwn = 32 * LP;
  constexpr int kOut = kOwn * D;
  extern __shared__ uint8_t kept[];                 // a flag an other-set tile
  __shared__ float4 stage[W][kKeyTile];
  __shared__ float part[W][kOut];
  __shared__ float blk[kOut];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = (int)blockIdx.x / splits;
  const bool second = cid >= clusters0;
  const Role r = second ? r1 : r0;
  const int tile = second ? cid - clusters0 : cid;
  const int own_tiles = (r.n_own + kOwn - 1) / kOwn;
  const int b = tile / own_tiles;
  const int own0 = (tile - b * own_tiles) * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_own = r.n_own, n_oth = r.n_oth;

  // own points, the own tile's weights and the other set's weights: all
  // loads issued before the first wait
  float p[LP][3];
#pragma unroll
  for (int i = 0; i < LP; ++i) {
    const int m = own0 + lane + 32 * i;
    const float* q = r.own_p + ((size_t)b * n_own + m) * 3;
    p[i][0] = m < n_own ? q[0] : 0.f;
    p[i][1] = m < n_own ? q[1] : 0.f;
    p[i][2] = m < n_own ? q[2] : 0.f;
  }
  int own_nz = r.own_w == nullptr;
  if (!own_nz) {
    for (int f = threadIdx.x; f < kOwn; f += kThreads) {
      const int m = own0 + f;
      own_nz |= m < n_own && r.own_w[(size_t)b * n_own + m] != 0.f;
    }
  }
  const float* qp = r.oth_p + (size_t)b * n_oth * 3;
  const float* qw = r.oth_w + (size_t)b * n_oth;
  const int oth_tiles = (n_oth + kKeyTile - 1) / kKeyTile;
  for (int e0 = 0; e0 < oth_tiles * kKeyTile; e0 += kFlagLoads * kThreads) {
    float v[kFlagLoads];
#pragma unroll
    for (int u = 0; u < kFlagLoads; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      v[u] = e < n_oth ? qw[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFlagLoads; ++u) {
      const int t = (e0 + u * kThreads) / kKeyTile + warp;   // this warp's tile
      const bool any = __any_sync(0xffffffffu, v[u] != 0.f);
      if (lane == 0 && t < oth_tiles) kept[t] = any;
    }
  }
  const bool own_kept = __syncthreads_or(own_nz);   // also publishes the flags

  // the slice of the tile's outputs this block of the cluster writes
  const int chunk = (kOut + splits - 1) / splits;
  const int f0 = rank * chunk, f1 = min(kOut, f0 + chunk);
  if (!own_kept) {   // the whole cluster sees the same weights: no cluster barrier
    for (int f = f0 + threadIdx.x; f < f1; f += kThreads) {
      const int m = own0 + f / D;
      if (m < n_own) r.out[((size_t)b * n_own + own0) * D + f] = 0.f;
    }
    return;
  }

  // this warp's key range and its walk over the kept tiles, in order
  const int range = rank * W + warp, ranges = splits * W;
  int chunk_tiles = 0, next_chunk = 0, kept_before = 0;
  unsigned mine = 0;
  auto next_tile = [&]() -> int {
    while (mine == 0) {
      if (next_chunk >= oth_tiles) return -1;
      const int t = next_chunk + lane;
      const bool f = t < oth_tiles && kept[t] != 0;
      const unsigned word = __ballot_sync(0xffffffffu, f);
      const int k = kept_before + __popc(word & ((1u << lane) - 1u));
      mine = __ballot_sync(0xffffffffu, f && k % ranges == range);
      kept_before += __popc(word);
      chunk_tiles = next_chunk;
      next_chunk += 32;
    }
    const int bit = __ffs(mine) - 1;
    mine &= mine - 1u;
    return chunk_tiles + bit;
  };

  float acc[LP][D];
#pragma unroll
  for (int i = 0; i < LP; ++i)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[i][d] = 0.f;
  int t = next_tile();
  float4 ahead = load_point(qp, qw, t, lane, n_oth);
  while (t >= 0) {
    stage[warp][lane] = ahead;
    __syncwarp();
    t = next_tile();
    ahead = load_point(qp, qw, t, lane, n_oth);   // the next tile, in flight
#pragma unroll 8
    for (int j = 0; j < kKeyTile; ++j) {
      const float4 q = stage[warp][j];
#pragma unroll
      for (int i = 0; i < LP; ++i) {
        const float d0 = p[i][0] - q.x, d1 = p[i][1] - q.y, d2 = p[i][2] - q.z;
        const float e = expf((d0 * d0 + d1 * d1 + d2 * d2) * neg_inv_sigma);
        if constexpr (D == 1) {
          acc[i][0] = fmaf(q.w, e, acc[i][0]);
        } else {
          const float we = q.w * e;
          acc[i][0] = fmaf(we, d0, acc[i][0]);
          acc[i][1] = fmaf(we, d1, acc[i][1]);
          acc[i][2] = fmaf(we, d2, acc[i][2]);
        }
      }
    }
    __syncwarp();
  }

  // partials: warps in order within the block, then blocks in rank order
#pragma unroll
  for (int i = 0; i < LP; ++i)
#pragma unroll
    for (int d = 0; d < D; ++d) part[warp][(lane + 32 * i) * D + d] = acc[i][d];
  __syncthreads();
  for (int f = threadIdx.x; f < kOut; f += kThreads) {
    float v = part[0][f];
#pragma unroll
    for (int w = 1; w < W; ++w) v += part[w][f];
    blk[f] = v;
  }
  cluster.sync();
  for (int f = f0 + threadIdx.x; f < f1; f += kThreads) {
    float v = *cluster.map_shared_rank(&blk[f], 0);
    for (int s = 1; s < splits; ++s) v += *cluster.map_shared_rank(&blk[f], s);
    const int m = own0 + f / D;
    if (m < n_own) {
      const size_t row = (size_t)b * n_own + m;
      if constexpr (D == 1) {
        r.out[row] = v;
      } else {
        const float scale = -2.f / sigma * r.own_w[row];
        r.out[row * D + f % D] = scale * v;
      }
    }
  }
  cluster.sync();   // the other blocks' partials stay until every block has read them
}

template <int D, int LP, int W>
int launch_tiles(const Role& r0, const Role& r1, int clusters0, int clusters, int splits,
                 float sigma, cudaStream_t stream) {
  const int n_oth = clusters > clusters0 && r1.n_oth > r0.n_oth ? r1.n_oth : r0.n_oth;
  const int flag_bytes = (n_oth + kKeyTile - 1) / kKeyTile;
  if (flag_bytes > kMaxFlagBytes) return (int)cudaErrorInvalidValue;
  auto kernel = softmin_tiles_kernel<D, LP, W>;
  if (flag_bytes > 8 * 1024) {   // past 48 KB with the largest tiles' static 34 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, flag_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * (unsigned)splits);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = (size_t)flag_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, r0, r1, clusters0, -1.f / sigma,
                                             sigma);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The (lane points, warps) pairs the kernels are built for: 32, 64 or 128
// own points a tile, 4, 8 or 16 key ranges a block.
template <int D>
int dispatch(int lane_points, int warps, const Role& r0, const Role& r1, int clusters0,
             int clusters, int splits, float sigma, cudaStream_t stream) {
#define SOFTMIN_CASE(LP, W)                                                              \
  if (lane_points == LP && warps == W)                                                   \
    return launch_tiles<D, LP, W>(r0, r1, clusters0, clusters, splits, sigma, stream);
  SOFTMIN_CASE(1, 4) SOFTMIN_CASE(1, 8) SOFTMIN_CASE(1, 16)
  SOFTMIN_CASE(2, 4) SOFTMIN_CASE(2, 8) SOFTMIN_CASE(2, 16)
  SOFTMIN_CASE(4, 4) SOFTMIN_CASE(4, 8) SOFTMIN_CASE(4, 16)
#undef SOFTMIN_CASE
  return (int)cudaErrorInvalidValue;
}

bool bad_args(int B, int M, int N, float sigma, int lane_points, int splits) {
  if (B <= 0 || M <= 0 || N <= 0 || !(sigma > 0.f) || splits < 1 || splits > kMaxSplits ||
      lane_points < 1)
    return true;
  // own tiles x splits blocks must fit in grid.x
  const long long tiles = (long long)B * ((M + 31) / 32 + (N + 31) / 32);
  return tiles * splits > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays: x (B, M, 3), a (B, N, 3),
// a_mask (B, N); output S (B, M). `lane_points` x 32 own points a tile,
// `warps` key ranges a block, `splits` blocks a cluster (one own tile).
// Returns the cudaError_t of the launch.
int equidock_softmin_field_fwd(const void* x, const void* a, const void* a_mask, void* S,
                               int B, int M, int N, float sigma, int lane_points, int warps,
                               int splits, void* stream) {
  if (bad_args(B, M, N, sigma, lane_points, splits)) return (int)cudaErrorInvalidValue;
  const Role r{(const float*)x, nullptr, (const float*)a, (const float*)a_mask, (float*)S,
               M, N};
  const int clusters = B * ((M + 32 * lane_points - 1) / (32 * lane_points));
  return dispatch<1>(lane_points, warps, r, r, clusters, clusters, splits, sigma,
                     (cudaStream_t)stream);
}

// As above plus the cotangent c (B, M) of S; outputs dx (B, M, 3) and
// dA (B, N, 3). One launch: the clusters of the dx role (own tiles of x),
// then those of the dA role (own tiles of a).
int equidock_softmin_field_bwd(const void* x, const void* a, const void* a_mask,
                               const void* c, void* dx, void* dA, int B, int M, int N,
                               float sigma, int lane_points, int warps, int splits,
                               void* stream) {
  if (bad_args(B, M, N, sigma, lane_points, splits)) return (int)cudaErrorInvalidValue;
  const Role rx{(const float*)x, (const float*)c, (const float*)a, (const float*)a_mask,
                (float*)dx, M, N};
  const Role ra{(const float*)a, (const float*)a_mask, (const float*)x, (const float*)c,
                (float*)dA, N, M};
  const int own = 32 * lane_points;
  const int clusters0 = B * ((M + own - 1) / own);
  const int clusters = clusters0 + B * ((N + own - 1) / own);
  return dispatch<3>(lane_points, warps, rx, ra, clusters0, clusters, splits, sigma,
                     (cudaStream_t)stream);
}

}  // extern "C"
