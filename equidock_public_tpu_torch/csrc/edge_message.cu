// Fused IEGMN edge step, forward: per-edge messages and their masked means.
//
// Replaces the TPU kernel `_kernel` of equidock_public_tpu/ops/pallas/edge_message.py
// (:70, called through `_fused_call` / `edge_message_aggregate`). For each
// destination node i of one protein side and each of its K in-edges from
// j = nbr[i, k]:
//   x_rel = x_j - x_i;  rbf_s = exp(-|x_rel|^2 / 1.5^s), s < 15
//   pre   = (h_j W_a) + (h_i W_b + b1) + he_ik Wc + rbf Wd
//   act   = LN(LeakyReLU(pre))          (LN optional, eps 1e-5)
//   msg   = act W2 + b2
//   coef  = LeakyReLU(msg W1c + b1c) W2c + b2c
//   aggr_i = sum_k m_ik msg / cnt,  x_upd_i = sum_k m_ik x_rel coef / cnt,
//   cnt = max(sum_k m_ik, 1).
// The caller passes src = [x | h W_a] and dst = [x | h W_b + b1]; the two
// (N, D) products stay outside, as in the JAX package.
//
// Bound on an H100, counted as PERF.md counts it: the products of the
// unmasked edges only, 2 (42 D + 2 D^2 + D) f32 operations an edge, at
// 67 TFLOP/s; at the serving shape (N = 1024, 548 valid nodes, K = 10,
// D = 64, E = 27, 80% of a valid node's edges kept) about 1.4 us, and the
// bytes (inputs and outputs once, about 1.8 MB) 0.5 us. Bound by f32
// operations.
//
// Design (csrc/edge_tiles.cuh). A block takes tiles of TN = 64 / K whole
// destination nodes (6 at K = 10), dealt to the grid in turn; a tile's
// TN K edges are the rows of the products. A tile whose masks are all 0
// (every tile of padded nodes) writes aggr = 0 and x_upd = 0 and stages
// nothing; each tile's flag goes to `kept` for the backward. Otherwise it
// stages the gathered src rows plus the dst rows, [he | rbf] and x_rel once,
// and runs the edge MLP as three tile products with 4 x CB register blocks
// read from shared memory as float4 (each weight value read once per 4
// rows, not once per edge): pre = [he | rbf] [Wc; Wd] + h, msg = act W2 +
// b2, c1p = msg W1c + b1c; LayerNorm and the coefficient are row reductions
// over 32 (D = 64) or 16 (D = 16) lanes with shuffles. A phase ends in one
// block barrier: about eight a tile, not ten an edge. The masked means are
// one owner per (node, channel), summed in edge order. Weights (about 47 KB
// at D = 64, E = 27) are staged once per block by cp.async; 101 KB of
// shared memory in all at D = 64, so two blocks share an SM (at one block
// an SM the step's shape ran slower). Every product is plain f32 FMA: no
// TF32. Outputs are the same bits from run to run (no atomics; every sum in
// a fixed order).

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tiles.cuh"

namespace {

using namespace edge;

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
edge_message_fwd_kernel(const float* __restrict__ src,
                        const float* __restrict__ dst,
                        const float* __restrict__ he,
                        const int32_t* __restrict__ nbr,
                        const float* __restrict__ msk,
                        const float* __restrict__ Wc,
                        const float* __restrict__ Wd,
                        const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b,
                        const float* __restrict__ W2,
                        const float* __restrict__ b2,
                        const float* __restrict__ W1c,
                        const float* __restrict__ b1c,
                        const float* __restrict__ W2c,
                        const float* __restrict__ b2c,
                        float* __restrict__ aggr,
                        float* __restrict__ xupd,
                        unsigned char* __restrict__ kept,
                        int B, int Nsrc, int N, int K, int E,
                        float slope, int use_ln, int use_dist, int TN) {
  constexpr int P = Dims<D>::P;
  extern __shared__ float smem[];
  const Layout L = layout(D, E, TN, false);
  stage_weights<D>(L, smem, E, false, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c);
  const float bias2c = b2c[0];
  const float* X0 = smem + L.x[0];          // msg, after forward_rows
  const float* xr = smem + L.xr;
  const float* coef = smem + L.stat + 2 * kRows;
  const float* node = smem + L.node;         // cnt of each node at column D + 3

  const int tiles = B * ((N + TN - 1) / TN);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TilePos p = tile_pos(t, N, K, TN);
    const size_t n0 = (size_t)p.b * N + p.node0;
    // a barrier: the previous tile's readers are done with shared memory
    const bool has = tile_has_edges(msk, p, N, K);
    if (kept != nullptr && threadIdx.x == 0) kept[t] = has;
    if (!has) {
      for (int i = threadIdx.x; i < p.nodes * D; i += kThreads) aggr[n0 * D + i] = 0.f;
      for (int i = threadIdx.x; i < p.nodes * 3; i += kThreads) xupd[n0 * 3 + i] = 0.f;
      continue;
    }
    stage_rows<D>(L, smem, p, src, dst, he, nbr, msk, Nsrc, N, K, E, use_dist);
    __syncthreads();
    forward_rows<D>(L, smem, E, slope, use_ln, bias2c, 0, 1);
    __syncthreads();
    // masked means over each node's K edges, in edge order
    for (int i = threadIdx.x; i < p.nodes * (D + 3); i += kThreads) {
      const int n = i < p.nodes * D ? i / D : (i - p.nodes * D) / 3;
      const int c = i < p.nodes * D ? i % D : (i - p.nodes * D) % 3;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        const int r = n * K + k;
        s = fmaf(xr[r * 4 + 3], i < p.nodes * D ? X0[r * P + c] : xr[r * 4 + c] * coef[r], s);
      }
      const float cnt = node[n * P + D + 3];
      if (i < p.nodes * D) aggr[(n0 + n) * D + c] = s / cnt;
      else xupd[(n0 + n) * 3 + c] = s / cnt;
    }
  }
}

template <int D>
cudaError_t launch(const float* src, const float* dst, const float* he,
                   const int32_t* nbr, const float* msk, const float* Wc,
                   const float* Wd, const float* ln_g, const float* ln_b,
                   const float* W2, const float* b2, const float* W1c,
                   const float* b1c, const float* W2c, const float* b2c,
                   float* aggr, float* xupd, unsigned char* kept, int B, int Nsrc, int N,
                   int K,
                   int E, float slope, int use_ln, int use_dist, int TN, int blocks,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)layout(D, E, TN, false).total;
  static size_t configured = 0;   // largest dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_message_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  edge_message_fwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      src, dst, he, nbr, msk, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c, b2c,
      aggr, xupd, kept, B, Nsrc, N, K, E, slope, use_ln, use_dist, TN);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous f32 (nbr: int32) arrays:
// src (B, Nsrc, 3+D), dst (B, N, 3+D), he (B, N, K, E), nbr/msk (B, N, K),
// Wc (E, D), Wd (15, D), ln_g/ln_b/b2/b1c (D), W2/W1c (D, D), W2c (D, 1),
// b2c (1); outputs aggr (B, N, D), xupd (B, N, 3) and, when not null,
// kept (tiles) uint8: 1 for each tile with an edge of m != 0, for the
// backward. D is 64 (the paper
// models' width) or 16 (the small models'), K <= D, E <= 32; tile_nodes
// destination nodes a tile (tile_nodes * K <= 64) and `blocks` blocks
// (edge_tile_plan in ops/cuda/edge_message.py). Returns the cudaError_t of
// the launch.
int equidock_edge_message_fwd(const void* src, const void* dst, const void* he,
                              const void* nbr, const void* msk, const void* Wc,
                              const void* Wd, const void* ln_g, const void* ln_b,
                              const void* W2, const void* b2, const void* W1c,
                              const void* b1c, const void* W2c, const void* b2c,
                              void* aggr, void* xupd, void* kept, int B, int Nsrc, int N,
                              int K, int D, int E, float slope, int use_ln,
                              int use_dist, int tile_nodes, int blocks, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > D || E <= 0 || E > kMaxE || tile_nodes <= 0 ||
      tile_nodes * K > kRows || blocks <= 0)
    return (int)cudaErrorInvalidValue;
#define EDGE_ARGS                                                            \
  (const float*)src, (const float*)dst, (const float*)he,                    \
      (const int32_t*)nbr, (const float*)msk, (const float*)Wc,              \
      (const float*)Wd, (const float*)ln_g, (const float*)ln_b,              \
      (const float*)W2, (const float*)b2, (const float*)W1c,                 \
      (const float*)b1c, (const float*)W2c, (const float*)b2c,               \
      (float*)aggr, (float*)xupd, (unsigned char*)kept, B, Nsrc, N, K, E,     \
      slope, use_ln, use_dist,                                               \
      tile_nodes, blocks, (cudaStream_t)stream
  if (D == 64) return (int)launch<64>(EDGE_ARGS);
  if (D == 16) return (int)launch<16>(EDGE_ARGS);
  return (int)cudaErrorInvalidValue;
#undef EDGE_ARGS
}

}  // extern "C"
