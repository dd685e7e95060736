// Fused IEGMN edge step, backward: every cotangent of the forward in
// csrc/edge_message.cu, from a recompute of the forward.
//
// Replaces the TPU kernel `_bwd_kernel` of equidock_public_tpu/ops/pallas/edge_message.py
// (:131, called through `_fused_bwd_call`, `edge_message_aggregate(fused_bwd=True)`).
// Given the cotangents g_aggr (B, N, D) and g_xupd (B, N, 3) of the forward's
// outputs, for each destination node i and in-edge k from j = nbr[i, k]
// (mask m, cnt = max(sum_k m, 1)) it recomputes pre, the LayerNorm
// statistics, msg, c1p and coef, then walks back:
//   g_coef = m (g_xupd / cnt) . x_rel,      g_c1p = leaky'(c1p) g_coef W2c,
//   g_msg  = m g_aggr / cnt + g_c1p W1c^T,  g_act = g_msg W2^T,
//   g_pre  = leaky'(pre) LN'(g_act),        g_x_rel = m (g_xupd / cnt) coef
//                                                    + 2 x_rel g_d2,
//   g_d2   = sum_s (g_pre Wd^T)_s rbf_s (-1 / 1.5^s).
// Outputs: per edge dgx (B, N*K, 3) = g_x_rel and dgh (B, N*K, D) = g_pre
// (the cotangents of the gathered src rows; `equidock_edge_scatter_src`
// below sums them onto src), dhe (B, N*K, E) = g_pre Wc^T; per node ddx
// (B, N, 3) = -sum_k g_x_rel and ddh (B, N, D) = sum_k g_pre; and per block
// partial sums of the ten parameter gradients (Wc, Wd, ln_g, ln_b, W2, b2,
// W1c, b1c, W2c, b2c), which the caller sums over blocks in block order.
// Nothing per edge is kept from the forward. A masked edge adds exactly
// zero to every output: g_coef = 0, so g_c1p = g_msg = g_act = g_pre = 0.
//
// Bound on an H100, counted as PERF.md counts it: the unmasked edges only,
// 2 (42 D + 2 D^2 + D) operations of the recompute and 2 (4 D^2 + 2 E D +
// 30 D + 3 D) of the walk back an edge, at 67 TFLOP/s: at the training
// batch (B = 10, N = 512, 70-274 valid nodes a graph, K = 10, D = 64,
// E = 27; about 19 200 unmasked edges of 51 200) 1.26 GFLOP, 18.9 us; the
// bytes (inputs and the function's outputs once, about 18 MB) 5.5 us.
// Bound by f32 operations.
//
// Design (csrc/edge_tiles.cuh). What held the per-edge version back, and
// what the tiles do about it:
//   1. matrix-vector work one edge at a time, a shared load per FMA: a
//      tile's TN K edges (TN = 64 / K whole nodes) are the rows of every
//      product, and a thread keeps a 4 x CB block of outputs in registers
//      and reads its operands as float4 (W^T from transposed copies), so
//      two shared loads feed sixteen FMAs at D = 64;
//   2. about ten block barriers an edge: row reductions take 32 (D = 64) or
//      16 lanes a row with shuffles, and a barrier ends each of the dozen
//      phases of a tile;
//   3. padded nodes computed in full: a tile whose masks are all 0 writes
//      its zero outputs (dgx, dgh, dhe, d_dst) and stages nothing; the
//      tiles the forward flagged as keeping an edge are dealt to the blocks
//      in turn, the others apart, so the kept work spreads evenly;
//   4. one 8-warp block an SM and a two-wave grid: one block an SM (184 KB
//      of shared memory at D = 64; two to four in waves were slower) walks
//      its tiles; each block keeps its weight-gradient partials in
//      registers, one owner an entry, accumulated as tile-level products
//      (dW1c += msg^T g_c1p, dW2 += act^T g_msg, d[Wc; Wd] += [he | rbf]^T
//      g_pre) and the vector gradients as per-row-group sums of the row
//      passes, merged in group order at the end; d_dst is written directly
//      and all partials go to one row a block, summed in one reduction;
//   5. the inverse neighbour list sorted on every backward: the caller
//      builds it once per side per training forward (ops/cuda/edge_message.py)
//      and the scatter kernel below reads it.
// ddx and ddh have one owner a (node, channel) and sum the node's K edges
// in order; every output is the same bits from run to run. All plain f32
// FMA, no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tiles.cuh"

namespace {

using namespace edge;

// Floats of one block's row of parameter partials: Wc, Wd, ln_g, ln_b, W2,
// b2, W1c, b1c, W2c, b2c (the wrapper's PARAM_NAMES order), each flat.
__host__ __device__ inline int partial_floats(int D, int E) {
  return (E + kNumRbf) * D + 2 * D * D + 5 * D + 1;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
edge_message_bwd_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                        const float* __restrict__ he, const int32_t* __restrict__ nbr,
                        const float* __restrict__ msk, const float* __restrict__ Wc,
                        const float* __restrict__ Wd, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const float* __restrict__ W2,
                        const float* __restrict__ b2, const float* __restrict__ W1c,
                        const float* __restrict__ b1c, const float* __restrict__ W2c,
                        const float* __restrict__ b2c, const float* __restrict__ g_aggr,
                        const float* __restrict__ g_xupd,
                        const unsigned char* __restrict__ kept_tiles, float* __restrict__ dgx,
                        float* __restrict__ dgh, float* __restrict__ dhe,
                        float* __restrict__ d_dst, float* __restrict__ part, int B,
                        int Nsrc, int N, int K, int E, float slope, int use_ln,
                        int use_dist, int TN) {
  constexpr int P = Dims<D>::P, CB = Dims<D>::CB;
  constexpr int LPR = Dims<D>::LPR, CPL = Dims<D>::CPL, RG = Dims<D>::RG;
  constexpr int RBW = D / kTX;            // rows of a D x D weight gradient a thread owns
  constexpr int RBE = D == 64 ? 4 : 3;    // rows of the [Wc; Wd] gradient (x 16 >= 48)
  constexpr int C = 3 + D;                // d_dst row
  extern __shared__ float smem[];
  const Layout L = layout(D, E, TN, true, B * ((N + TN - 1) / TN));
  stage_weights<D>(L, smem, E, true, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c);
  const float bias2c = b2c[0];
  const float* neg_inv_sigma = smem + L.sig + 16;   // -1 / 1.5^s

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int g = tid / LPR, l = tid % LPR;
  const int EF = E + kNumRbf;
  float* X0 = smem + L.x[0];    // pre, then g_pre
  float* X1 = smem + L.x[1];    // act, then the g_rbf terms of g_d2
  float* X2 = smem + L.x[2];    // msg, then g_msg
  float* X3 = smem + L.x[3];    // c1p, then g_c1p, then g_act
  const float* hr = smem + L.hr;
  const float* xr = smem + L.xr;
  const float* vec = smem + L.vec;
  const float* stat = smem + L.stat;
  const float* node = smem + L.node;  // per node: g_aggr / cnt (D), g_xupd / cnt (3), cnt

  // This block's parameter-gradient partials: entry (ty RB + a, tx CB + j)
  // of each gradient matrix, and the row group's share of each vector.
  float aW1c[RBW][CB] = {}, aW2[RBW][CB] = {}, aWcd[RBE][CB] = {};
  float aLng[CPL] = {}, aLnb[CPL] = {}, aB2[CPL] = {}, aB1c[CPL] = {}, aW2c[CPL] = {};
  float aB2c = 0.f;

  const int tiles = B * ((N + TN - 1) / TN);
  unsigned* keep = reinterpret_cast<unsigned*>(smem + L.keep);
  load_kept_tiles(keep, kept_tiles, tiles);
  // a tile whose edges all have m = 0: its exact zeros, nothing staged
  auto empty = [&](int t) {
    const TilePos p = tile_pos(t, N, K, TN);
    const size_t n0 = (size_t)p.b * N + p.node0, e0 = n0 * K;
    for (int i = tid; i < p.rows * D; i += kThreads) dgh[e0 * D + i] = 0.f;
    for (int i = tid; i < p.rows * E; i += kThreads) dhe[e0 * E + i] = 0.f;
    for (int i = tid; i < p.rows * 3; i += kThreads) dgx[e0 * 3 + i] = 0.f;
    for (int i = tid; i < p.nodes * C; i += kThreads) d_dst[n0 * C + i] = 0.f;
  };
  auto kept = [&](int t) {
    const TilePos p = tile_pos(t, N, K, TN);
    const size_t n0 = (size_t)p.b * N + p.node0, e0 = n0 * K;
    __syncthreads();   // the previous tile's readers are done with shared memory
    stage_rows<D>(L, smem, p, src, dst, he, nbr, msk, Nsrc, N, K, E, use_dist, g_aggr,
                  g_xupd);
    __syncthreads();
    forward_rows<D>(L, smem, E, slope, use_ln, bias2c, 2, 3);
    __syncthreads();

    // g_coef and g_c1p (over c1p), with their vector gradients
#pragma unroll
    for (int i = 0; i < kRows / RG; ++i) {
      const int r = g + i * RG;
      float g_coef = 0.f;
      if (r < p.rows) {
        const float* gx = node + (r / K) * P + D;
        const float* x = xr + r * 4;
        g_coef = x[3] * (gx[0] * x[0] + gx[1] * x[1] + gx[2] * x[2]);
      }
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = l + LPR * q;
        const float c1p = X3[r * P + c];
        aW2c[q] = fmaf(leaky(c1p, slope), g_coef, aW2c[q]);
        const float g_c1p = g_coef * vec[4 * D + c] * leaky_grad(c1p, slope);
        aB1c[q] += g_c1p;
        X3[r * P + c] = g_c1p;
      }
      if (l == 0) aB2c += g_coef;
    }
    __syncthreads();
    mma<RBW, CB, 1, P, P>(aW1c, X2, X3, kRows, ty, tx);        // dW1c += msg^T g_c1p
    __syncthreads();
    {  // g_msg = m g_aggr / cnt + g_c1p W1c^T, over msg
      float acc[4][CB];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
#pragma unroll
        for (int j = 0; j < CB; ++j)
          acc[a][j] = r < p.rows ? xr[r * 4 + 3] * node[(r / K) * P + tx * CB + j] : 0.f;
      }
      mma<4, CB, P, 1, P>(acc, X3, smem + L.w1ct, D, ty, tx);
      store_rows<D>(X2, acc, ty, tx);
    }
    __syncthreads();
    mma<RBW, CB, 1, P, P>(aW2, X1, X2, kRows, ty, tx);         // dW2 += act^T g_msg
    {  // g_act = g_msg W2^T, over g_c1p
      float acc[4][CB] = {};
      mma<4, CB, P, 1, P>(acc, X2, smem + L.w2t, D, ty, tx);
      store_rows<D>(X3, acc, ty, tx);
    }
    __syncthreads();
    // the LayerNorm and LeakyReLU backward: g_pre over pre; db2 from g_msg
#pragma unroll
    for (int i = 0; i < kRows / RG; ++i) {
      const int r = g + i * RG;
      float pre[CPL], gact[CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = l + LPR * q;
        pre[q] = X0[r * P + c];
        gact[q] = X3[r * P + c];
        aB2[q] += X2[r * P + c];
      }
      if (use_ln) {
        const float mean = stat[r], rstd = stat[kRows + r];
        float nrm[CPL], gn[CPL], gnn[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = l + LPR * q;
          nrm[q] = (leaky(pre[q], slope) - mean) * rstd;
          aLng[q] = fmaf(gact[q], nrm[q], aLng[q]);
          aLnb[q] += gact[q];
          gn[q] = gact[q] * vec[c];
          gnn[q] = gn[q] * nrm[q];
        }
        const float m1 = channel_sum<LPR, CPL>(gn) * (1.f / D);
        const float m2 = channel_sum<LPR, CPL>(gnn) * (1.f / D);
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          X0[r * P + l + LPR * q] =
              rstd * (gn[q] - m1 - nrm[q] * m2) * leaky_grad(pre[q], slope);
      } else {
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          X0[r * P + l + LPR * q] = gact[q] * leaky_grad(pre[q], slope);
      }
    }
    __syncthreads();
    // d[Wc; Wd] += [he | rbf]^T g_pre; [dhe | g_rbf] = g_pre [Wc; Wd]^T
    if (ty * RBE < EF) mma<RBE, CB, 1, kHRS, P>(aWcd, hr, X0, kRows, ty, tx);
    {  // dhe, and the 15 terms of each row's g_d2 (over act)
      float acc[4][3] = {};
      mma<4, 3, P, 1, kHRS>(acc, X0, smem + L.wcdt, D, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int q = tx * 3 + j;
          if (r >= p.rows || q >= EF) continue;
          if (q < E) dhe[(e0 + r) * E + q] = acc[a][j];
          else X1[r * P + q - E] = acc[a][j] * hr[r * kHRS + q] * neg_inv_sigma[q - E];
        }
      }
    }
    for (int i = tid; i < p.rows * D; i += kThreads) dgh[e0 * D + i] = X0[(i / D) * P + i % D];
    for (int i = tid; i < p.nodes * D; i += kThreads) {
      const int n = i / D, c = i % D;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += X0[(n * K + k) * P + c];
      d_dst[(n0 + n) * C + 3 + c] = s;
    }
    __syncthreads();
    // dgx, an (edge, coordinate) a thread; g_d2 summed over s in order
    for (int i = tid; i < p.rows * 3; i += kThreads) {
      const int r = i / 3, c = i % 3;
      float g_d2 = 0.f;
#pragma unroll
      for (int q = 0; q < kNumRbf; ++q) g_d2 += X1[r * P + q];
      const float v = xr[r * 4 + 3] * node[(r / K) * P + D + c] * stat[2 * kRows + r] +
                      2.f * xr[r * 4 + c] * g_d2;
      dgx[e0 * 3 + i] = v;
      X1[r * P + 16 + c] = v;
    }
    __syncthreads();
    // ddx, a (node, coordinate) a thread, the node's edges in order
    for (int i = tid; i < p.nodes * 3; i += kThreads) {
      const int n = i / 3, c = i % 3;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s -= X1[(n * K + k) * P + 16 + c];
      d_dst[(n0 + n) * C + c] = s;
    }
  };
  deal_tiles(keep, tiles, kept, empty);

  // ---- this block's partials: one row of partial_floats(D, E) ----
  float* row = part + (size_t)blockIdx.x * partial_floats(D, E);
  float* pWc = row;
  float* pWd = pWc + E * D;
  float* pLng = pWd + kNumRbf * D;
  float* pLnb = pLng + D;
  float* pW2 = pLnb + D;
  float* pB2 = pW2 + D * D;
  float* pW1c = pB2 + D;
  float* pB1c = pW1c + D * D;
  float* pW2c = pB1c + D;
  float* pB2c = pW2c + D;
#pragma unroll
  for (int a = 0; a < RBW; ++a)
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const int at = (ty * RBW + a) * D + tx * CB + j;
      pW2[at] = aW2[a][j];
      pW1c[at] = aW1c[a][j];
    }
#pragma unroll
  for (int a = 0; a < RBE; ++a) {
    const int e = ty * RBE + a;
#pragma unroll
    for (int j = 0; j < CB; ++j) {
      const int c = tx * CB + j;
      if (e < E) pWc[e * D + c] = aWcd[a][j];
      else if (e < EF) pWd[(e - E) * D + c] = aWcd[a][j];
    }
  }
  __syncthreads();     // shared memory is free: merge the row groups' vector sums
  float* vs = X0;      // [5][RG][D]
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c = l + LPR * q;
    vs[(0 * RG + g) * D + c] = aLng[q];
    vs[(1 * RG + g) * D + c] = aLnb[q];
    vs[(2 * RG + g) * D + c] = aB2[q];
    vs[(3 * RG + g) * D + c] = aB1c[q];
    vs[(4 * RG + g) * D + c] = aW2c[q];
  }
  if (l == 0) X1[g] = aB2c;
  __syncthreads();
  if (tid < D) {
    float* out[5] = {pLng, pLnb, pB2, pB1c, pW2c};
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      float s = 0.f;
      for (int g2 = 0; g2 < RG; ++g2) s += vs[(v * RG + g2) * D + tid];
      out[v][tid] = s;
    }
  }
  if (tid == 0) {
    float s = 0.f;
    for (int g2 = 0; g2 < RG; ++g2) s += X1[g2];
    pB2c[0] = s;
  }
}

template <int D>
cudaError_t launch(const float* src, const float* dst, const float* he, const int32_t* nbr,
                   const float* msk, const float* Wc, const float* Wd, const float* ln_g,
                   const float* ln_b, const float* W2, const float* b2, const float* W1c,
                   const float* b1c, const float* W2c, const float* b2c,
                   const float* g_aggr, const float* g_xupd, const unsigned char* kept_tiles,
                   float* dgx, float* dgh, float* dhe, float* d_dst, float* part, int B,
                   int Nsrc, int N, int K,
                   int E, float slope, int use_ln, int use_dist, int blocks, int TN,
                   cudaStream_t stream) {
  const int tiles = B * ((N + TN - 1) / TN);
  const size_t smem = sizeof(float) * (size_t)layout(D, E, TN, true, tiles).total;
  static size_t configured = 0;   // largest dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_message_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  edge_message_bwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      src, dst, he, nbr, msk, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c, b2c, g_aggr,
      g_xupd, kept_tiles, dgx, dgh, dhe, d_dst, part, B, Nsrc, N, K, E, slope, use_ln,
      use_dist, TN);
  return cudaGetLastError();
}

// d_src (rows, 3 + D): entry (r, ch) sums the cotangents [dgx | dgh] of the
// in-edges of src row r, which are order[offsets[r] .. offsets[r + 1]) in
// ascending edge order. One thread per entry; consecutive threads take
// consecutive channels of a row, so the dgh reads of an edge coalesce.
__global__ void edge_scatter_src_kernel(const int32_t* __restrict__ order,
                                        const int32_t* __restrict__ offsets,
                                        const float* __restrict__ dgx,
                                        const float* __restrict__ dgh,
                                        float* __restrict__ d_src, int rows, int D) {
  const int C = 3 + D;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * C) return;
  const int r = (int)(i / C), ch = (int)(i % C);
  float s = 0.f;
  const int end = offsets[r + 1];
  for (int e = offsets[r]; e < end; ++e) {
    const size_t edge = (size_t)order[e];
    s += ch < 3 ? dgx[edge * 3 + ch] : dgh[edge * D + (ch - 3)];
  }
  d_src[i] = s;
}

}  // namespace

extern "C" {

// Device pointers to contiguous f32 (nbr: int32) arrays. Inputs as
// equidock_edge_message_fwd, plus g_aggr (B, N, D), g_xupd (B, N, 3) and
// kept (tiles) uint8, 1 for each tile with an edge of m != 0 (as the
// forward writes it for the same tile_nodes).
// Outputs: dgx (B, N*K, 3), dgh (B, N*K, D), dhe (B, N*K, E), d_dst
// (B, N, 3 + D) = [ddx | ddh], and `part` (blocks, partial_floats(D, E)):
// each block's row of parameter partials, Wc (E, D), Wd (15, D), ln_g,
// ln_b (D), W2 (D, D), b2 (D), W1c (D, D), b1c, W2c (D), b2c (1), each
// flat, in that order. D is 64 or 16, K <= D, E <= 32; tile_nodes
// destination nodes a tile (tile_nodes * K <= 64) and `blocks` blocks, the
// grid size (edge_tile_plan in ops/cuda/edge_message.py). Returns the
// cudaError_t of the launch.
int equidock_edge_message_bwd(const void* src, const void* dst, const void* he,
                              const void* nbr, const void* msk, const void* Wc,
                              const void* Wd, const void* ln_g, const void* ln_b,
                              const void* W2, const void* b2, const void* W1c,
                              const void* b1c, const void* W2c, const void* b2c,
                              const void* g_aggr, const void* g_xupd, const void* kept,
                              void* dgx, void* dgh,
                              void* dhe, void* d_dst, void* part, int B, int Nsrc, int N,
                              int K, int D, int E, float slope, int use_ln, int use_dist,
                              int blocks, int tile_nodes, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > D || E <= 0 || E > kMaxE || blocks <= 0 ||
      tile_nodes <= 0 || tile_nodes * K > kRows)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS                                                                        \
  (const float*)src, (const float*)dst, (const float*)he, (const int32_t*)nbr,          \
      (const float*)msk, (const float*)Wc, (const float*)Wd, (const float*)ln_g,        \
      (const float*)ln_b, (const float*)W2, (const float*)b2, (const float*)W1c,        \
      (const float*)b1c, (const float*)W2c, (const float*)b2c, (const float*)g_aggr,    \
      (const float*)g_xupd, (const unsigned char*)kept, (float*)dgx, (float*)dgh,       \
      (float*)dhe, (float*)d_dst,                                                       \
      (float*)part, B, Nsrc, N, K, E, slope, use_ln, use_dist, blocks, tile_nodes,      \
      (cudaStream_t)stream
  if (D == 64) return (int)launch<64>(BWD_ARGS);
  if (D == 16) return (int)launch<16>(BWD_ARGS);
  return (int)cudaErrorInvalidValue;
#undef BWD_ARGS
}

// Device pointers: order (E_total) int32, the flat edge indices (b, i, k)
// sorted stably by their src row b * Nsrc + nbr[b, i, k]; offsets (rows + 1)
// int32, where row r's edges start in `order`; dgx (E_total, 3) and dgh
// (E_total, D) from equidock_edge_message_bwd. Writes d_src (rows, 3 + D),
// rows = B * Nsrc. Returns the cudaError_t of the launch.
int equidock_edge_scatter_src(const void* order, const void* offsets, const void* dgx,
                              const void* dgh, void* d_src, int rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)rows * (3 + D);
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  edge_scatter_src_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)offsets, (const float*)dgx, (const float*)dgh,
      (float*)d_src, rows, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
