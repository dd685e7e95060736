// Tile pieces shared by the edge-message forward (edge_message.cu) and its
// backward (edge_message_bwd.cu).
//
// A tile is TN consecutive destination nodes of one graph; its TN * K
// in-edges are the rows of small matrices of kRows = 64 rows (TN = 64 / K,
// 6 at K = 10: 60 rows used, the rest zero with mask 0). A tile whose edges
// all have m = 0 (the test is on the values, in global memory) adds exactly
// nothing to any sum: it writes its zero outputs and stages nothing. The
// forward deals all tiles to its grid in turn (block b takes tiles b, b + G,
// ...; a block a tile at the models' shapes) and writes a flag a tile; the
// backward deals the flagged tiles in turn, and apart the others, so no
// block holds more than one kept tile above another (on the training batch
// plain turns gave some blocks 4 kept tiles where 3 do).
//
// Staging. One thread a row reads nbr, x_rel and the mask and notes the
// row's src and dst rows; then every thread issues all its loads of the h
// and he rows before it stores any, so a tile waits on about two load
// latencies (loads behind a branch, or 4-byte cp.async copies, were slower
// on the card).
//
// Products. A block of 256 threads is a 16 x 16 grid: thread (ty, tx) owns
// rows ty * RB + a and columns tx * CB + j of a product, so one operand read
// from shared memory feeds RB rows or CB columns. Every operand row starts on
// 16 bytes (strides of D + 4 floats), so a thread reads its four columns, or
// four consecutive rows or depths, as one float4: two loads for sixteen
// FMAs at D = 64. Weights sit k-major ([in][out]); the backward also keeps
// W2, W1c and [Wc; Wd] transposed, so X W^T reads k-major too. The weights
// arrive by cp.async, once per block.
// Row reductions (LayerNorm's mean and variance, the coefficient's dot
// product, the LayerNorm backward's two sums) take min(D, 32) lanes a row
// with shuffles: no block barrier inside a phase, one between phases.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;          // edge rows of a tile
constexpr int kNumRbf = 15;
constexpr int kMaxE = 32;          // widest edge-feature row the kernels take
constexpr int kTX = 16;            // threads across the columns of a product
constexpr int kHRS = 52;           // row stride of [he | rbf] and of [Wc; Wd]^T:
                                   // >= kMaxE + kNumRbf, rows 4 apart 16 banks apart

// The RBF width 1.5^s: every product exact in binary32 for s < 15 (3^14 <
// 2^24), so it equals the constant 1.5^s.
__device__ __forceinline__ float rbf_sigma(int s) {
  float v = 1.f;
  for (int i = 0; i < s; ++i) v *= 1.5f;
  return v;
}

template <int D>
struct Dims {
  static constexpr int P = D + 4;               // row stride of activations and weights
  static constexpr int CB = D == 64 ? 4 : 1;    // columns a thread owns in a D-wide product
  static constexpr int LPR = D < 32 ? D : 32;   // lanes a row in the row passes
  static constexpr int CPL = D / LPR;           // channels a lane owns there
  static constexpr int RG = kThreads / LPR;     // rows a row pass takes at once
};

// Rows of [Wc; Wd] and columns of [he | rbf]: E + 15 rounded up to 4, the
// pad zero, so products over them run in steps of four.
__host__ __device__ inline int ef_pad(int E) { return (E + kNumRbf + 3) & ~3; }

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

__device__ __forceinline__ float leaky_grad(float x, float slope) {
  return x >= 0.f ? 1.f : slope;
}

// Sum over aligned runs of `width` lanes (a power of two up to 32).
template <int width>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, width);
  return v;
}

// Sum over a row's D channels, lane l holding channels l + LPR q: each run
// of LPR channels summed over the lanes first, then the runs in order, so
// the sum associates as the per-edge kernels' did (a warp of 32 channels,
// then the warps) and rounds the same way.
template <int LPR, int CPL>
__device__ __forceinline__ float channel_sum(const float (&v)[CPL]) {
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < CPL; ++q) t += row_sum<LPR>(v[q]);
  return t;
}

// Offsets (floats, each a multiple of 4) of a block's shared memory.
struct Layout {
  int wcd, w2, w1c, wcdt, w2t, w1ct, vec, sig, hr, xr, rows, x[4], stat, node, keep, total;
};

// `backward`: four activation buffers, the transposed weights and a bit a
// tile (`tiles` of them), else two buffers. Node rows of D + 4 floats for TN
// nodes (the backward's output cotangents divided by cnt).
__host__ __device__ inline Layout layout(int D, int E, int TN, bool backward, int tiles = 0) {
  Layout s;
  const int P = D + 4;
  int o = 0;
  s.wcd = o;  o += ef_pad(E) * P;        // [Wc; Wd; 0], k-major
  s.w2 = o;   o += D * P;
  s.w1c = o;  o += D * P;
  s.wcdt = s.w2t = s.w1ct = o;
  if (backward) {
    s.wcdt = o;  o += D * kHRS;          // [Wc; Wd]^T
    s.w2t = o;   o += D * P;
    s.w1ct = o;  o += D * P;
  }
  s.vec = o;  o += 5 * D;                // ln_g, ln_b, b2, b1c, W2c
  s.sig = o;  o += 32;                   // 1.5^s and -1 / 1.5^s, s < 15
  s.hr = o;   o += kRows * kHRS;         // [he | rbf | 0] per edge row
  s.xr = o;   o += kRows * 4;            // x_rel (3) and the mask per edge row
  s.rows = o; o += 3 * kRows;            // per edge row: src row, dst row (int), |x_rel|^2
  for (int i = 0; i < 4; ++i) {
    s.x[i] = o;
    if (i < (backward ? 4 : 2)) o += kRows * P;
  }
  s.stat = o; o += 3 * kRows;            // LN mean, LN rstd, coef per edge row
  s.node = o; o += TN * P;
  s.keep = o; o += backward ? (tiles + 127) / 128 * 4 : 0;
  s.total = o;
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// A row-major (rows, D) matrix into shared rows of stride P: 16-byte copies
// in flight together when the source is 16-byte aligned, else plain loads.
template <int D>
__device__ __forceinline__ void stage_matrix(float* dst, const float* __restrict__ src,
                                             int rows) {
  constexpr int P = Dims<D>::P;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads)
      cp_async16(dst + (i / (D / 4)) * P + (i % (D / 4)) * 4, src + i * 4);
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) dst[(i / D) * P + i % D] = src[i];
  }
}

// Weights into shared memory, once per block: [Wc; Wd; 0], W2, W1c and the
// five vectors; with `transposed`, also [Wc; Wd]^T, W2^T and W1c^T (from the
// staged copies). Ends in a barrier.
template <int D>
__device__ __forceinline__ void stage_weights(const Layout& L, float* smem, int E,
                                              bool transposed,
                                              const float* __restrict__ Wc,
                                              const float* __restrict__ Wd,
                                              const float* __restrict__ ln_g,
                                              const float* __restrict__ ln_b,
                                              const float* __restrict__ W2,
                                              const float* __restrict__ b2,
                                              const float* __restrict__ W1c,
                                              const float* __restrict__ b1c,
                                              const float* __restrict__ W2c) {
  constexpr int P = Dims<D>::P;
  const int EF = E + kNumRbf, EFP = ef_pad(E);
  stage_matrix<D>(smem + L.wcd, Wc, E);
  stage_matrix<D>(smem + L.wcd + E * P, Wd, kNumRbf);
  stage_matrix<D>(smem + L.w2, W2, D);
  stage_matrix<D>(smem + L.w1c, W1c, D);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < (EFP - EF) * D; i += kThreads)
    smem[L.wcd + (EF + i / D) * P + i % D] = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float* v = smem + L.vec;
    v[i] = ln_g[i];
    v[D + i] = ln_b[i];
    v[2 * D + i] = b2[i];
    v[3 * D + i] = b1c[i];
    v[4 * D + i] = W2c[i];
  }
  if (threadIdx.x < kNumRbf) {
    smem[L.sig + threadIdx.x] = rbf_sigma(threadIdx.x);
    smem[L.sig + 16 + threadIdx.x] = -1.f / rbf_sigma(threadIdx.x);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (transposed) {
    for (int i = threadIdx.x; i < D * D; i += kThreads) {
      const int o = i / D, c = i % D;
      smem[L.w2t + o * P + c] = smem[L.w2 + c * P + o];
      smem[L.w1ct + o * P + c] = smem[L.w1c + c * P + o];
    }
    for (int i = threadIdx.x; i < D * kHRS; i += kThreads) {
      const int c = i / kHRS, q = i % kHRS;
      smem[L.wcdt + i] = q < EFP ? smem[L.wcd + q * P + c] : 0.f;
    }
    __syncthreads();
  }
}

// keep[] = one bit a tile from the flag bytes the forward kernel wrote (1
// when some edge of the tile has m != 0). Ends in a barrier.
__device__ __forceinline__ void load_kept_tiles(unsigned* keep,
                                                const unsigned char* __restrict__ flags,
                                                int tiles) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w * 32 < tiles; w += kWarps) {
    const int t = w * 32 + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, t < tiles && flags[t] != 0);
    if (lane == 0) keep[w] = bits;
  }
  __syncthreads();
}

// Position of the n-th set bit of x (n < popc(x)).
__device__ __forceinline__ int nth_set_bit(unsigned x, int n) {
  for (int i = 0; i < n; ++i) x &= x - 1;
  return __ffs(x) - 1;
}

// Calls kept(t) for the tiles of keep[] that are this block's in turn among
// the kept tiles (the block's index, plus the grid size, ...), and empty(t)
// likewise among the others: every block's share of both differs by at most
// one tile. Uniform over the block (keep[] is in shared memory), so kept()
// may hold barriers.
template <class Kept, class Empty>
__device__ __forceinline__ void deal_tiles(const unsigned* keep, int tiles, Kept kept,
                                           Empty empty) {
  int kept_seen = 0, empty_seen = 0;
  int next_kept = blockIdx.x, next_empty = blockIdx.x;
  for (int w = 0; w * 32 < tiles; ++w) {
    const int valid = min(32, tiles - w * 32);
    const unsigned live = valid == 32 ? ~0u : (1u << valid) - 1u;
    const unsigned bits = keep[w] & live;
    const int nk = __popc(bits), ne = valid - nk;
    for (; next_kept < kept_seen + nk; next_kept += gridDim.x)
      kept(w * 32 + nth_set_bit(bits, next_kept - kept_seen));
    for (; next_empty < empty_seen + ne; next_empty += gridDim.x)
      empty(w * 32 + nth_set_bit(~bits & live, next_empty - empty_seen));
    kept_seen += nk;
    empty_seen += ne;
  }
}

// Where tile t lies: graph b, first node, nodes in it, edge rows in it.
struct TilePos {
  int b, node0, nodes, rows;
};

__device__ __forceinline__ TilePos tile_pos(int t, int N, int K, int TN) {
  const int per_graph = (N + TN - 1) / TN;
  TilePos p;
  p.b = t / per_graph;
  p.node0 = (t % per_graph) * TN;
  p.nodes = min(TN, N - p.node0);
  p.rows = p.nodes * K;
  return p;
}

// True when some edge of the tile has m != 0 (read from global memory).
// A block barrier: every thread must call it.
__device__ __forceinline__ bool tile_has_edges(const float* __restrict__ msk, const TilePos& p,
                                               int N, int K) {
  const size_t e0 = ((size_t)p.b * N + p.node0) * K;
  int any = 0;
  for (int r = threadIdx.x; r < p.rows; r += kThreads) any |= msk[e0 + r] != 0.f;
  return __syncthreads_or(any) != 0;
}

// The tile's edge rows into shared memory: X0 = h_src + h_dst, [he | rbf |
// 0], x_rel and the mask; rows past the tile's edges are zeros with mask 0.
// Each node's cnt = max(sum_k m, 1) goes to its node row (column D + 3),
// and with g_aggr / g_xupd (the backward) the node's output cotangents
// divided by cnt to columns 0..D+2. First one thread a row reads nbr, x_rel
// and the mask and notes the row's src and dst rows; after a barrier every
// thread loads its share of the h and he rows, the RBFs and the node rows,
// all loads of a loop independent and unrolled, so a tile waits on about
// two load latencies. The caller's barrier ends the staging.
template <int D>
__device__ __forceinline__ void stage_rows(const Layout& L, float* smem, const TilePos& p,
                                           const float* __restrict__ src,
                                           const float* __restrict__ dst,
                                           const float* __restrict__ he,
                                           const int32_t* __restrict__ nbr,
                                           const float* __restrict__ msk, int Nsrc, int N,
                                           int K, int E, int use_dist,
                                           const float* __restrict__ g_aggr = nullptr,
                                           const float* __restrict__ g_xupd = nullptr) {
  constexpr int P = Dims<D>::P, C = 3 + D;
  const int EF = E + kNumRbf, EFP = ef_pad(E);
  const size_t n0 = (size_t)p.b * N + p.node0, e0 = n0 * K;
  int* srow = reinterpret_cast<int*>(smem + L.rows);    // b Nsrc + j
  int* drow = srow + kRows;                              // b N + i
  float* d2 = smem + L.rows + 2 * kRows;
  float* node = smem + L.node;
  float* xr = smem + L.xr;
  const int t = threadIdx.x;
  if (t < kRows) {
    if (t < p.rows) {
      const int j = p.b * Nsrc + nbr[e0 + t];
      const int i = (int)n0 + t / K;
      const float* s = src + (size_t)j * C;
      const float* d = dst + (size_t)i * C;
      const float x0 = s[0] - d[0], x1 = s[1] - d[1], x2 = s[2] - d[2];
      srow[t] = j;
      drow[t] = i;
      d2[t] = x0 * x0 + x1 * x1 + x2 * x2;
      xr[t * 4 + 0] = x0;
      xr[t * 4 + 1] = x1;
      xr[t * 4 + 2] = x2;
      xr[t * 4 + 3] = msk[e0 + t];
    } else {        // a row past the tile's edges: reads a real row, weighs it 0
      srow[t] = p.b * Nsrc;
      drow[t] = (int)n0;
      d2[t] = 0.f;
      xr[t * 4 + 0] = xr[t * 4 + 1] = xr[t * 4 + 2] = xr[t * 4 + 3] = 0.f;
    }
  }
  __syncthreads();
  // every load in range and unconditional, so the unrolled loops issue them
  // all before the first is used
  // all of a thread's loads first, then its stores
  constexpr int kH = kRows * D / kThreads, kE = (kRows * kMaxE + kThreads - 1) / kThreads;
  float hs[kH], hd[kH], hv[kE];
  const int he_last = p.rows * E - 1;
#pragma unroll
  for (int it = 0; it < kH; ++it) {
    const int i = it * kThreads + t, r = i / D, c = i % D;
    hs[it] = src[(size_t)srow[r] * C + 3 + c];
    hd[it] = dst[(size_t)drow[r] * C + 3 + c];
  }
#pragma unroll
  for (int it = 0; it < kE; ++it) hv[it] = he[e0 * E + min(it * kThreads + t, he_last)];
  float* X0 = smem + L.x[0];
#pragma unroll
  for (int it = 0; it < kH; ++it) {
    const int i = it * kThreads + t, r = i / D, c = i % D;
    X0[r * P + c] = r < p.rows ? hs[it] + hd[it] : 0.f;
  }
  float* hr = smem + L.hr;
#pragma unroll
  for (int it = 0; it < kE; ++it) {
    const int i = it * kThreads + t;
    if (i < kRows * E) hr[(i / E) * kHRS + i % E] = i <= he_last ? hv[it] : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kRows * 16 / kThreads; ++it) {   // RBFs and the pad columns
    const int i = it * kThreads + t, r = i / 16, q = i % 16;
    if (q < kNumRbf)
      hr[r * kHRS + E + q] = r < p.rows && use_dist ? expf(-d2[r] / smem[L.sig + q]) : 0.f;
    else
      for (int c = EF; c < EFP; ++c) hr[r * kHRS + c] = 0.f;
  }
  if (g_aggr != nullptr) {
    for (int i = t; i < p.nodes * (D + 3); i += kThreads) {
      const bool a = i < p.nodes * D;
      const int n = a ? i / D : (i - p.nodes * D) / 3, c = a ? i % D : D + (i - p.nodes * D) % 3;
      const float g = a ? g_aggr[n0 * D + i] : g_xupd[n0 * 3 + i - p.nodes * D];
      float cnt = 0.f;
      for (int k = 0; k < K; ++k) cnt += xr[(n * K + k) * 4 + 3];
      node[n * P + c] = g / fmaxf(cnt, 1.f);
    }
  }
  if (t < p.nodes) {
    float cnt = 0.f;
    for (int k = 0; k < K; ++k) cnt += xr[(t * K + k) * 4 + 3];
    node[t * P + D + 3] = fmaxf(cnt, 1.f);
  }
}

template <int CB>
__device__ __forceinline__ void load_cols(float (&b)[CB], const float* p) {
  if constexpr (CB == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < CB; ++j) b[j] = p[j];
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[a][j] += sum_{k < Kn} A[(ty RB + a) SAM + k SAK] B[k SBK + tx CB + j].
// A row-major (SAK = 1, RB = 4): four depths of a row in one float4, Kn a
// multiple of 4; A k-major (SAM = 1, RB = 4): four rows in one float4; B's
// four columns (CB = 4) in one float4. Otherwise scalar loads.
template <int RB, int CB, int SAM, int SAK, int SBK>
__device__ __forceinline__ void mma(float (&acc)[RB][CB], const float* __restrict__ A,
                                    const float* __restrict__ B, int Kn, int ty, int tx) {
  const float* a0 = A + ty * RB * SAM;
  const float* b0 = B + tx * CB;
  if constexpr (RB == 4 && SAK == 1) {
    for (int k0 = 0; k0 < Kn; k0 += 4) {
      float4 ar[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) ar[i] = *reinterpret_cast<const float4*>(a0 + i * SAM + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[CB];
        load_cols<CB>(b, b0 + (k0 + kk) * SBK);
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < CB; ++j) acc[i][j] = fmaf(lane_of(ar[i], kk), b[j], acc[i][j]);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < Kn; ++k) {
      float a[RB], b[CB];
      if constexpr (RB == 4 && SAM == 1) {
        const float4 v = *reinterpret_cast<const float4*>(a0 + k * SAK);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < RB; ++i) a[i] = a0[i * SAM + k * SAK];
      }
      load_cols<CB>(b, b0 + k * SBK);
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < CB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Rows ty * 4 + a, columns tx * CB + j of a product into a buffer of stride P.
template <int D>
__device__ __forceinline__ void store_rows(float* X, const float (&acc)[4][Dims<D>::CB],
                                           int ty, int tx) {
  constexpr int P = Dims<D>::P, CB = Dims<D>::CB;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* row = X + (ty * 4 + a) * P + tx * CB;
    if constexpr (CB == 4) {
      *reinterpret_cast<float4*>(row) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
#pragma unroll
      for (int j = 0; j < CB; ++j) row[j] = acc[a][j];
    }
  }
}

// The forward up to the coefficient, shared by both kernels, from staged
// rows (X0 = h_src + h_dst): X0 = pre, X1 = act (and the LN mean and rstd
// of each row in stat), msg into X[msg_buf], c1p into X[c1p_buf], coef of
// each row in stat + 2 kRows. No phase writes a buffer that the same phase
// reads, so the forward may put msg over pre (0) and c1p over act (1). The
// caller's barrier after stage_rows comes first; the last phase ends
// without a barrier.
template <int D>
__device__ __forceinline__ void forward_rows(const Layout& L, float* smem, int E, float slope,
                                             int use_ln, float b2c, int msg_buf, int c1p_buf) {
  constexpr int P = Dims<D>::P, CB = Dims<D>::CB;
  constexpr int LPR = Dims<D>::LPR, CPL = Dims<D>::CPL, RG = Dims<D>::RG;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int g = threadIdx.x / LPR, l = threadIdx.x % LPR;
  float* X0 = smem + L.x[0];
  float* X1 = smem + L.x[1];
  const float* vec = smem + L.vec;
  float* stat = smem + L.stat;

  {  // pre = h_src + h_dst + [he | rbf] [Wc; Wd]
    float acc[4][CB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[a][j] = X0[(ty * 4 + a) * P + tx * CB + j];
    mma<4, CB, kHRS, 1, P>(acc, smem + L.hr, smem + L.wcd, ef_pad(E), ty, tx);
    store_rows<D>(X0, acc, ty, tx);
  }
  __syncthreads();
  // act = LN(LeakyReLU(pre)), a row per LPR lanes, rows interleaved
#pragma unroll
  for (int i = 0; i < kRows / RG; ++i) {
    const int r = g + i * RG;
    float a0[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) a0[q] = leaky(X0[r * P + l + LPR * q], slope);
    if (use_ln) {
      const float mean = channel_sum<LPR, CPL>(a0) * (1.f / D);
      float v[CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) v[q] = (a0[q] - mean) * (a0[q] - mean);
      const float rstd = rsqrtf(channel_sum<LPR, CPL>(v) * (1.f / D) + 1e-5f);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = l + LPR * q;
        X1[r * P + c] = (a0[q] - mean) * rstd * vec[c] + vec[D + c];
      }
      if (l == 0) {
        stat[r] = mean;
        stat[kRows + r] = rstd;
      }
    } else {
#pragma unroll
      for (int q = 0; q < CPL; ++q) X1[r * P + l + LPR * q] = a0[q];
    }
  }
  __syncthreads();
  float* M = smem + L.x[msg_buf];
  {  // msg = act W2 + b2
    float acc[4][CB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[a][j] = vec[2 * D + tx * CB + j];
    mma<4, CB, P, 1, P>(acc, X1, smem + L.w2, D, ty, tx);
    store_rows<D>(M, acc, ty, tx);
  }
  __syncthreads();
  float* C = smem + L.x[c1p_buf];
  {  // c1p = msg W1c + b1c
    float acc[4][CB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[a][j] = vec[3 * D + tx * CB + j];
    mma<4, CB, P, 1, P>(acc, M, smem + L.w1c, D, ty, tx);
    store_rows<D>(C, acc, ty, tx);
  }
  __syncthreads();
  // coef = LeakyReLU(c1p) . W2c + b2c
#pragma unroll
  for (int i = 0; i < kRows / RG; ++i) {
    const int r = g + i * RG;
    float t[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = l + LPR * q;
      t[q] = leaky(C[r * P + c], slope) * vec[4 * D + c];
    }
    const float s = channel_sum<LPR, CPL>(t) + b2c;
    if (l == 0) stat[2 * kRows + r] = s;
  }
}

}  // namespace edge
