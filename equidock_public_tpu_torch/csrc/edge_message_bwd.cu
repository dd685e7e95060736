// Fused IEGMN edge step, backward: every cotangent of the forward in
// csrc/edge_message.cu, from a recompute of the forward.
//
// Replaces the TPU kernel `_bwd_kernel` of equidock_public_tpu/ops/pallas/edge_message.py
// (called through `_fused_bwd_call`, `edge_message_aggregate(fused_bwd=True)`).
// Given the cotangents g_aggr (B, N, D) and g_xupd (B, N, 3) of the forward's
// outputs, for each destination node i and in-edge k from j = nbr[i, k]
// (mask m, cnt = max(sum_k m, 1)) it recomputes pre, the LayerNorm
// statistics, msg, c1p and coef, then walks back:
//   g_msg  = m g_aggr / cnt + W1c (g_c1p),  g_c1p = leaky'(c1p) g_coef W2c,
//   g_coef = m (g_xupd / cnt) . x_rel,      g_act = W2 g_msg,
//   g_pre  = leaky'(pre) LN'(g_act),        g_x_rel = m (g_xupd / cnt) coef
//                                                    + 2 x_rel g_d2,
//   g_d2   = sum_s (Wd g_pre)_s rbf_s (-1 / 1.5^s).
// Outputs: per edge dgx (B, N*K, 3) = g_x_rel and dgh (B, N*K, D) = g_pre
// (the cotangents of the gathered src rows; `equidock_edge_scatter_src`
// below sums them onto src), dhe (B, N*K, E) = Wc g_pre; per node ddx (B, N, 3)
// = -sum_k g_x_rel and ddh (B, N, D) = sum_k g_pre; and per block partial
// sums of the ten parameter gradients (Wc, Wd, ln_g, ln_b, W2, b2, W1c,
// b1c, W2c, b2c), which the caller sums over blocks. Nothing per edge is
// kept from the forward.
//
// Design. The forward's mapping: a group of D threads (one per channel)
// owns a destination node, kGroups = 256 / D groups per block (4 at D = 64,
// 16 at D = 16) walk the nodes with a grid-stride loop, and the K edges of a
// node run in sequence, the groups in lockstep. Group reductions are as in
// the forward: 16-lane shuffles at D = 16, where a group is half a warp. Weights sit in dynamic shared memory with rows padded to D + 1
// floats, so both W x (thread c reads column c) and W^T y (thread c reads
// row c) are free of bank conflicts. The weight gradients are the design
// question: dW2 and dW1c are D x D sums of outer products over all edges.
// Each block keeps ONE copy of every parameter gradient in registers,
// spread over its 256 threads: thread (g, c) owns column c of the rows
// g, g + kGroups, g + 2 kGroups, ... of each gradient matrix (at D = 64:
// 16 rows of dW2 and of dW1c, up to 8 of dWc, 4 of dWd; at D = 16: 1 row
// of dW2 and of dW1c, up to 2 of dWc, 1 of dWd), and after each edge step
// adds the rank-kGroups update of all its groups' edges: every entry has
// one owner, so there are no atomics and the sums run in a fixed order.
// Vector gradients (ln_g, ln_b, b2, b1c, W2c, b2c) are summed per group and
// merged through shared memory at the end. Each block writes its partials
// once; the caller sums them (deterministic, no global atomics), as the JAX
// package sums its per-block partials. d_src, the transpose of the gather,
// is the second kernel of this file: one thread per (src row, channel)
// walks that row's in-edges in ascending edge order, through the inverse
// neighbour list (a stable sort of the flat neighbour rows) the caller
// builds, so it too has one owner per entry and a fixed summation order.
// Every output is bit-reproducible from run to run.
// Masked edges and idle group slots carry zero cotangents, so they add
// nothing. All plain f32 FMA, no TF32.
//
// Bound on an H100 at B=10, N=512, K=10, D=64, E=27 (51 200 edges, all
// unmasked): per edge the recompute is 2(42 D + 2 D^2 + D) and the walk back
// 2(4 D^2 + 2 E D + 2 * 15 D + 3 D) operations, about 60 kFLOP, so 3.1 GFLOP
// in all: 46 us at 67 TFLOP/s. It writes the per-edge cotangents (about
// 19 MB) and reads about 27 MB: 14 us at 3.35 TB/s. So it is bound by f32
// operations. Left for a later PR: the per-edge products on tensor cores,
// several edges of a node at once, fewer block barriers per edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads per block: 256 / D groups of D
constexpr int kNumRbf = 15;
constexpr int kMaxE = 32;        // edge-feature width the dWc ownership covers

// 1.5^s, exact in binary32 for s < 15
__constant__ float kRbfSigma[kNumRbf] = {
    1.0f, 1.5f, 2.25f, 3.375f, 5.0625f, 7.59375f, 11.390625f, 17.0859375f,
    25.62890625f, 38.443359375f, 57.6650390625f, 86.49755859375f,
    129.746337890625f, 194.6195068359375f, 291.92926025390625f};

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

// Sum over aligned runs of `width` lanes (a power of two up to 32).
template <int width>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, width);
  return v;
}

// Warps per group, at least 1.
__host__ __device__ constexpr int group_warps(int D) { return D >= 32 ? D / 32 : 1; }

// Sum of v over the D threads of group g. At D >= 32 through `red`
// (256/D * D/32 floats) and a barrier, so every thread of the block must
// call it; at D < 32 the group lies inside one warp and shuffles suffice.
template <int D>
__device__ __forceinline__ float group_sum(float v, float* red, int g, int c) {
  if constexpr (D < 32) {
    return warp_sum<D>(v);
  } else {
    constexpr int W = D / 32;
    v = warp_sum<32>(v);
    if ((c & 31) == 0) red[g * W + (c >> 5)] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) t += red[g * W + w];
    return t;
  }
}

// Per group: act, msg, g_c1p, g_msg, g_pre [D]; g_rbf [16]; he [K*E];
// rbf [K*15]; x_rel [K*3]; mask [K]; nbr [K]. At least 6 * D: the final
// merge of the six vector gradients reuses the group buffers.
__host__ __device__ inline int group_floats(int D, int K, int E) {
  const int n = 5 * D + 16 + K * E + K * kNumRbf + K * 3 + 2 * K;
  return n > 6 * D ? n : 6 * D;
}

// Weights with padded rows, five reduction buffers, the groups.
__host__ __device__ inline int smem_floats(int D, int K, int E) {
  const int groups = kThreads / D;
  return (E + kNumRbf + 2 * D) * (D + 1) + 5 * D + 5 * groups * group_warps(D) +
         groups * group_floats(D, K, E);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
edge_message_bwd_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                        const float* __restrict__ he, const int32_t* __restrict__ nbr,
                        const float* __restrict__ msk, const float* __restrict__ Wc,
                        const float* __restrict__ Wd, const float* __restrict__ ln_g,
                        const float* __restrict__ ln_b, const float* __restrict__ W2,
                        const float* __restrict__ b2, const float* __restrict__ W1c,
                        const float* __restrict__ b1c, const float* __restrict__ W2c,
                        const float* __restrict__ b2c, const float* __restrict__ g_aggr,
                        const float* __restrict__ g_xupd, float* __restrict__ dgx,
                        float* __restrict__ dgh, float* __restrict__ dhe,
                        float* __restrict__ ddx, float* __restrict__ ddh,
                        float* __restrict__ pWc, float* __restrict__ pWd,
                        float* __restrict__ pLng, float* __restrict__ pLnb,
                        float* __restrict__ pW2, float* __restrict__ pB2,
                        float* __restrict__ pW1c, float* __restrict__ pB1c,
                        float* __restrict__ pW2c, float* __restrict__ pB2c, int B,
                        int Nsrc, int N, int K, int E, float slope, int use_ln,
                        int use_dist) {
  constexpr int kGroups = kThreads / D;        // destination nodes in flight per block
  constexpr int kRed = kGroups * group_warps(D);
  constexpr int P = D + 1;                     // padded row stride of the weights
  constexpr int T = kThreads;
  constexpr int kRowsD = D / kGroups;          // rows of a D x D gradient per thread
  constexpr int kRowsE = kMaxE / kGroups;
  constexpr int kRowsS = (kNumRbf + kGroups - 1) / kGroups;
  extern __shared__ float smem[];
  float* sWc = smem;
  float* sWd = sWc + E * P;
  float* sW2 = sWd + kNumRbf * P;
  float* sW1c = sW2 + D * P;
  float* sW2c = sW1c + D * P;
  float* sLng = sW2c + D;
  float* sLnb = sLng + D;
  float* sB2 = sLnb + D;
  float* sB1c = sB2 + D;
  float* sRed = sB1c + D;                      // [5][kRed]
  float* sGroups = sRed + 5 * kRed;

  const int tid = threadIdx.x;
  for (int i = tid; i < E * D; i += T) sWc[(i / D) * P + i % D] = Wc[i];
  for (int i = tid; i < kNumRbf * D; i += T) sWd[(i / D) * P + i % D] = Wd[i];
  for (int i = tid; i < D * D; i += T) {
    sW2[(i / D) * P + i % D] = W2[i];
    sW1c[(i / D) * P + i % D] = W1c[i];
  }
  for (int i = tid; i < D; i += T) {
    sW2c[i] = W2c[i];
    sLng[i] = ln_g[i];
    sLnb[i] = ln_b[i];
    sB2[i] = b2[i];
    sB1c[i] = b1c[i];
  }
  const float bias2c = b2c[0];

  const int g = tid / D;          // group = destination node slot
  const int c = tid % D;          // channel
  const int gf = group_floats(D, K, E);
  float* gAct = sGroups + g * gf;
  float* gMsg = gAct + D;
  float* gGc1p = gMsg + D;
  float* gGmsg = gGc1p + D;
  float* gGpre = gGmsg + D;
  float* gGrbf = gGpre + D;
  float* gHe = gGrbf + 16;
  float* gRbf = gHe + K * E;
  float* gXrel = gRbf + K * kNumRbf;
  float* gMsk = gXrel + K * 3;
  int* gNbr = reinterpret_cast<int*>(gMsk + K);
  float* red_mean = sRed;
  float* red_var = sRed + kRed;
  float* red_coef = sRed + 2 * kRed;
  float* red_m1 = sRed + 3 * kRed;
  float* red_m2 = sRed + 4 * kRed;
  // group g2's buffer at offset `off` (0: act, 1: msg, ...) of its block
  auto grp = [&](int g2, int off) { return sGroups + g2 * gf + off * D; };

  // Parameter-gradient accumulators owned by this thread: entry (row, c)
  // with row = g + kGroups * r.
  float aW2[kRowsD], aW1c[kRowsD], aWc[kRowsE], aWd[kRowsS];
#pragma unroll
  for (int r = 0; r < kRowsD; ++r) aW2[r] = aW1c[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsE; ++r) aWc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsS; ++r) aWd[r] = 0.f;
  // This group's share of the vector gradients at channel c.
  float aLng = 0.f, aLnb = 0.f, aB2 = 0.f, aB1c = 0.f, aW2c = 0.f, aB2c = 0.f;

  const int total = B * N;
  const int stride = gridDim.x * kGroups;
  const int n_iter = (total + stride - 1) / stride;
  for (int it = 0; it < n_iter; ++it) {
    const int node = it * stride + blockIdx.x * kGroups + g;
    const bool valid = node < total;
    const int nd = valid ? node : total - 1;    // idle slots recompute a real node
    const int b = nd / N;
    const float* dst_row = dst + (size_t)nd * (3 + D);

    __syncthreads();   // the previous node's readers are done with the group's buffers
    const float* he_n = he + (size_t)nd * K * E;
    for (int i = c; i < K * E; i += D) gHe[i] = he_n[i];
    if (c < K) {
      const int j = nbr[(size_t)nd * K + c];
      gNbr[c] = j;
      gMsk[c] = msk[(size_t)nd * K + c];
      const float* src_row = src + ((size_t)b * Nsrc + j) * (3 + D);
      const float x0 = src_row[0] - dst_row[0];
      const float x1 = src_row[1] - dst_row[1];
      const float x2 = src_row[2] - dst_row[2];
      gXrel[c * 3 + 0] = x0;
      gXrel[c * 3 + 1] = x1;
      gXrel[c * 3 + 2] = x2;
      const float d2 = x0 * x0 + x1 * x1 + x2 * x2;
#pragma unroll
      for (int s = 0; s < kNumRbf; ++s)
        gRbf[c * kNumRbf + s] = use_dist ? expf(-d2 / kRbfSigma[s]) : 0.f;
    }
    __syncthreads();

    const float dh = dst_row[3 + c];
    float cnt = 0.f;
    for (int k = 0; k < K; ++k) cnt += gMsk[k];
    cnt = fmaxf(cnt, 1.f);
    // cotangents of this node's outputs, already divided by cnt; zero for idle slots
    const float ga = valid ? g_aggr[(size_t)nd * D + c] / cnt : 0.f;
    float gxu[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) gxu[d] = valid ? g_xupd[(size_t)nd * 3 + d] / cnt : 0.f;

    float acc_ddh = 0.f, acc_ddx = 0.f;
    for (int k = 0; k < K; ++k) {
      // ---- forward recompute (as csrc/edge_message.cu) ----
      const float* src_row = src + ((size_t)b * Nsrc + gNbr[k]) * (3 + D);
      float pre = src_row[3 + c] + dh;
      const float* hek = gHe + k * E;
      for (int e = 0; e < E; ++e) pre = fmaf(hek[e], sWc[e * P + c], pre);
      const float* rk = gRbf + k * kNumRbf;
#pragma unroll
      for (int s = 0; s < kNumRbf; ++s) pre = fmaf(rk[s], sWd[s * P + c], pre);

      const float a0 = leaky(pre, slope);
      float act = a0, nrm = 0.f, rstd = 0.f;
      if (use_ln) {
        const float mean = group_sum<D>(a0, red_mean, g, c) * (1.f / D);
        const float dv = a0 - mean;
        const float var = group_sum<D>(dv * dv, red_var, g, c) * (1.f / D);
        rstd = rsqrtf(var + 1e-5f);
        nrm = dv * rstd;
        act = nrm * sLng[c] + sLnb[c];
      }
      gAct[c] = act;
      __syncthreads();

      float msg = sB2[c];
#pragma unroll 8
      for (int i = 0; i < D; ++i) msg = fmaf(gAct[i], sW2[i * P + c], msg);
      gMsg[c] = msg;
      __syncthreads();

      float c1p = sB1c[c];
#pragma unroll 8
      for (int i = 0; i < D; ++i) c1p = fmaf(gMsg[i], sW1c[i * P + c], c1p);
      const float c1 = leaky(c1p, slope);
      const float coef = group_sum<D>(c1 * sW2c[c], red_coef, g, c) + bias2c;

      // ---- backward ----
      const float m = valid ? gMsk[k] : 0.f;
      const float xr0 = gXrel[k * 3 + 0], xr1 = gXrel[k * 3 + 1], xr2 = gXrel[k * 3 + 2];
      const float g_coef = m * (gxu[0] * xr0 + gxu[1] * xr1 + gxu[2] * xr2);
      aW2c = fmaf(c1, g_coef, aW2c);
      aB2c += g_coef;
      const float g_c1p = g_coef * sW2c[c] * (c1p >= 0.f ? 1.f : slope);
      aB1c += g_c1p;
      gGc1p[c] = g_c1p;
      __syncthreads();

      // dW1c += msg^T g_c1p over the block's kGroups edges
#pragma unroll
      for (int r = 0; r < kRowsD; ++r) {
        const int i = g + kGroups * r;
        float s = 0.f;
#pragma unroll
        for (int g2 = 0; g2 < kGroups; ++g2) s = fmaf(grp(g2, 1)[i], grp(g2, 2)[c], s);
        aW1c[r] += s;
      }
      float g_msg = m * ga;
#pragma unroll 8
      for (int o = 0; o < D; ++o) g_msg = fmaf(gGc1p[o], sW1c[c * P + o], g_msg);
      aB2 += g_msg;
      gGmsg[c] = g_msg;
      __syncthreads();

      // dW2 += act^T g_msg
#pragma unroll
      for (int r = 0; r < kRowsD; ++r) {
        const int i = g + kGroups * r;
        float s = 0.f;
#pragma unroll
        for (int g2 = 0; g2 < kGroups; ++g2) s = fmaf(grp(g2, 0)[i], grp(g2, 3)[c], s);
        aW2[r] += s;
      }
      float g_act = 0.f;
#pragma unroll 8
      for (int o = 0; o < D; ++o) g_act = fmaf(gGmsg[o], sW2[c * P + o], g_act);

      float g_a0 = g_act;
      if (use_ln) {
        aLng = fmaf(g_act, nrm, aLng);
        aLnb += g_act;
        const float g_nrm = g_act * sLng[c];
        const float m1 = group_sum<D>(g_nrm, red_m1, g, c) * (1.f / D);
        const float m2 = group_sum<D>(g_nrm * nrm, red_m2, g, c) * (1.f / D);
        g_a0 = rstd * (g_nrm - m1 - nrm * m2);
      }
      const float g_pre = g_a0 * (pre >= 0.f ? 1.f : slope);
      gGpre[c] = g_pre;
      acc_ddh += g_pre;
      const size_t edge = (size_t)nd * K + k;
      if (valid) dgh[edge * D + c] = g_pre;
      __syncthreads();

      // dWc += he^T g_pre and dWd += rbf^T g_pre over the block's edges
#pragma unroll
      for (int r = 0; r < kRowsE; ++r) {
        const int e = g + kGroups * r;
        if (e < E) {
          float s = 0.f;
#pragma unroll
          for (int g2 = 0; g2 < kGroups; ++g2) {
            const float* hk = sGroups + g2 * gf + 5 * D + 16 + k * E;
            s = fmaf(hk[e], grp(g2, 4)[c], s);
          }
          aWc[r] += s;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsS; ++r) {
        const int s_ = g + kGroups * r;
        if (s_ < kNumRbf) {
          float s = 0.f;
#pragma unroll
          for (int g2 = 0; g2 < kGroups; ++g2) {
            const float* rb = sGroups + g2 * gf + 5 * D + 16 + K * E + k * kNumRbf;
            s = fmaf(rb[s_], grp(g2, 4)[c], s);
          }
          aWd[r] += s;
        }
      }
      // dhe = Wc g_pre (items q < E) and the rbf terms of g_d2 (items
      // E <= q < E + 15), item q on thread q mod D of the group
      for (int q = c; q < E + kNumRbf; q += D) {
        if (q < E) {
          float s = 0.f;
#pragma unroll 8
          for (int o = 0; o < D; ++o) s = fmaf(gGpre[o], sWc[q * P + o], s);
          if (valid) dhe[edge * E + q] = s;
        } else {
          const int s_ = q - E;
          float s = 0.f;
#pragma unroll 8
          for (int o = 0; o < D; ++o) s = fmaf(gGpre[o], sWd[s_ * P + o], s);
          gGrbf[s_] = s * gRbf[k * kNumRbf + s_] * (-1.f / kRbfSigma[s_]);
        }
      }
      __syncthreads();
      if (c < 3) {
        float g_d2 = 0.f;
#pragma unroll
        for (int s = 0; s < kNumRbf; ++s) g_d2 += gGrbf[s];
        const float xr = c == 0 ? xr0 : (c == 1 ? xr1 : xr2);
        const float gx = m * gxu[c] * coef + 2.f * xr * g_d2;
        acc_ddx -= gx;
        if (valid) dgx[edge * 3 + c] = gx;
      }
    }
    if (valid) {
      ddh[(size_t)node * D + c] = acc_ddh;
      if (c < 3) ddx[(size_t)node * 3 + c] = acc_ddx;
    }
  }

  // ---- this block's partial parameter gradients ----
  const size_t blk = blockIdx.x;
#pragma unroll
  for (int r = 0; r < kRowsD; ++r) {
    const int i = g + kGroups * r;
    pW2[(blk * D + i) * D + c] = aW2[r];
    pW1c[(blk * D + i) * D + c] = aW1c[r];
  }
#pragma unroll
  for (int r = 0; r < kRowsE; ++r) {
    const int e = g + kGroups * r;
    if (e < E) pWc[(blk * E + e) * D + c] = aWc[r];
  }
#pragma unroll
  for (int r = 0; r < kRowsS; ++r) {
    const int s = g + kGroups * r;
    if (s < kNumRbf) pWd[(blk * kNumRbf + s) * D + c] = aWd[r];
  }
  __syncthreads();     // the group buffers are free: merge the vector gradients
  float* vec = sGroups;                         // [6][kGroups][D]
  const float mine[6] = {aLng, aLnb, aB2, aB1c, aW2c, aB2c};
#pragma unroll
  for (int q = 0; q < 6; ++q) vec[(q * kGroups + g) * D + c] = mine[q];
  __syncthreads();
  if (g == 0) {
    float sum[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      sum[q] = 0.f;
      for (int g2 = 0; g2 < kGroups; ++g2) sum[q] += vec[(q * kGroups + g2) * D + c];
    }
    pLng[blk * D + c] = sum[0];
    pLnb[blk * D + c] = sum[1];
    pB2[blk * D + c] = sum[2];
    pB1c[blk * D + c] = sum[3];
    pW2c[blk * D + c] = sum[4];
    if (c == 0) {
      // every thread of a group holds the same g_coef sum; take channel 0's
      float s = 0.f;
      for (int g2 = 0; g2 < kGroups; ++g2) s += vec[(5 * kGroups + g2) * D];
      pB2c[blk] = s;
    }
  }
}

template <int D>
cudaError_t launch(const float* src, const float* dst, const float* he, const int32_t* nbr,
                   const float* msk, const float* Wc, const float* Wd, const float* ln_g,
                   const float* ln_b, const float* W2, const float* b2, const float* W1c,
                   const float* b1c, const float* W2c, const float* b2c,
                   const float* g_aggr, const float* g_xupd, float* dgx, float* dgh,
                   float* dhe, float* ddx, float* ddh, float* pWc, float* pWd,
                   float* pLng, float* pLnb, float* pW2, float* pB2, float* pW1c,
                   float* pB1c, float* pW2c, float* pB2c, int B, int Nsrc, int N, int K,
                   int E, float slope, int use_ln, int use_dist, int blocks,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(D, K, E);
  static size_t configured = 0;   // largest dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_message_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  edge_message_bwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      src, dst, he, nbr, msk, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c, b2c, g_aggr,
      g_xupd, dgx, dgh, dhe, ddx, ddh, pWc, pWd, pLng, pLnb, pW2, pB2, pW1c, pB1c, pW2c,
      pB2c, B, Nsrc, N, K, E, slope, use_ln, use_dist);
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
// equidock_edge_message_fwd, plus g_aggr (B, N, D) and g_xupd (B, N, 3).
// Outputs: dgx (B, N*K, 3), dgh (B, N*K, D), dhe (B, N*K, E), ddx (B, N, 3),
// ddh (B, N, D), and per block (`blocks` of them, the grid size) the
// partials pWc (blocks, E, D), pWd (blocks, 15, D), pLng/pLnb/pB2/pB1c/pW2c
// (blocks, D), pW2/pW1c (blocks, D, D), pB2c (blocks). D is 64 or 16,
// K <= D, E <= 32, and `blocks` is the caller's grid size: at most
// ceil(B * N / (256 / D)). Returns the cudaError_t of the launch.
int equidock_edge_message_bwd(const void* src, const void* dst, const void* he,
                              const void* nbr, const void* msk, const void* Wc,
                              const void* Wd, const void* ln_g, const void* ln_b,
                              const void* W2, const void* b2, const void* W1c,
                              const void* b1c, const void* W2c, const void* b2c,
                              const void* g_aggr, const void* g_xupd, void* dgx, void* dgh,
                              void* dhe, void* ddx, void* ddh, void* pWc, void* pWd,
                              void* pLng, void* pLnb, void* pW2, void* pB2, void* pW1c,
                              void* pB1c, void* pW2c, void* pB2c, int B, int Nsrc, int N,
                              int K, int D, int E, float slope, int use_ln, int use_dist,
                              int blocks, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > D || E <= 0 || E > kMaxE || blocks <= 0)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS                                                                        \
  (const float*)src, (const float*)dst, (const float*)he, (const int32_t*)nbr,          \
      (const float*)msk, (const float*)Wc, (const float*)Wd, (const float*)ln_g,        \
      (const float*)ln_b, (const float*)W2, (const float*)b2, (const float*)W1c,        \
      (const float*)b1c, (const float*)W2c, (const float*)b2c, (const float*)g_aggr,    \
      (const float*)g_xupd, (float*)dgx, (float*)dgh, (float*)dhe, (float*)ddx,         \
      (float*)ddh, (float*)pWc, (float*)pWd, (float*)pLng, (float*)pLnb, (float*)pW2,   \
      (float*)pB2, (float*)pW1c, (float*)pB1c, (float*)pW2c, (float*)pB2c, B, Nsrc, N, \
      K, E, slope, use_ln, use_dist, blocks, (cudaStream_t)stream
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
