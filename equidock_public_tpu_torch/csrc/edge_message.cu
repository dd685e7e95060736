// Fused IEGMN edge step, forward: per-edge messages and their masked means.
//
// Replaces the TPU kernel `_kernel` of equidock_public_tpu/ops/pallas/edge_message.py
// (called through `_fused_call` / `edge_message_aggregate`). For each
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
// Design. One group of D threads (one thread per output channel) handles one
// destination node; a block holds 256 / D groups (4 at D = 64, 16 at D = 16)
// and walks the nodes with a grid-stride loop. The weights (Wc, Wd, W2, W1c,
// W2c, LN and bias vectors, about 45 KB at D=64, E=27) are staged once per
// block in dynamic shared memory. Unlike the TPU, where Mosaic could not gather across vector
// registers, the kernel reads src[nbr] rows itself: no (B, N*K, 3+D)
// gathered tensor reaches device memory. The K edges of a node run in
// sequence; LayerNorm's mean and variance and the coors head's dot product
// are reductions over the group: warp shuffles, then shared memory when a
// group spans several warps (D = 64); at D = 16 a group is half a warp and
// the shuffles run 16 lanes wide, so the two groups of a warp never mix.
// Every product is plain f32 FMA: no TF32, which rounded routed values to
// 6e-3 on the TPU's matrix unit.
//
// Bound on an H100 at N=1024, K=10, D=64, E=27: about 0.22 GFLOP of f32
// FMA (42*D + 2*D*D + D multiply-adds per edge) against 67 TFLOP/s, about
// 3.3 us; the traffic (src, dst, he, nbr, mask, weights, outputs) is about
// 2 MB, under 1 us at 3.35 TB/s. So the kernel is bound by f32 operations.
// Left for a later PR: the per-edge matrix-vector products on tensor cores
// (3xTF32 or bf16x3 splits to keep f32 accuracy), all K edges of a node at
// once instead of in sequence, and fewer block barriers per edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads per block: 256 / D groups of D
constexpr int kNumRbf = 15;
constexpr int kMaxBlocks = 2048;

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

// Warps per group, at least 1: the reduction buffers hold kThreads/D of these
// per buffer.
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

// Floats of shared memory: weights, three reduction buffers, and per group
// act[D], msg[D], he[K*E], rbf[K*15], x_rel[K*3], mask[K], nbr[K].
__host__ __device__ inline int group_floats(int D, int K, int E) {
  return 2 * D + K * E + K * kNumRbf + K * 3 + 2 * K;
}

__host__ __device__ inline int smem_floats(int D, int K, int E) {
  const int groups = kThreads / D;
  return E * D + kNumRbf * D + 2 * D * D + 5 * D + 3 * groups * group_warps(D) +
         groups * group_floats(D, K, E);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
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
                        int B, int Nsrc, int N, int K, int E,
                        float slope, int use_ln, int use_dist) {
  constexpr int kGroups = kThreads / D;   // destination nodes in flight per block
  constexpr int kRed = kGroups * group_warps(D);
  extern __shared__ float smem[];
  float* sWc = smem;
  float* sWd = sWc + E * D;
  float* sW2 = sWd + kNumRbf * D;
  float* sW1c = sW2 + D * D;
  float* sW2c = sW1c + D * D;
  float* sLng = sW2c + D;
  float* sLnb = sLng + D;
  float* sB2 = sLnb + D;
  float* sB1c = sB2 + D;
  float* sRed = sB1c + D;                       // [3][kRed]
  float* sGroups = sRed + 3 * kRed;

  const int tid = threadIdx.x;
  const int nthreads = kThreads;
  for (int i = tid; i < E * D; i += nthreads) sWc[i] = Wc[i];
  for (int i = tid; i < kNumRbf * D; i += nthreads) sWd[i] = Wd[i];
  for (int i = tid; i < D * D; i += nthreads) {
    sW2[i] = W2[i];
    sW1c[i] = W1c[i];
  }
  for (int i = tid; i < D; i += nthreads) {
    sW2c[i] = W2c[i];
    sLng[i] = ln_g[i];
    sLnb[i] = ln_b[i];
    sB2[i] = b2[i];
    sB1c[i] = b1c[i];
  }
  const float bias2c = b2c[0];

  const int g = tid / D;          // group = destination node slot
  const int c = tid % D;          // output channel
  float* gAct = sGroups + g * group_floats(D, K, E);
  float* gMsg = gAct + D;
  float* gHe = gMsg + D;
  float* gRbf = gHe + K * E;
  float* gXrel = gRbf + K * kNumRbf;
  float* gMsk = gXrel + K * 3;
  int* gNbr = reinterpret_cast<int*>(gMsk + K);
  float* red_mean = sRed;
  float* red_var = sRed + kRed;
  float* red_coef = sRed + 2 * kRed;

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

    float agg = 0.f, xu = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* src_row = src + ((size_t)b * Nsrc + gNbr[k]) * (3 + D);
      float pre = src_row[3 + c] + dh;
      const float* hek = gHe + k * E;
      for (int e = 0; e < E; ++e) pre = fmaf(hek[e], sWc[e * D + c], pre);
      const float* rk = gRbf + k * kNumRbf;
#pragma unroll
      for (int s = 0; s < kNumRbf; ++s) pre = fmaf(rk[s], sWd[s * D + c], pre);

      float act = leaky(pre, slope);
      if (use_ln) {
        const float mean = group_sum<D>(act, red_mean, g, c) * (1.f / D);
        const float dv = act - mean;
        const float var = group_sum<D>(dv * dv, red_var, g, c) * (1.f / D);
        act = dv * rsqrtf(var + 1e-5f) * sLng[c] + sLnb[c];
      }
      gAct[c] = act;
      __syncthreads();

      float msg = sB2[c];
#pragma unroll 8
      for (int i = 0; i < D; ++i) msg = fmaf(gAct[i], sW2[i * D + c], msg);
      gMsg[c] = msg;
      __syncthreads();

      float c1 = sB1c[c];
#pragma unroll 8
      for (int i = 0; i < D; ++i) c1 = fmaf(gMsg[i], sW1c[i * D + c], c1);
      c1 = leaky(c1, slope);
      const float coef = group_sum<D>(c1 * sW2c[c], red_coef, g, c) + bias2c;

      const float m = gMsk[k];
      agg = fmaf(m, msg, agg);
      if (c < 3) xu = fmaf(m, gXrel[k * 3 + c] * coef, xu);
    }
    if (valid) {
      aggr[(size_t)node * D + c] = agg / cnt;
      if (c < 3) xupd[(size_t)node * 3 + c] = xu / cnt;
    }
  }
}

template <int D>
cudaError_t launch(const float* src, const float* dst, const float* he,
                   const int32_t* nbr, const float* msk, const float* Wc,
                   const float* Wd, const float* ln_g, const float* ln_b,
                   const float* W2, const float* b2, const float* W1c,
                   const float* b1c, const float* W2c, const float* b2c,
                   float* aggr, float* xupd, int B, int Nsrc, int N, int K,
                   int E, float slope, int use_ln, int use_dist,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(D, K, E);
  static size_t configured = 0;   // largest dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_message_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  constexpr int kGroups = kThreads / D;
  int blocks = (B * N + kGroups - 1) / kGroups;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  edge_message_fwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      src, dst, he, nbr, msk, Wc, Wd, ln_g, ln_b, W2, b2, W1c, b1c, W2c, b2c,
      aggr, xupd, B, Nsrc, N, K, E, slope, use_ln, use_dist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous f32 (nbr: int32) arrays:
// src (B, Nsrc, 3+D), dst (B, N, 3+D), he (B, N, K, E), nbr/msk (B, N, K),
// Wc (E, D), Wd (15, D), ln_g/ln_b/b2/b1c (D), W2/W1c (D, D), W2c (D, 1),
// b2c (1); outputs aggr (B, N, D), xupd (B, N, 3). D is 64 (the paper
// models' width) or 16 (the small models'), and K <= D. Returns the
// cudaError_t of the launch.
int equidock_edge_message_fwd(const void* src, const void* dst, const void* he,
                              const void* nbr, const void* msk, const void* Wc,
                              const void* Wd, const void* ln_g, const void* ln_b,
                              const void* W2, const void* b2, const void* W1c,
                              const void* b1c, const void* W2c, const void* b2c,
                              void* aggr, void* xupd, int B, int Nsrc, int N,
                              int K, int D, int E, float slope, int use_ln,
                              int use_dist, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > D) return (int)cudaErrorInvalidValue;
#define EDGE_ARGS                                                            \
  (const float*)src, (const float*)dst, (const float*)he,                    \
      (const int32_t*)nbr, (const float*)msk, (const float*)Wc,              \
      (const float*)Wd, (const float*)ln_g, (const float*)ln_b,              \
      (const float*)W2, (const float*)b2, (const float*)W1c,                 \
      (const float*)b1c, (const float*)W2c, (const float*)b2c,              \
      (float*)aggr, (float*)xupd, B, Nsrc, N, K, E, slope, use_ln, use_dist, \
      (cudaStream_t)stream
  if (D == 64) return (int)launch<64>(EDGE_ARGS);
  if (D == 16) return (int)launch<16>(EDGE_ARGS);
  return (int)cudaErrorInvalidValue;
#undef EDGE_ARGS
}

}  // extern "C"
