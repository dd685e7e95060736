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
// Design. Both kernels keep the forward's layout (csrc/cross_attention.cu).
// dQ: a block owns kRows query rows (q and dO rows staged in shared
// memory), its kWarps warps split the keys in 32-key chunks; per chunk each
// lane holds one key row, then one value row, in registers and scores them
// against the block's rows (broadcast reads), giving ds for 32 keys at once;
// then the warp walks the chunk's keys, reading each key row from global
// memory (coalesced) and adding ds * k into per-lane channel accumulators.
// dK/dV: the same with the roles swapped: a block owns kRows key rows (k and
// v staged), the warps split the queries, each lane holds one query row and
// then one dO row, and the warp adds ds * q and w * dO into per-lane channel
// accumulators. At the end the kWarps partial sums of each row meet in
// shared memory, in a fixed order: no atomics, deterministic. All in f32
// FMA, no TF32. Widths up to DP = 64 or 96 lanes (layer 0 is 69 wide).
//
// Bound on an H100 at B=10, N=M=512, D=Dv=64, all pairs kept: dQ does
// 2 * B*N*M * (2D + Dv) = 1.0 GFLOP (15 us at 67 TFLOP/s), dK/dV
// 2 * B*N*M * 2(D + Dv) = 1.3 GFLOP (20 us); each moves under 10 MB
// (3 us at 3.35 TB/s), so both are bound by f32 operations. The logits
// are recomputed in each kernel instead of being stored: an (N, M) matrix
// per complex would cost more bytes than the products cost time. Left for
// a later PR: the products on tensor cores (3xTF32 splits keep f32
// accuracy) and one fused kernel that computes ds once for both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;                  // rows a block owns
constexpr int kWarps = 8;                 // warps per block, splitting the other axis
constexpr int kThreads = 32 * kWarps;

// Shared memory: the block's rows twice ([2][kRows][DP]: q and dO, or k
// and v), then per warp a chunk [32][DP + 1] (padded: 32 lanes reading 32
// rows hit 32 banks). The final merge reuses the chunks.
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
cross_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ q_tag,
                           const float* __restrict__ k_tag, const float* __restrict__ lse,
                           const float* __restrict__ dout, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int N, int M,
                           int D, int Dv) {
  extern __shared__ float smem[];
  constexpr int C = DP / 32;
  float* sK = smem;                        // [kRows][DP] key rows
  float* sV = smem + kRows * DP;           // [kRows][DP] value rows
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
    const int r = i / DP, d = i % DP, m = row0 + r;
    sK[i] = m < M && d < D ? k[(size_t)m * D + d] : 0.f;
    sV[i] = m < M && d < Dv ? v[(size_t)m * Dv + d] : 0.f;
  }
  float kt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) kt[r] = row0 + r < M ? k_tag[(size_t)b * M + row0 + r] : 0.f;
  __syncthreads();

  float acc_k[kRows][C], acc_v[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < C; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  for (int i0 = warp * 32; i0 < N; i0 += kWarps * 32) {
    const int n = i0 + lane;
    const bool in = n < N;
    const float qt = in ? q_tag[(size_t)b * N + n] : 0.f;
    const float ls = in ? lse[(size_t)b * N + n] : 0.f;
    const float dl = in ? delta[(size_t)b * N + n] : 0.f;
    float row[DP];
    float s[kRows], w[kRows], ds[kRows];

    stage_chunk<DP>(chunk, q, i0, N, D, lane);
#pragma unroll
    for (int d = 0; d < DP; ++d) row[d] = chunk[lane * (DP + 1) + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dot_row<DP>(sK + r * DP, row);

    stage_chunk<DP>(chunk, dout, i0, N, Dv, lane);
#pragma unroll
    for (int d = 0; d < DP; ++d) row[d] = chunk[lane * (DP + 1) + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dw = dot_row<DP>(sV + r * DP, row);
      const bool mk = qt > 0.f && qt == kt[r];
      w[r] = in ? expf((mk ? s[r] : -1000.f) - ls) : 0.f;
      ds[r] = in && mk ? w[r] * (dw - dl) : 0.f;
    }

    const int ni = min(32, N - i0);
    for (int ii = 0; ii < ni; ++ii) {
      const float* q_row = q + (size_t)(i0 + ii) * D;
      const float* o_row = dout + (size_t)(i0 + ii) * Dv;
      float qq[C], oo[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int d = lane + 32 * i;
        qq[i] = d < D ? q_row[d] : 0.f;
        oo[i] = d < Dv ? o_row[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], ii);
        const float wj = __shfl_sync(0xffffffffu, w[r], ii);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          acc_k[r][i] = fmaf(dsj, qq[i], acc_k[r][i]);
          acc_v[r][i] = fmaf(wj, oo[i], acc_v[r][i]);
        }
      }
    }
  }
  float* part = smem + 2 * kRows * DP;
  merge_store<DP>(part, acc_k, dk + (size_t)b * M * D, row0, M, D, warp, lane);
  merge_store<DP>(part, acc_v, dv + (size_t)b * M * Dv, row0, M, Dv, warp, lane);
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
                       const float* delta, float* dk, float* dv, int B, int N, int M, int D,
                       int Dv, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats(DP);
  static bool configured = false;
  cudaError_t err = allow_smem(cross_attention_dkv_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kRows - 1) / kRows, B);
  cross_attention_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, q_tag, k_tag, lse, dout, delta, dk, dv, N, M, D, Dv);
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

// As above; outputs dk (B, M, D) and dv (B, M, Dv).
int equidock_cross_attention_dkv(const void* q, const void* k, const void* v,
                                 const void* q_tag, const void* k_tag, const void* lse,
                                 const void* dout, const void* delta, void* dk, void* dv,
                                 int B, int N, int M, int D, int Dv, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || Dv <= 0) return (int)cudaErrorInvalidValue;
  const int w = D > Dv ? D : Dv;
#define DKV_ARGS                                                                   \
  (const float*)q, (const float*)k, (const float*)v, (const float*)q_tag,          \
      (const float*)k_tag, (const float*)lse, (const float*)dout,                  \
      (const float*)delta, (float*)dk, (float*)dv, B, N, M, D, Dv,                 \
      (cudaStream_t)stream
  if (w <= 64) return (int)launch_dkv<64>(DKV_ARGS);
  if (w <= 96) return (int)launch_dkv<96>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
