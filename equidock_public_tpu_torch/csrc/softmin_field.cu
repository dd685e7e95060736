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
// |x - a|^2 = |x|^2 + |a|^2 - 2 x.a to use one thin MXU product. Here one
// thread owns one point and the other set streams through shared memory in
// tiles of 1024 points packed as float4 (16 KB), every block of the batch
// element reading the same tiles. The difference x - a is taken directly:
// on coordinates of tens of A the expanded form cancels about 1e-3 A^2 in
// f32, the direct one does not. Keys with mask 0 add exactly 0 and are
// skipped (the test is the same for all threads of a warp). `expf` and an
// IEEE division, as the plain version computes them; no fast-math
// intrinsics.
//
// The TPU backward accumulates dA across query blocks in one output block
// (the grid runs in order on one core). Blocks on the card run in no order,
// so dA is not summed across blocks: the backward is ONE launch whose grid
// holds two kinds of block, independent of each other. A query block (one
// thread per query m) recomputes w over all keys and writes dx_m; a key
// block (one thread per key n) recomputes w over all queries and writes
// dA_n. Every output has one owner that sums in a fixed order: no atomics,
// bit-reproducible. Queries with c = 0 (padded or masked rows) add nothing
// and are skipped in the key blocks.
//
// Bound on an H100 at the training batch (B = 10, M = N = 512, about 170
// of 512 points valid a side): forward about 12 f32 operations a (query,
// valid key) pair, one of them the exponential, so 10 x 512 x 170 pairs
// x 12 = 10 MFLOP, 0.16 us at 67 TFLOP/s; the bytes (x, a, a_mask in, S
// out: about 0.2 MB) take 0.06 us at 3.35 TB/s. The backward recomputes w
// twice and adds three multiply-adds a pair in each pass: about 34
// operations a pair, 0.45 us. Both are bound by operations; at that size
// a launch (a few us) costs more than the arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // points per block, one a thread
constexpr int kTile = 1024;     // points of the other set per shared-memory tile

// Copy points [t0, t0 + n) of p (n, 3) with their weights w (n) into tile.
__device__ __forceinline__ void load_tile(float4* tile, const float* __restrict__ p,
                                          const float* __restrict__ w, int t0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* q = p + (size_t)(t0 + i) * 3;
    tile[i] = make_float4(q[0], q[1], q[2], w[t0 + i]);
  }
}

__global__ void __launch_bounds__(kThreads)
softmin_field_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ am, float* __restrict__ S, int M,
                         int N, float sigma) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = m < M;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (valid) {
    const float* xr = x + ((size_t)b * M + m) * 3;
    x0 = xr[0];
    x1 = xr[1];
    x2 = xr[2];
  }
  const float* ab = a + (size_t)b * N * 3;
  const float* mb = am + (size_t)b * N;
  float total = 0.f;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int n = min(kTile, N - t0);
    __syncthreads();                  // the previous tile's readers are done
    load_tile(tile, ab, mb, t0, n);
    __syncthreads();
    float part = 0.f;                 // per-tile partial: shorter f32 sums
    for (int i = 0; i < n; ++i) {
      const float4 p = tile[i];
      if (p.w == 0.f) continue;
      const float d0 = x0 - p.x, d1 = x1 - p.y, d2 = x2 - p.z;
      part += p.w * expf(-(d0 * d0 + d1 * d1 + d2 * d2) / sigma);
    }
    total += part;
  }
  if (valid) S[(size_t)b * M + m] = total;
}

// Blocks [0, qblocks) of grid.x: queries -> dx. Blocks [qblocks, ...): keys -> dA.
__global__ void __launch_bounds__(kThreads)
softmin_field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ am, const float* __restrict__ c,
                         float* __restrict__ dx, float* __restrict__ dA, int M, int N,
                         float sigma, int qblocks) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const bool query_role = (int)blockIdx.x < qblocks;
  // own point p (x_m with c_m, or a_n with a_mask_n); the other set q streams
  const int own = (query_role ? blockIdx.x : blockIdx.x - qblocks) * kThreads + threadIdx.x;
  const int n_own = query_role ? M : N;
  const int n_other = query_role ? N : M;
  const float* own_p = query_role ? x + (size_t)b * M * 3 : a + (size_t)b * N * 3;
  const float* own_w = query_role ? c + (size_t)b * M : am + (size_t)b * N;
  const float* oth_p = query_role ? a + (size_t)b * N * 3 : x + (size_t)b * M * 3;
  const float* oth_w = query_role ? am + (size_t)b * N : c + (size_t)b * M;
  const bool valid = own < n_own;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, pw = 0.f;
  if (valid) {
    p0 = own_p[(size_t)own * 3 + 0];
    p1 = own_p[(size_t)own * 3 + 1];
    p2 = own_p[(size_t)own * 3 + 2];
    pw = own_w[own];
  }
  // sum over the other set of weight_q exp(-d^2 / sigma) (x_m - a_n), with
  // weight_q the key's mask (query role) or the query's cotangent (key role)
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t0 = 0; t0 < n_other; t0 += kTile) {
    const int n = min(kTile, n_other - t0);
    __syncthreads();
    load_tile(tile, oth_p, oth_w, t0, n);
    __syncthreads();
    if (pw == 0.f) continue;          // this thread's output is 0 (still loads tiles)
    float u0 = 0.f, u1 = 0.f, u2 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float4 q = tile[i];
      if (q.w == 0.f) continue;
      const float d0 = p0 - q.x, d1 = p1 - q.y, d2 = p2 - q.z;
      const float w = q.w * expf(-(d0 * d0 + d1 * d1 + d2 * d2) / sigma);
      u0 = fmaf(w, d0, u0);
      u1 = fmaf(w, d1, u1);
      u2 = fmaf(w, d2, u2);
    }
    s0 += u0;
    s1 += u1;
    s2 += u2;
  }
  if (!valid) return;
  // d = own - other. Query role, own x_m: dx_m = (-2/sigma) c_m s. Key role,
  // own a_n, d = a_n - x_m: dA_n = (2/sigma) mask_n sum_m c_m e (x_m - a_n)
  // = (-2/sigma) mask_n s. So both scale s by -2/sigma times their weight.
  const float f = -2.f / sigma * pw;
  float* out = (query_role ? dx + (size_t)b * M * 3 : dA + (size_t)b * N * 3) + (size_t)own * 3;
  out[0] = f * s0;
  out[1] = f * s1;
  out[2] = f * s2;
}

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays: x (B, M, 3), a (B, N, 3),
// a_mask (B, N); output S (B, M). Returns the cudaError_t of the launch.
int equidock_softmin_field_fwd(const void* x, const void* a, const void* a_mask, void* S,
                               int B, int M, int N, float sigma, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || B > 65535 || !(sigma > 0.f))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  softmin_field_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)a_mask, (float*)S, M, N, sigma);
  return (int)cudaGetLastError();
}

// As above plus the cotangent c (B, M) of S; outputs dx (B, M, 3) and
// dA (B, N, 3). One launch: query blocks and key blocks side by side.
int equidock_softmin_field_bwd(const void* x, const void* a, const void* a_mask,
                               const void* c, void* dx, void* dA, int B, int M, int N,
                               float sigma, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || B > 65535 || !(sigma > 0.f))
    return (int)cudaErrorInvalidValue;
  const int qblocks = (M + kThreads - 1) / kThreads;
  const int kblocks = (N + kThreads - 1) / kThreads;
  const dim3 grid(qblocks + kblocks, B);
  softmin_field_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)a_mask, (const float*)c, (float*)dx,
      (float*)dA, M, N, sigma, qblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
