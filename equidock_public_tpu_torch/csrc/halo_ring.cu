// Halo ring of the graph-parallel trunk: the ring exchange (row 8) and the
// both-direction shipment (row 9), for shards that live on one device.
//
// Replaces the TPU kernels `_fwd_kernel` and `_ship2_kernel` of
// equidock_public_tpu/parallel/pallas_halo.py (called through `_call_fwd`
// and `_call_ship2`, `ring_exchange`, `ring_ship` and their VJPs).
//
// Layout. The node axis of each protein is cut into P contiguous shards and
// the batch into G data groups; every shard is a block of one stacked
// tensor on one device, leading dims (G, P), the B / G complexes of a
// group kept as a third dim Bl:
//   exchange: local (G, P, Bl, S, F), snd_next / snd_prev (G, P, Bl, H, F)
//             -> out (G, P, Bl, S + 2H, F) = [local | from prev | from next],
//             from prev = snd_next of shard p - 1 (zeros at p = 0),
//             from next = snd_prev of shard p + 1 (zeros at p = P - 1);
//   ship2:    a (G, P, La), b (G, P, Lb), any trailing widths
//             -> out_p (G, P, La) = a of shard p - 1 (zeros at p = 0),
//                out_n (G, P, Lb) = b of shard p + 1 (zeros at p = P - 1).
// Both are the semantics of `lax.ppermute` over an open chain: the chain
// ends receive zeros, so their receive slots, and in the backward the
// cotangents of rows nobody shipped, are exactly zero.
//
// Synchronisation. The Pallas kernel barriers with its ring neighbours,
// starts two remote DMAs, copies the local block while they fly, waits on
// DMA semaphores and barriers again before exit. Here every shard's send
// buffer is an ordinary device array written by the gather before this
// launch on the same stream, and read by no later kernel before this one
// ends: one launch on one stream orders every read of a send buffer after
// its producer and every write of a receive slot before its consumer.
// Stream order takes the place of the barriers and semaphores; nothing is
// emulated. (Shards on other cards would need NCCL send/recv or peer
// stores; the Python side refuses a mesh of more than one device.)
//
// Design. Pure data movement, no arithmetic, so the outputs equal their
// plain versions bit for bit. Each (g, p, b) block of the output is three
// contiguous regions (S F, H F, H F floats); a grid-stride loop walks the
// output in order, each thread finding its region and source by offset, so
// reads and writes are coalesced. When every region is a multiple of 4
// floats and the pointers are 16-byte aligned, it moves float4s (16-byte
// loads); F = 3 + 64 = 67 is odd, so that holds when S and H are multiples
// of 4, as the bucketed halo widths are; otherwise one float a thread.
//
// Bound on an H100 at the served 512 x 1024 request, gp = 2, padded tier:
// the receptor side moves 2 x 512 x 67 floats of local rows and about
// 4 x 64 x 67 of halo rows in and out, about 0.7 MB: 0.2 us at 3.35 TB/s.
// No operations. Bound by bytes, and at this size by the launch itself
// (a few us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of an H100

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// nblk = G * P * Bl blocks; LS, LH in units of V. Block blk holds shard
// p = (blk / Bl) % P; blk - Bl and blk + Bl are the same complex on the
// shards p - 1 and p + 1 of the same data group.
template <typename V>
__global__ void ring_exchange_kernel(const V* __restrict__ local, const V* __restrict__ snd_next,
                                     const V* __restrict__ snd_prev, V* __restrict__ out,
                                     long long nblk, int P, int Bl, long long LS, long long LH) {
  const long long LT = LS + 2 * LH;
  const long long total = nblk * LT;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long blk = i / LT, o = i - blk * LT;
    const int p = (int)((blk / Bl) % P);
    V v;
    if (o < LS) {
      v = local[blk * LS + o];
    } else if (o < LS + LH) {
      v = p > 0 ? snd_next[(blk - Bl) * LH + (o - LS)] : zero<V>();
    } else {
      v = p < P - 1 ? snd_prev[(blk + Bl) * LH + (o - LS - LH)] : zero<V>();
    }
    out[i] = v;
  }
}

// nblk = G * P shard blocks; La, Lb in units of V.
template <typename V>
__global__ void ring_ship2_kernel(const V* __restrict__ a, const V* __restrict__ b,
                                  V* __restrict__ out_p, V* __restrict__ out_n, long long nblk,
                                  int P, long long La, long long Lb) {
  const long long ta = nblk * La, total = ta + nblk * Lb;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    if (i < ta) {
      const int p = (int)((i / La) % P);
      out_p[i] = p > 0 ? a[i - La] : zero<V>();
    } else {
      const long long j = i - ta;
      const int p = (int)((j / Lb) % P);
      out_n[j] = p < P - 1 ? b[j + Lb] : zero<V>();
    }
  }
}

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays as in the layout above. Returns
// the cudaError_t of the launch.
int equidock_halo_ring_exchange(const void* local, const void* snd_next, const void* snd_prev,
                                void* out, int G, int P, int Bl, int S, int H, int F,
                                void* stream) {
  if (G <= 0 || P <= 0 || Bl <= 0 || S <= 0 || H < 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)G * P * Bl;
  const long long LS = (long long)S * F, LH = (long long)H * F;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (LS % 4 == 0 && LH % 4 == 0 && aligned16(local) && aligned16(snd_next) &&
      aligned16(snd_prev) && aligned16(out)) {
    ring_exchange_kernel<float4><<<grid_for(nblk * (LS + 2 * LH) / 4), kThreads, 0, s>>>(
        static_cast<const float4*>(local), static_cast<const float4*>(snd_next),
        static_cast<const float4*>(snd_prev), static_cast<float4*>(out), nblk, P, Bl, LS / 4,
        LH / 4);
  } else {
    ring_exchange_kernel<float><<<grid_for(nblk * (LS + 2 * LH)), kThreads, 0, s>>>(
        static_cast<const float*>(local), static_cast<const float*>(snd_next),
        static_cast<const float*>(snd_prev), static_cast<float*>(out), nblk, P, Bl, LS, LH);
  }
  return (int)cudaGetLastError();
}

// a (G, P, La), b (G, P, Lb) -> out_p (G, P, La), out_n (G, P, Lb); La, Lb
// in floats, either may be 0 (nothing ships that way).
int equidock_halo_ring_ship2(const void* a, const void* b, void* out_p, void* out_n, int G,
                             int P, long long La, long long Lb, void* stream) {
  if (G <= 0 || P <= 0 || La < 0 || Lb < 0) return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)G * P;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (La % 4 == 0 && Lb % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(out_p) &&
      aligned16(out_n)) {
    ring_ship2_kernel<float4><<<grid_for(nblk * (La + Lb) / 4), kThreads, 0, s>>>(
        static_cast<const float4*>(a), static_cast<const float4*>(b),
        static_cast<float4*>(out_p), static_cast<float4*>(out_n), nblk, P, La / 4, Lb / 4);
  } else {
    ring_ship2_kernel<float><<<grid_for(nblk * (La + Lb)), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out_p),
        static_cast<float*>(out_n), nblk, P, La, Lb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
