// The halo exchange of the graph-parallel trunk as a gather by a fixed
// table: the exchange forward (row 8) and its backward (row 9), for shards
// that live on one device, both sides of a layer in one launch each way.
//
// Replaces the TPU kernels `_fwd_kernel` (the ring exchange) and
// `_ship2_kernel` (the both-direction shipment: the ragged tier's forward,
// the reverse shipment of both VJPs) of
// equidock_public_tpu/parallel/pallas_halo.py, together with the takes, the
// ragged unpack and the residual all_to_all around them
// (equidock_public_tpu/parallel/halo.py::_halo_exchange).
//
// Why a table. The Pallas kernels stage send chunks because a TPU remote
// DMA moves one contiguous VMEM ref to one neighbour chip. Here every shard
// is a block of one stacked tensor on one card, so the receiving shard
// reads the owner's rows where they lie. Composed with the plan, one side's
// whole exchange is a gather: each output slot of [local | from prev |
// from next | residual] names one stacked row b N + n, or -1 for a zero
// (the chain ends, as `lax.ppermute` gives). The table, `src_row` (B, gp,
// Ssrc), and its inverse (order, offsets) in CSR form over the B N stacked
// rows are built once per batch on the host (parallel/halo.py::
// exchange_table) from the plan arrays and pinned to the plain ring
// composition bit for bit.
//
// Layout. Rows live in the folded layout of parallel/mesh.py: block
// blk = (g gp + p) Bl + bl holds complex b = g Bl + bl, shard p (nodes
// p S ... p S + S - 1); folded row blk S + r is stacked row b N + p S + r.
//   forward:  x (B', S, 3), h (B', S, D) -> x_src (B', Ssrc, 3),
//             h_src (B', Ssrc, D), slot (blk, s) = row src_row[b, p, s];
//   backward: g_x (B', Ssrc, 3), g_h (B', Ssrc, D) -> d_x (B', S, 3),
//             d_h (B', S, D), each stacked row the sum of its slots in
//             ascending flat table order (b gp + p) Ssrc + s, from +0.0.
//
// Design. Pure data movement forward (bit-equal to the plain versions),
// fixed-order sums backward (no atomics: the same bits on every launch,
// and the bits of a sequential `index_add_` of the same table on the CPU).
// A group of LPR lanes owns one row; its index is read once. h moves as
// float4 when every h row is whole float4s on 16-byte boundaries, on 16
// lanes (D = 64) or 4 (D <= 16); else one float a lane on 32 lanes. Wider
// rows loop over their columns. x moves as one float on each of three
// lanes. Index arithmetic is 32-bit, per row or per slot, never per
// element, and divides by multiplying with magic numbers computed on the
// host (FastDiv): 12-18% faster than the `/` and `%` of 32-bit ints, both
// kernels at both shapes timed in turns on an H100 (PERF.md). One launch
// takes both sides: the grid's blocks are cut into the two sides' ranges,
// each side a descriptor in the kernel's parameters.
//
// Hot rows. Each shard's row 0 collects every padding slot (65 slots at
// the training batch, 57 at the served receptor, 385 at a forced residual
// tier), so the backward must not walk a list one load at a time. A group
// takes its row's slots B = min(LPR, 16) at a time: each lane reads one
// slot index and finds its cotangent row, the lanes swap them by shuffle,
// every lane loads its columns of all B slots at once, then adds them in
// order. A list of n slots costs ceil(n / B) memory round trips and keeps
// the sequential order exactly; neither chunked partial sums (another
// association) nor a skip of padding slots (which holds only where their
// cotangent is 0) is needed.
//
// Bound on an H100 (3.35 TB/s): by bytes, each input (rows and table) read
// once and each output written once (backward: only the cotangent rows
// some slot reads). Row 8 on both sides of a layer moves 0.93 MB at the
// served 512 x 1024 request (gp = 2) and 6.7 MB at the training batch
// (B = 10, 512 x 512), 0.28 and 2.0 us; a launch and one to a few
// dependent memory round trips a row set the time at these sizes.
//
// Across ranks (the shards of a complex in separate processes, on one card
// or on NVLink peers) the same two gathers run in a peer form: the table
// names (rank, row) and a side's rows come from a device array of the
// group's base pointers, each rank's buffer mapped into the others by CUDA
// IPC (equidock_ipc_*). The backward sums in the same order, so the peer
// form gives the stacked form's bits. Bound as above, by bytes; the host
// barriers around each exchange (parallel/halo.py) cost far more.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSides = 2;
constexpr int kBatch = 16;   // slots a round trip of the backward

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by one multiply-high: with
// l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1, n / d =
// (umulhi(n, m) + n) >> l (Granlund and Montgomery); the sum stays below
// 2^32 since umulhi(n, m) < n.
struct FastDiv {
  int d;
  unsigned m;
  int l;
};

FastDiv make_div(int d) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  const unsigned m = (unsigned)((((1ull << 32) * ((1ull << l) - (unsigned long long)d)) /
                                 (unsigned long long)d) + 1);
  return FastDiv{d, m, l};
}

__device__ __forceinline__ int div_(int n, const FastDiv& f) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.l);
}

// One side of a launch. Forward: in_x, in_h are x, h; out_x, out_h are
// x_src, h_src; src_row set. Backward: in_x, in_h are g_x, g_h; out_x,
// out_h are d_x, d_h; order and offsets set.
struct Side {
  const float* in_x;
  const float* in_h;
  float* out_x;
  float* out_h;
  const int* src_row;
  const int* order;
  const int* offsets;
  int S, N, Ssrc, D, P, Bl;
  FastDiv by_S, by_N, by_Ssrc, by_Bl, by_PBl, by_PSsrc;
  int rows;       // rows this side's groups own
  int blocks;     // this side's blocks of the grid
};

struct Sides {
  Side s[kMaxSides];
};

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The side this block works for and its block index within the side.
__device__ __forceinline__ Side pick_side(const Sides& sides, int& bid) {
  bid = blockIdx.x;
  if (bid < sides.s[0].blocks) return sides.s[0];
  bid -= sides.s[0].blocks;
  return sides.s[1];
}

// Folded block -> (complex b, shard p).
__device__ __forceinline__ void block_of(const Side& sd, int blk, int& b, int& p) {
  const int g = div_(blk, sd.by_PBl), rem = blk - g * (sd.P * sd.Bl);
  p = div_(rem, sd.by_Bl);
  b = g * sd.Bl + (rem - p * sd.Bl);
}

// Complex b, shard p -> folded block (g P + p) Bl + bl.
__device__ __forceinline__ int folded_block(const Side& sd, int b, int p) {
  const int g = div_(b, sd.by_Bl);
  return (g * sd.P + p) * sd.Bl + (b - g * sd.Bl);
}

// Stacked row b N + n -> folded row blk S + r.
__device__ __forceinline__ int folded_row(const Side& sd, int v) {
  const int b = div_(v, sd.by_N), n = v - b * sd.N;
  const int p = div_(n, sd.by_S);
  return folded_block(sd, b, p) * sd.S + (n - p * sd.S);
}

// Flat table slot (b P + p) Ssrc + s -> its folded position blk Ssrc + s.
__device__ __forceinline__ int slot_pos(const Side& sd, int q) {
  const int b = div_(q, sd.by_PSsrc), rem = q - b * (sd.P * sd.Ssrc);
  const int p = div_(rem, sd.by_Ssrc);
  return folded_block(sd, b, p) * sd.Ssrc + (rem - p * sd.Ssrc);
}

// Row 8: one group of LPR lanes copies one output slot.
template <typename V, int LPR>
__global__ void __launch_bounds__(kThreads) exchange_fwd_kernel(const Sides sides) {
  int bid;
  const Side sd = pick_side(sides, bid);
  const int lane = threadIdx.x & (LPR - 1);
  const int row = bid * (kThreads / LPR) + threadIdx.x / LPR;
  if (row >= sd.rows) return;
  const int blk = div_(row, sd.by_Ssrc), s = row - blk * sd.Ssrc;
  int b, p;
  block_of(sd, blk, b, p);
  const int v = __ldg(sd.src_row + (b * sd.P + p) * sd.Ssrc + s);
  const int src = v >= 0 ? folded_row(sd, v) : 0;
  constexpr int W = sizeof(V) / sizeof(float);
  const int DV = sd.D / W;
  const V* hin = reinterpret_cast<const V*>(sd.in_h) + (size_t)src * DV;
  V* hout = reinterpret_cast<V*>(sd.out_h) + (size_t)row * DV;
  for (int c = lane; c < DV; c += LPR) hout[c] = v >= 0 ? __ldg(hin + c) : vzero<V>();
  if (lane < 3) sd.out_x[row * 3 + lane] = v >= 0 ? __ldg(sd.in_x + src * 3 + lane) : 0.f;
}

// Row 9: one group of LPR lanes sums one local row's slots in order. Every
// row has its local slot, at a position known without a load, and most
// rows have no other: its cotangent is loaded with the row's offsets, so
// such a row costs one memory round trip. Longer lists go kBatch slots at
// a time: each of the first kBatch lanes holds one slot's position (the
// next batch's slots are fetched while this one loads), the lanes swap
// them by shuffle, every lane loads its columns of all kBatch slots (lanes
// past the list load the local slot again, so no load waits on a
// predicate), then adds them in order.
template <typename V, int LPR>
__global__ void __launch_bounds__(kThreads) exchange_bwd_kernel(const Sides sides) {
  constexpr int B = kBatch < LPR ? kBatch : LPR;
  int bid;
  const Side sd = pick_side(sides, bid);
  const int lane = threadIdx.x & (LPR - 1);
  const int row = bid * (kThreads / LPR) + threadIdx.x / LPR;
  if (row >= sd.rows) return;          // the whole group leaves together
  const unsigned gmask =
      LPR == 32 ? 0xffffffffu : ((1u << LPR) - 1) << ((threadIdx.x & 31) & ~(LPR - 1));
  const int blk = div_(row, sd.by_S), r = row - blk * sd.S;
  int b, p;
  block_of(sd, blk, b, p);
  const int v = b * sd.N + p * sd.S + r, local = blk * sd.Ssrc + r;
  const int beg = __ldg(sd.offsets + v), end = __ldg(sd.offsets + v + 1);
  constexpr int W = sizeof(V) / sizeof(float);
  const int DV = sd.D / W;
  const V* gh = reinterpret_cast<const V*>(sd.in_h);
  for (int c0 = 0; c0 < DV; c0 += LPR) {     // the first pass also sums x on lanes 0-2
    const int c = c0 + lane;
    const bool has_h = c < DV, do_x = c0 == 0 && lane < 3;
    const V lv = has_h ? __ldg(gh + (size_t)local * DV + c) : vzero<V>();
    const float lx = do_x ? __ldg(sd.in_x + local * 3 + lane) : 0.f;
    V acc = vzero<V>();
    float acc_x = 0.f;
    if (end - beg == 1) {                    // the local slot alone
      vadd(acc, lv);
      acc_x += lx;
    } else {
      int mine = lane < B && beg + lane < end ? slot_pos(sd, __ldg(sd.order + beg + lane)) : local;
      for (int k0 = beg; k0 < end; k0 += B) {
        const int n = min(B, end - k0), kn = k0 + B + lane;
        const int qn = lane < B && kn < end ? __ldg(sd.order + kn) : -1;
        V val[B];
        float val_x[B];
#pragma unroll
        for (int u = 0; u < B; ++u) {
          const int pos = __shfl_sync(gmask, mine, u, LPR);
          val[u] = has_h ? __ldg(gh + (size_t)pos * DV + c) : vzero<V>();
          val_x[u] = do_x ? __ldg(sd.in_x + pos * 3 + lane) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < B; ++u) {
          if (u < n) {
            vadd(acc, val[u]);
            acc_x += val_x[u];
          }
        }
        mine = qn >= 0 ? slot_pos(sd, qn) : local;
      }
    }
    if (has_h) reinterpret_cast<V*>(sd.out_h)[(size_t)row * DV + c] = acc;
    if (do_x) sd.out_x[row * 3 + lane] = acc_x;
  }
}

// ---------------------------------------------------------------------------
// The peer form: the shards of one complex are processes (ranks), each
// with its rows in a buffer of its own, and the group's buffers mapped into
// every rank by CUDA IPC (the port's counterpart of the Pallas RDMA ring:
// the receiving rank reads the owner's rows where they lie, on one card or
// across NVLink peers). A side's descriptor holds a device array of gp
// base pointers, the rank's own buffer among them.
//   forward:  slot r of this rank's [local | from prev | from next |
//             residual] view, r = bl Ssrc + s, reads peer_row[r] =
//             q (Bl S) + bl' S + n, row bl' S + n of rank q's x and h rows,
//             or writes zeros where it is -1;
//   backward: local row r = bl S + n of this rank sums, in ascending
//             table order (b, p, s), the cotangent slots that read it:
//             order[offsets[r] .. offsets[r + 1]) = p (Bl Ssrc) + pos, slot
//             pos of rank p's cotangent buffer, from +0.0. The same order
//             as the stacked backward's, so the same bits.
// The ranks bracket each launch with host barriers (parallel/halo.py):
// the peers' rows are written before it reads them and stay until it ends.
struct PeerSide {
  const float* const* in_x;   // gp base pointers: x rows (forward) or g_x slots
  const float* const* in_h;   // gp base pointers: h rows or g_h slots
  float* out_x;
  float* out_h;
  const int* peer_row;        // forward table (Bl Ssrc,)
  const int* order;           // backward inverse
  const int* offsets;
  int D;
  FastDiv by_span;            // rows a rank holds: Bl S forward, Bl Ssrc backward
  int rows;
  int blocks;
};

struct PeerSides {
  PeerSide s[kMaxSides];
};

__device__ __forceinline__ PeerSide pick_peer_side(const PeerSides& sides, int& bid) {
  bid = blockIdx.x;
  if (bid < sides.s[0].blocks) return sides.s[0];
  bid -= sides.s[0].blocks;
  return sides.s[1];
}

// Row 8, peer form: one group of LPR lanes copies one output slot.
template <typename V, int LPR>
__global__ void __launch_bounds__(kThreads) peer_fwd_kernel(const PeerSides sides) {
  int bid;
  const PeerSide sd = pick_peer_side(sides, bid);
  const int lane = threadIdx.x & (LPR - 1);
  const int row = bid * (kThreads / LPR) + threadIdx.x / LPR;
  if (row >= sd.rows) return;
  const int v = __ldg(sd.peer_row + row);
  const int q = v >= 0 ? div_(v, sd.by_span) : 0;
  const int src = v >= 0 ? v - q * sd.by_span.d : 0;
  constexpr int W = sizeof(V) / sizeof(float);
  const int DV = sd.D / W;
  const V* hin = reinterpret_cast<const V*>(sd.in_h[q]) + (size_t)src * DV;
  V* hout = reinterpret_cast<V*>(sd.out_h) + (size_t)row * DV;
  for (int c = lane; c < DV; c += LPR) hout[c] = v >= 0 ? hin[c] : vzero<V>();
  if (lane < 3) sd.out_x[row * 3 + lane] = v >= 0 ? sd.in_x[q][src * 3 + lane] : 0.f;
}

// Row 9, peer form: one group of LPR lanes sums one local row's slots, in
// order, each from the buffer of the rank that holds it.
template <typename V, int LPR>
__global__ void __launch_bounds__(kThreads) peer_bwd_kernel(const PeerSides sides) {
  int bid;
  const PeerSide sd = pick_peer_side(sides, bid);
  const int lane = threadIdx.x & (LPR - 1);
  const int row = bid * (kThreads / LPR) + threadIdx.x / LPR;
  if (row >= sd.rows) return;
  const int beg = __ldg(sd.offsets + row), end = __ldg(sd.offsets + row + 1);
  constexpr int W = sizeof(V) / sizeof(float);
  const int DV = sd.D / W;
  for (int c0 = 0; c0 < DV; c0 += LPR) {     // the first pass also sums x on lanes 0-2
    const int c = c0 + lane;
    const bool has_h = c < DV, do_x = c0 == 0 && lane < 3;
    V acc = vzero<V>();
    float acc_x = 0.f;
    for (int k = beg; k < end; ++k) {
      const int e = __ldg(sd.order + k);
      const int q = div_(e, sd.by_span), pos = e - q * sd.by_span.d;
      if (has_h) vadd(acc, reinterpret_cast<const V*>(sd.in_h[q])[(size_t)pos * DV + c]);
      if (do_x) acc_x += sd.in_x[q][pos * 3 + lane];
    }
    if (has_h) reinterpret_cast<V*>(sd.out_h)[(size_t)row * DV + c] = acc;
    if (do_x) sd.out_x[row * 3 + lane] = acc_x;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ptrs: 7 a side (in_x, in_h: device arrays of gp pointers; out_x, out_h,
// peer_row, order, offsets); dims: 6 a side (D, span, rows, blocks, lpr,
// vec), (lpr, vec) as for the stacked form.
int fill_peer_sides(int n, void* const* ptrs, const int* dims, bool backward, PeerSides& sides,
                    int& grid, int& lpr, int& vec) {
  if (n < 1 || n > kMaxSides) return (int)cudaErrorInvalidValue;
  sides = PeerSides{};
  grid = 0;
  lpr = dims[4];
  vec = dims[5];
  if (!(vec == 4 && (lpr == 4 || lpr == 16)) && !(vec == 1 && lpr == 32))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    PeerSide& s = sides.s[i];
    void* const* p = ptrs + 7 * i;
    const int* d = dims + 6 * i;
    s.in_x = static_cast<const float* const*>(p[0]);
    s.in_h = static_cast<const float* const*>(p[1]);
    s.out_x = static_cast<float*>(p[2]);
    s.out_h = static_cast<float*>(p[3]);
    s.peer_row = static_cast<const int*>(p[4]);
    s.order = static_cast<const int*>(p[5]);
    s.offsets = static_cast<const int*>(p[6]);
    s.D = d[0];
    const int span = d[1];
    s.rows = d[2], s.blocks = d[3];
    if (s.D <= 0 || s.D % vec || span <= 0 || s.rows <= 0 || s.blocks <= 0 || d[4] != lpr ||
        d[5] != vec || (long long)s.blocks * (kThreads / lpr) < s.rows ||
        (long long)span * (s.D > 3 ? s.D : 3) >= (1ll << 31) ||
        (long long)s.rows * (s.D > 3 ? s.D : 3) >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    if (s.in_x == nullptr || s.in_h == nullptr ||
        (backward ? (s.order == nullptr || s.offsets == nullptr) : s.peer_row == nullptr))
      return (int)cudaErrorInvalidValue;
    if (vec == 4 && !aligned16(s.out_h)) return (int)cudaErrorInvalidValue;
    s.by_span = make_div(span);
    grid += s.blocks;
  }
  if (n == 1) sides.s[1] = sides.s[0], sides.s[1].blocks = 0;
  return 0;
}

template <typename V, int LPR>
void launch_peer(bool backward, int grid, const PeerSides& sides, cudaStream_t st) {
  if (backward)
    peer_bwd_kernel<V, LPR><<<grid, kThreads, 0, st>>>(sides);
  else
    peer_fwd_kernel<V, LPR><<<grid, kThreads, 0, st>>>(sides);
}

int run_peer(int n, void* const* ptrs, const int* dims, bool backward, void* stream) {
  PeerSides sides;
  int grid, lpr, vec;
  if (int err = fill_peer_sides(n, ptrs, dims, backward, sides, grid, lpr, vec)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    launch_peer<float, 32>(backward, grid, sides, st);
  else if (lpr == 4)
    launch_peer<float4, 4>(backward, grid, sides, st);
  else
    launch_peer<float4, 16>(backward, grid, sides, st);
  return (int)cudaGetLastError();
}

// ptrs: 7 a side (in_x, in_h, out_x, out_h, src_row, order, offsets);
// dims: 11 a side (Bp, S, N, Ssrc, D, P, Bl, lpr, vec, rows, blocks), lpr
// the lanes a row and vec the floats of an h load, both the same on every
// side: (lpr, vec) is (4, 4), (16, 4) or (32, 1), the variants built.
// Checks what the kernels assume.
int fill_sides(int n, void* const* ptrs, const int* dims, bool backward, Sides& sides,
               int& grid, int& lpr, int& vec) {
  if (n < 1 || n > kMaxSides) return (int)cudaErrorInvalidValue;
  sides = Sides{};
  grid = 0;
  lpr = dims[7];
  vec = dims[8];
  if (!(vec == 4 && (lpr == 4 || lpr == 16)) && !(vec == 1 && lpr == 32))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    Side& s = sides.s[i];
    void* const* p = ptrs + 7 * i;
    const int* d = dims + 11 * i;
    s.in_x = static_cast<const float*>(p[0]);
    s.in_h = static_cast<const float*>(p[1]);
    s.out_x = static_cast<float*>(p[2]);
    s.out_h = static_cast<float*>(p[3]);
    s.src_row = static_cast<const int*>(p[4]);
    s.order = static_cast<const int*>(p[5]);
    s.offsets = static_cast<const int*>(p[6]);
    const int Bp = d[0];
    s.S = d[1], s.N = d[2], s.Ssrc = d[3], s.D = d[4], s.P = d[5], s.Bl = d[6];
    s.rows = d[9], s.blocks = d[10];
    if (Bp <= 0 || s.S <= 0 || s.P <= 0 || s.Bl <= 0 || Bp % (s.P * s.Bl) ||
        s.N != s.S * s.P || s.Ssrc < s.S || s.D <= 0 || s.D % vec || d[7] != lpr ||
        d[8] != vec || s.blocks <= 0 || s.rows != Bp * (backward ? s.S : s.Ssrc) ||
        (long long)s.blocks * (kThreads / lpr) < s.rows ||
        (long long)Bp * s.Ssrc * (s.D > 3 ? s.D : 3) >= (1ll << 31) ||
        (long long)(Bp / s.P) * s.N >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    if (backward ? (s.order == nullptr || s.offsets == nullptr) : s.src_row == nullptr)
      return (int)cudaErrorInvalidValue;
    if (vec == 4 && (!aligned16(s.in_h) || !aligned16(s.out_h))) return (int)cudaErrorInvalidValue;
    s.by_S = make_div(s.S), s.by_N = make_div(s.N), s.by_Ssrc = make_div(s.Ssrc);
    s.by_Bl = make_div(s.Bl), s.by_PBl = make_div(s.P * s.Bl);
    s.by_PSsrc = make_div(s.P * s.Ssrc);
    grid += s.blocks;
  }
  if (n == 1) sides.s[1] = sides.s[0], sides.s[1].blocks = 0;
  return 0;
}

template <typename V, int LPR>
void launch(bool backward, int grid, const Sides& sides, cudaStream_t st) {
  if (backward)
    exchange_bwd_kernel<V, LPR><<<grid, kThreads, 0, st>>>(sides);
  else
    exchange_fwd_kernel<V, LPR><<<grid, kThreads, 0, st>>>(sides);
}

int run(int n, void* const* ptrs, const int* dims, bool backward, void* stream) {
  Sides sides;
  int grid, lpr, vec;
  if (int err = fill_sides(n, ptrs, dims, backward, sides, grid, lpr, vec)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    launch<float, 32>(backward, grid, sides, st);
  else if (lpr == 4)
    launch<float4, 4>(backward, grid, sides, st);
  else
    launch<float4, 16>(backward, grid, sides, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row 8 on n (1 or 2) sides in one launch. Device pointers to contiguous
// f32 arrays and int32 tables as in the layout above; `ptrs` and `dims`
// are host arrays (see fill_sides). Returns the cudaError_t of the launch.
int equidock_halo_exchange(int n, void* const* ptrs, const int* dims, void* stream) {
  return run(n, ptrs, dims, false, stream);
}

// Row 9 on n (1 or 2) sides in one launch, as row 8.
int equidock_halo_exchange_bwd(int n, void* const* ptrs, const int* dims, void* stream) {
  return run(n, ptrs, dims, true, stream);
}

// Row 8, peer form, on n (1 or 2) sides in one launch (see PeerSide).
int equidock_halo_peer_exchange(int n, void* const* ptrs, const int* dims, void* stream) {
  return run_peer(n, ptrs, dims, false, stream);
}

// Row 9, peer form.
int equidock_halo_peer_exchange_bwd(int n, void* const* ptrs, const int* dims, void* stream) {
  return run_peer(n, ptrs, dims, true, stream);
}

// CUDA IPC of the peer buffers. `ptr` names the base of a device
// allocation (the caller adds its own offsets); `handle` is 64 bytes
// (cudaIpcMemHandle_t). A handle is opened only in another process than the
// one that made it; the mapping lives until equidock_ipc_close.
int equidock_ipc_handle(void* ptr, void* handle) {
  if (sizeof(cudaIpcMemHandle_t) != 64) return (int)cudaErrorInvalidValue;
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

int equidock_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int equidock_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

}  // extern "C"
