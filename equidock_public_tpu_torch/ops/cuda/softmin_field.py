"""Soft-min distance field sums, forward and backward: launch wrappers of
the CUDA kernels in `csrc/softmin_field.cu`, which replace `_fwd_kernel` and
`_bwd_kernel` of `equidock_public_tpu/ops/pallas/softmin_field.py`.

    S[b, m] = sum_n a_mask[b, n] exp(-|x[b, m] - a[b, n]|^2 / sigma)

The backward takes the cotangent c (B, M) of S and gives dx (B, M, 3) and
dA (B, N, 3) in one launch (no atomics). Both kernels work on own tiles of
32 x `lane_points` points, each owned by a cluster of `splits` blocks of
`warps` key ranges; the other set's tiles of 32 points that hold a weight
!= 0 are dealt to the key ranges in turn, and the partial sums are added in
a fixed order (`softmin_tile_plan`; the source's head has the design).
`softmin_tiles_fwd` / `softmin_tiles_bwd` emulate that decomposition in
float64 on any device, for the tests. The plain versions, and the autograd
Function that chooses between them and these kernels, are in
`ops/softmin_field.py`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import check_launch, check_tensor, load_library, outputs

KEY_TILE = 32          # points of the other set a tile, one a lane
# The defaults, from scripts/softmin_tiles_check.py's sweep on an H100: own
# tiles of 32 points (one a lane), 8 key ranges a block, and as many blocks
# a cluster as give each key range about RANGE_TILES of the other set's
# tiles (1 at the training batch, 2 at 3072 x 3072).
LANE_POINTS = 1
WARPS = 8
RANGE_TILES = 6
MAX_SPLITS = 8         # blocks of a cluster (the portable cluster size)
# The (lane points, warps) pairs the kernels are built for.
BUILT = tuple((lp, w) for lp in (1, 2, 4) for w in (4, 8, 16))

# Launches of each CUDA kernel in this process (plain-version calls excluded).
launches = 0        # forward
bwd_launches = 0    # backward (one launch computes dx and dA)


class SoftminPlan(NamedTuple):
    lane_points: int   # own points a lane; an own tile holds 32 x lane_points
    warps: int         # key ranges a block
    splits: int        # blocks a cluster, one cluster an own tile
    blocks: int        # the launch's grid

    @property
    def own_tile(self) -> int:
        return 32 * self.lane_points

    @property
    def ranges(self) -> int:
        return self.splits * self.warps


def _tiles(n: int, size: int) -> int:
    return -(-n // size)


def softmin_tile_plan(B: int, M: int, N: int, backward: bool = False, lane_points: int = 0,
                      warps: int = 0, splits: int = 0) -> SoftminPlan:
    """The tiling of a launch at B x M queries and N keys: own tiles of the
    queries (and, backward, of the keys too), each a cluster of `splits`
    blocks of `warps` key ranges. By default as many splits as give each
    key range RANGE_TILES of the other set's tiles (the larger set's,
    backward), MAX_SPLITS at most."""
    lp, w = lane_points or LANE_POINTS, warps or WARPS
    if (lp, w) not in BUILT:
        raise ValueError(f"softmin_field: no kernel for {lp} points a lane, {w} warps "
                         f"(built: {BUILT})")
    own = 32 * lp
    clusters = B * (_tiles(M, own) + (_tiles(N, own) if backward else 0))
    if not splits:
        other = max(_tiles(N, KEY_TILE), _tiles(M, KEY_TILE) if backward else 0)
        splits = min(MAX_SPLITS, _tiles(other, w * RANGE_TILES))
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"softmin_field: {splits} splits, expected 1 to {MAX_SPLITS}")
    return SoftminPlan(lp, w, splits, clusters * splits)


# --------------------------------------------------------------------------- #
# The decomposition, emulated (float64, any device)
# --------------------------------------------------------------------------- #

def kept_tiles(w, size: int) -> torch.Tensor:
    """(B, ceil(n / size)) bool: the tiles of `size` points of each batch
    element's weights w (B, n) that hold a weight != 0."""
    B, n = w.shape
    T = _tiles(n, size)
    return F.pad(w != 0, (0, T * size - n)).reshape(B, T, size).any(dim=-1)


def range_tiles(other_w, ranges: int) -> List[List[List[int]]]:
    """[b][r]: the other-set tiles key range r walks for batch element b, in
    order: its kept tiles dealt to the ranges in turn (kept tile k to range
    k mod `ranges`; range r = rank x warps + warp)."""
    kept = kept_tiles(other_w, KEY_TILE)
    out = []
    for row in kept:
        idx = torch.nonzero(row).flatten().tolist()
        out.append([idx[r::ranges] for r in range(ranges)])
    return out


def _role_sums(own_p, own_w, oth_p, oth_w, sigma: float, plan: SoftminPlan, D: int):
    """(B, n_own, D) float64: for each own point, the sums of its own tile's
    key ranges, warps added in order within a block and the blocks in rank
    order; own tiles whose own weights are all 0 (own_w given) stay 0."""
    B, n_own, _ = own_p.shape
    n_oth = oth_p.shape[1]
    f64 = lambda v: v.to(torch.float64)
    own_p, oth_p, oth_w = f64(own_p), f64(oth_p), f64(oth_w)
    out = torch.zeros(B, n_own, D, dtype=torch.float64, device=own_p.device)
    own_keep = None if own_w is None else kept_tiles(own_w, plan.own_tile)
    for b, ranges in enumerate(range_tiles(oth_w, plan.ranges)):
        d = own_p[b][:, None, :] - oth_p[b][None, :, :]                  # (n_own, n_oth, 3)
        e = torch.exp((d * d).sum(-1) * (-1.0 / sigma)) * oth_w[b]        # (n_own, n_oth)
        terms = e[..., None] if D == 1 else e[..., None] * d
        total = None
        for s in range(plan.splits):
            blk = None
            for w in range(plan.warps):
                keys = [j for t in ranges[s * plan.warps + w]
                        for j in range(t * KEY_TILE, min((t + 1) * KEY_TILE, n_oth))]
                part = terms[:, keys].sum(dim=1)
                blk = part if blk is None else blk + part
            total = blk if total is None else total + blk
        if own_keep is not None:
            rows = own_keep[b].repeat_interleave(plan.own_tile)[:n_own]
            total = total * rows[:, None]
        out[b] = total
    return out


def softmin_tiles_fwd(x, a, a_mask, sigma: float, plan: Optional[SoftminPlan] = None):
    """S (B, M) in float64 through the forward kernel's decomposition."""
    B, M, N = x.shape[0], x.shape[1], a.shape[1]
    plan = plan or softmin_tile_plan(B, M, N)
    return _role_sums(x, None, a, a_mask, sigma, plan, 1)[..., 0]


def softmin_tiles_bwd(x, a, a_mask, c, sigma: float, plan: Optional[SoftminPlan] = None):
    """(dx, dA) in float64 through the backward kernel's decomposition: the
    dx role (own x with c, keys a with a_mask) and the dA role (own a with
    a_mask, queries x with c), each output scaled by -2/sigma times its own
    weight."""
    B, M, N = x.shape[0], x.shape[1], a.shape[1]
    plan = plan or softmin_tile_plan(B, M, N, backward=True)
    c64, m64 = c.to(torch.float64), a_mask.to(torch.float64)
    dx = (-2.0 / sigma) * c64[..., None] * _role_sums(x, c, a, a_mask, sigma, plan, 3)
    da = (-2.0 / sigma) * m64[..., None] * _role_sums(a, a_mask, x, c, sigma, plan, 3)
    return dx, da


# --------------------------------------------------------------------------- #
# The kernels
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library()
    fwd, bwd = lib.equidock_softmin_field_fwd, lib.equidock_softmin_field_bwd
    tail = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.argtypes = [ctypes.c_void_p] * 4 + tail
    bwd.argtypes = [ctypes.c_void_p] * 6 + tail
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_inputs(x, a, a_mask):
    """(B, M, N) after checking the operands both kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"softmin_field: unsupported device {x.device}")
    B, M = x.shape[0], x.shape[1]
    N = a.shape[1]
    dev, f32 = x.device, torch.float32
    check_tensor(x, "x", (B, M, 3), f32, dev)
    check_tensor(a, "a", (B, N, 3), f32, dev)
    check_tensor(a_mask, "a_mask", (B, N), f32, dev)
    return B, M, N


def softmin_field_fwd(x, a, a_mask, sigma: float, plan: Optional[SoftminPlan] = None,
                      out=None) -> torch.Tensor:
    """S (B, M) by the forward kernel, on CUDA operands; `plan`: the tiling
    (default `softmin_tile_plan`); `out`: (S,) to write into, else fresh."""
    B, M, N = _check_inputs(x, a, a_mask)
    plan = plan or softmin_tile_plan(B, M, N)
    (s,) = outputs([(B, M)], x.device, out, "softmin_field")
    with torch.cuda.device(x.device):
        err = _kernel_fns()[0](x.data_ptr(), a.data_ptr(), a_mask.data_ptr(), s.data_ptr(),
                               B, M, N, float(sigma), plan.lane_points, plan.warps,
                               plan.splits, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "softmin_field")
    global launches
    launches += 1
    return s


def softmin_field_bwd(x, a, a_mask, c, sigma: float, plan: Optional[SoftminPlan] = None,
                      out=None):
    """(dx (B, M, 3), dA (B, N, 3)) by the backward kernel for the cotangent
    c (B, M) of S, on CUDA operands; a_mask gets no gradient. `plan` and
    `out` ((dx, dA)) as for the forward."""
    B, M, N = _check_inputs(x, a, a_mask)
    check_tensor(c, "c", (B, M), torch.float32, x.device)
    plan = plan or softmin_tile_plan(B, M, N, backward=True)
    dx, da = outputs([(B, M, 3), (B, N, 3)], x.device, out, "softmin_field bwd")
    with torch.cuda.device(x.device):
        err = _kernel_fns()[1](x.data_ptr(), a.data_ptr(), a_mask.data_ptr(), c.data_ptr(),
                               dx.data_ptr(), da.data_ptr(), B, M, N, float(sigma),
                               plan.lane_points, plan.warps, plan.splits,
                               torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "softmin_field bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, da
