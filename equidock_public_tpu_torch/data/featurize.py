"""Host-side featurization: residue filtering, local frames, the kNN
residue graph and its RBF + orientation edge features, emitted as
fixed-degree neighbor tables `nbr (N, K)`, `nbr_mask (N, K)` and
`edge_feat (N, K, 27)`; for training, the binding pocket and the random
pose of a sample.

The port's own copy of `equidock_public_tpu/data/featurize.py`
(`build_protein_graph` and its helpers, `extract_pocket`,
`uniform_rotation_translation`). `build_protein_graph` takes the distance
matrix and the kNN tables from the C++ builder (`native/`);
`residue_mean_distance_matrix` and `knn_tables` are their plain numpy
versions, bit-equal, which the tests hold it to. Edge convention: edge k of node i has
source j = nbr[i, k] and destination i, so x_rel = x_j - x_i.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .pdb import GroupedResidue
from .residues import residue_type_index

RBF_LENGTH_SCALES = np.array([1.5 ** x for x in range(15)], dtype=np.float64)
MU_R_SIGMAS = np.array([1.0, 2.0, 5.0, 10.0, 30.0], dtype=np.float64)


@dataclasses.dataclass(eq=False)
class ProteinGraph:
    """Single-protein residue graph with fixed-degree neighbor tables."""

    res_id: np.ndarray        # (N,) int32 residue-type index in [0, 21)
    x: np.ndarray             # (N, 3) float32 CA coordinates
    mu_r_norm: np.ndarray     # (N, 5) float32 surface-awareness features
    nbr: np.ndarray           # (N, K) int32 source-node index per in-edge
    nbr_mask: np.ndarray      # (N, K) bool edge-validity mask
    edge_feat: np.ndarray     # (N, K, 27) float32: 15 RBF + 12 orientation

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]


def filter_residues(residues: Sequence[GroupedResidue]) -> List[GroupedResidue]:
    """Keep residues with exactly one N, one CA and one C atom."""
    out = []
    for res in residues:
        names = res[1]["atom_name"]
        if (np.sum(names == "N") == 1 and np.sum(names == "CA") == 1
                and np.sum(names == "C") == 1):
            out.append(res)
    return out


def alpha_carbon_array(residues: Sequence[GroupedResidue]) -> np.ndarray:
    """(N, 3) CA locations; a zero row is appended when N <= 1."""
    locs = []
    for res in residues:
        names = res[1]["atom_name"]
        locs.append(res[1]["coords"][names == "CA"][0].astype(np.float32))
    if len(locs) <= 1:
        locs.append(np.zeros(3, dtype=np.float32))
    return np.stack(locs, axis=0)


def extract_pocket(lig_ca: np.ndarray, rec_ca: np.ndarray, pos_cutoff: float = 8.0
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Pocket pairs: (ligand CA, receptor CA) closer than `pos_cutoff`; the
    pocket cloud is the pair midpoints. Returns (midpoints, ligand indices,
    receptor indices), or None for <= 3 pairs (the complex is dropped)."""
    d = np.linalg.norm(lig_ca[:, None, :] - rec_ca[None, :, :], axis=-1)
    ai, aj = np.where(d < pos_cutoff)
    if ai.size <= 3:
        return None
    midpoints = 0.5 * (lig_ca[ai] + rec_ca[aj])
    return midpoints.astype(np.float32), ai, aj


def uniform_rotation_translation(rng: np.random.Generator, translation_interval: float
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A uniform random rotation (3, 3) and a translation (1, 3) in a
    random direction with length ~ U(0, interval), drawn from `rng` in the
    JAX package's order, so one seed gives both packages the same pose."""
    from scipy.spatial.transform import Rotation

    rot = Rotation.random(random_state=rng).as_matrix()
    t = rng.standard_normal((1, 3))
    t = t / np.sqrt(np.sum(t * t))
    t = t * rng.uniform(0.0, translation_interval)
    return rot.astype(np.float32), t.astype(np.float32)


def local_frames(residues: Sequence[GroupedResidue]):
    """Per-residue orthonormal frame (n, u, v) from the N/CA/C atoms.
    Returns (ca, n, u, v), each (N, 3) float32, and the per-residue atoms."""
    N = len(residues)
    ca = np.zeros((N, 3), dtype=np.float64)
    nn = np.zeros((N, 3), dtype=np.float64)
    uu = np.zeros((N, 3), dtype=np.float64)
    vv = np.zeros((N, 3), dtype=np.float64)
    atoms: List[np.ndarray] = []
    for i, res in enumerate(residues):
        names = res[1]["atom_name"]
        coords = res[1]["coords"].astype(np.float64)
        atoms.append(coords.astype(np.float32))
        n_loc = coords[names == "N"][0]
        ca_loc = coords[names == "CA"][0]
        c_loc = coords[names == "C"][0]
        u = (n_loc - ca_loc) / np.linalg.norm(n_loc - ca_loc)
        t = (c_loc - ca_loc) / np.linalg.norm(c_loc - ca_loc)
        n_vec = np.cross(u, t)
        n_vec = n_vec / np.linalg.norm(n_vec)
        v = np.cross(n_vec, u)
        ca[i], nn[i], uu[i], vv[i] = ca_loc, n_vec, u, v
    return (ca.astype(np.float32), nn.astype(np.float32),
            uu.astype(np.float32), vv.astype(np.float32), atoms)


def residue_mean_distance_matrix(atoms: List[np.ndarray],
                                 block_atoms: int = 512) -> np.ndarray:
    """(N, N) float32 mean all-atom pairwise distance between residues, +inf
    on the diagonal (mean atom distance, not CA distance).

    Coordinate differences are taken in float32 and squared, rooted and
    summed in float64, so the float32 result matches the JAX package's
    graph builder. Rows are processed in blocks of whole residues, so both
    segment sums are `np.add.reduceat` over contiguous atom runs."""
    counts = np.array([a.shape[0] for a in atoms], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    all_atoms = np.concatenate(atoms, axis=0).astype(np.float32)
    n_res = len(atoms)
    sums = np.zeros((n_res, n_res), dtype=np.float64)
    r0 = 0
    while r0 < n_res:
        r1 = r0 + 1
        while r1 < n_res and offsets[r1 + 1] - offsets[r0] <= block_atoms:
            r1 += 1
        a0, a1 = offsets[r0], offsets[r1]
        diff = (all_atoms[a0:a1, None, :] - all_atoms[None, :, :]).astype(np.float64)
        d = np.sqrt(np.einsum("bac,bac->ba", diff, diff))
        cols = np.add.reduceat(d, offsets[:-1], axis=1)              # (b, n_res)
        sums[r0:r1] = np.add.reduceat(cols, offsets[r0:r1] - a0, axis=0)
        r0 = r1
    mean = (sums / (counts[:, None] * counts[None, :])).astype(np.float32)
    np.fill_diagonal(mean, np.inf)
    return mean


def knn_tables(dist: np.ndarray, cutoff: float, max_neighbor: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For each node all j with dist < cutoff, or the max_neighbor nearest
    when there are more; unused slots self-loop with mask 0."""
    num = dist.shape[0]
    nbr = np.tile(np.arange(num, dtype=np.int32)[:, None], (1, max_neighbor))
    nbr_mask = np.zeros((num, max_neighbor), dtype=bool)
    nbr_dist = np.zeros((num, max_neighbor), dtype=np.float32)
    for i in range(num):
        valid = np.where(dist[i, :] < cutoff)[0]
        if valid.size > max_neighbor:
            valid = np.argsort(dist[i, :])[:max_neighbor]
        k = valid.size
        nbr[i, :k] = valid
        nbr_mask[i, :k] = True
        nbr_dist[i, :k] = dist[i, valid]
    return nbr, nbr_mask, nbr_dist


def build_protein_graph(residues: Sequence[GroupedResidue],
                        cutoff: float = 30.0,
                        max_neighbor: int = 10) -> ProteinGraph:
    """Build the kNN residue graph with all node and edge features (the
    distances and neighbour tables from the C++ builder, `native/`)."""
    from .. import native

    ca, n_i, u_i, v_i, atoms = local_frames(residues)
    num = ca.shape[0]
    if num <= 1:
        raise ValueError("protein contains only 1 residue")
    dist = native.residue_mean_dist(atoms)
    nbr, nbr_mask, nbr_dist = native.knn_edges(dist, cutoff, max_neighbor)

    # Surface-awareness feature mu_r_norm: softmax(-d^2/sigma)-weighted mean
    # of (x_i - x_j) against the weighted mean of their norms, 5 sigmas.
    d64 = nbr_dist.astype(np.float64)
    logits = -(d64[:, None, :] ** 2) / MU_R_SIGMAS[None, :, None]     # (N, 5, K)
    logits = np.where(nbr_mask[:, None, :], logits, -np.inf)
    logits -= np.max(np.where(nbr_mask[:, None, :], logits, -1e30),
                     axis=2, keepdims=True)
    w = np.exp(logits) * nbr_mask[:, None, :]
    wsum = w.sum(axis=2, keepdims=True)
    w = np.divide(w, wsum, out=np.zeros_like(w), where=wsum > 0)
    diff = ca[:, None, :].astype(np.float64) - ca[nbr].astype(np.float64)
    mean_vec = np.einsum("nsk,nkc->nsc", w, diff)
    denom = np.einsum("nsk,nk->ns", w, np.linalg.norm(diff, axis=2))
    ratio = np.divide(np.linalg.norm(mean_vec, axis=2), denom,
                      out=np.ones((num, 5)), where=denom > 0)
    mean_norm = ratio.astype(np.float32)
    mean_norm[nbr_mask.sum(axis=1) == 0] = 1.0

    # Edge features: 15 RBF of the mean-atom distance + the 12-dim relative
    # orientation (p, q, k, t) expressed in the destination's frame.
    rbf = np.exp(-(nbr_dist[..., None] ** 2) / RBF_LENGTH_SCALES).astype(np.float32)
    basis = np.stack([n_i, u_i, v_i], axis=1)                          # (N, 3, 3)
    rel = ca[nbr] - ca[:, None, :]                                     # x_src - x_dst
    p = np.einsum("nab,nkb->nka", basis, rel)
    q = np.einsum("nab,nkb->nka", basis, n_i[nbr])
    kk = np.einsum("nab,nkb->nka", basis, u_i[nbr])
    t = np.einsum("nab,nkb->nka", basis, v_i[nbr])
    ori = np.concatenate([p, q, kk, t], axis=-1).astype(np.float32)
    edge_feat = np.concatenate([rbf, ori], axis=-1) * nbr_mask[..., None]

    res_id = np.array([residue_type_index(r[1]["resname"]) for r in residues],
                      dtype=np.int32)
    return ProteinGraph(res_id=res_id, x=ca.astype(np.float32),
                        mu_r_norm=mean_norm, nbr=nbr, nbr_mask=nbr_mask,
                        edge_feat=edge_feat.astype(np.float32))


def rigid_transform_kabsch(A: np.ndarray, B: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form rigid alignment (R, t) of A onto B, both (3, N):
    minimises ||R A + t - B|| (the JAX package's `rigid_transform_kabsch`;
    numpy on the host, used by the RMSD meter)."""
    if A.shape[0] != 3 or B.shape[0] != 3:
        raise ValueError(f"expected (3, N) point sets, got {A.shape} and {B.shape}")
    centroid_a = A.mean(axis=1, keepdims=True)
    centroid_b = B.mean(axis=1, keepdims=True)
    H = (A - centroid_a) @ (B - centroid_b).T
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        R = (Vt.T @ np.diag([1.0, 1.0, -1.0])) @ U.T
    t = -R @ centroid_a + centroid_b
    return R, t
