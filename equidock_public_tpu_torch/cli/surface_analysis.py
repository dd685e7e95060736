"""Surface-feature check, the port of
`equidock_public_tpu/cli/surface_analysis.py`: the Spearman correlation
between residue depth and each of the five mu_r_norm surface features.

Depth is computed without MSMS. `-depth sas` (default): each atom's
solvent-accessible sphere (vdW radius + 1.4 A probe) sampled on a Fibonacci
lattice, the points no neighbouring atom's sphere occludes kept as the
surface, a residue's depth the mean over its atoms of the distance to the
nearest surface point. `-depth hull`: the distance to the CA convex hull's
nearest face plane.

    python -m equidock_public_tpu_torch.cli.surface_analysis -pdb FILE.pdb [-depth hull]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..data.featurize import build_protein_graph, filter_residues
from ..data.pdb import group_residues, read_pdb

# Bondi vdW radii (A) of the elements of protein PDBs
VDW = {"C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80, "H": 1.20, "P": 1.80, "SE": 1.90}
VDW_DEFAULT = 1.70
PROBE = 1.4


def fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) near-uniform unit directions."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                    axis=-1)


def _atom_radii(elements) -> np.ndarray:
    return np.array([VDW.get(str(e).upper(), VDW_DEFAULT) + PROBE for e in elements])


def sas_surface_points(coords: np.ndarray, radii: np.ndarray, n_sphere: int = 80) -> np.ndarray:
    """The solvent-accessible surface as points: each atom's sphere samples
    that no neighbouring atom's expanded sphere occludes (Shrake-Rupley)."""
    from scipy.spatial import cKDTree

    dirs = fibonacci_sphere(n_sphere)
    tree = cKDTree(coords)
    rmax = float(radii.max())
    out = []
    for i in range(len(coords)):
        pts = coords[i] + radii[i] * dirs
        # only a neighbour j with |c_i - c_j| < r_i + r_j can clip sphere i
        nbrs = [j for j in tree.query_ball_point(coords[i], radii[i] + rmax) if j != i]
        if nbrs:
            d = np.linalg.norm(pts[:, None, :] - coords[nbrs][None, :, :], axis=-1)
            pts = pts[np.all(d >= radii[nbrs][None, :] - 1e-9, axis=1)]
        out.append(pts)
    return np.concatenate(out, axis=0)


def sas_residue_depth(residues, n_sphere: int = 80) -> np.ndarray:
    """Each residue's mean atom distance to the nearest SAS point."""
    from scipy.spatial import cKDTree

    coords = np.concatenate([c["coords"] for _, c in residues]).astype(np.float64)
    elements = np.concatenate([c["element"] for _, c in residues])
    surf = sas_surface_points(coords, _atom_radii(elements), n_sphere)
    depth_atom, _ = cKDTree(surf).query(coords)
    splits = np.cumsum([len(c["coords"]) for _, c in residues])[:-1]
    return np.array([d.mean() for d in np.split(depth_atom, splits)])


def convex_hull_depth(x: np.ndarray) -> np.ndarray:
    """Each point's distance to the nearest face plane of the convex hull
    (0 on the surface, positive inside)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(x.astype(np.float64))
    # hull.equations: rows [n, d] with n.x + d <= 0 inside
    d = x @ hull.equations[:, :3].T + hull.equations[:, 3][None, :]
    return -np.max(d, axis=1)


def analyze(pdb_path: str, cutoff: float = 30.0, max_neighbor: int = 10,
            depth_method: str = "sas") -> List[float]:
    """Spearman's rho of depth against mu_r_norm[:, s], s = 0..4 (sigma 1,
    2, 5, 10, 30)."""
    from scipy.stats import spearmanr

    residues = filter_residues(group_residues(read_pdb(pdb_path)))
    g = build_protein_graph(residues, cutoff, max_neighbor)
    depth = sas_residue_depth(residues) if depth_method == "sas" else convex_hull_depth(g.x)
    return [float(spearmanr(depth, g.mu_r_norm[:, s])[0]) for s in range(5)]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-pdb", required=True)
    p.add_argument("-depth", default="sas", choices=["sas", "hull"])
    a = p.parse_args(argv)
    rhos = analyze(a.pdb, depth_method=a.depth)
    for s, (sigma, rho) in enumerate(zip([1, 2, 5, 10, 30], rhos)):
        print(f"sigma={sigma:>2}: spearman(depth, mu_r_norm[{s}]) = {rho:+.3f}")
    print("(negative correlation expected: buried residues have lower mu_r_norm; strongest "
          "at sigma=30)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
