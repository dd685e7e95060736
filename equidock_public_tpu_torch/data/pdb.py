"""Minimal fixed-column PDB reader/writer: the port's copy of the parts of
`equidock_public_tpu/data/pdb.py` that inference and the evaluator need.
Only ATOM records are parsed, with the columns the pipeline uses (PDB 3.3
column layout).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class AtomTable:
    """Struct-of-arrays table of ATOM records, in file order."""

    atom_name: np.ndarray      # (A,) str
    resname: np.ndarray        # (A,) str
    chain: np.ndarray          # (A,) str
    residue: np.ndarray        # (A,) int  (residue sequence number)
    insertion: np.ndarray      # (A,) str (insertion code, usually '')
    coords: np.ndarray         # (A, 3) float32
    element: np.ndarray        # (A,) str
    lines: List[str]           # raw ATOM lines (for round-trip writing)

    def __len__(self) -> int:
        return len(self.atom_name)


GroupedResidue = Tuple[Tuple[str, int, str], dict]


def read_pdb(path: str) -> AtomTable:
    atom_name, resname, chain, residue, insertion, coords, element, lines = (
        [], [], [], [], [], [], [], [])
    with open(path, "r") as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            # 1-based columns: 13-16 atom name, 18-20 resname, 22 chain,
            # 23-26 resSeq, 27 iCode, 31-38/39-46/47-54 x/y/z, 77-78 element
            atom_name.append(line[12:16].strip())
            resname.append(line[17:20].strip())
            chain.append(line[21].strip())
            try:
                residue.append(int(line[22:26]))
            except ValueError:
                residue.append(0)
            insertion.append(line[26].strip())
            coords.append((float(line[30:38]), float(line[38:46]),
                           float(line[46:54])))
            element.append(line[76:78].strip() if len(line) >= 78 else "")
            lines.append(line.rstrip("\n"))
    return AtomTable(
        atom_name=np.array(atom_name, dtype=object),
        resname=np.array(resname, dtype=object),
        chain=np.array(chain, dtype=object),
        residue=np.array(residue, dtype=np.int64),
        insertion=np.array(insertion, dtype=object),
        coords=np.array(coords, dtype=np.float32).reshape(-1, 3),
        element=np.array(element, dtype=object),
        lines=lines,
    )


def write_pdb(path: str, table: AtomTable, new_coords: np.ndarray) -> None:
    """Write the table back with replaced coordinates, keeping every other
    column of the original ATOM lines."""
    if new_coords.shape != (len(table), 3):
        raise ValueError(f"coords {new_coords.shape} vs {len(table)} atoms")
    with open(path, "w") as f:
        for i, line in enumerate(table.lines):
            line = line.ljust(80)
            x, y, z = new_coords[i]
            line = line[:30] + f"{x:8.3f}{y:8.3f}{z:8.3f}" + line[54:]
            f.write(line + "\n")
        f.write("END\n")


def group_residues(table: AtomTable) -> List[GroupedResidue]:
    """Group atoms by (chain, residue number, resname), sorted by that key
    (pandas `groupby` order, as the reference uses), NOT sequence order.
    Returns (key, columns) pairs; columns holds 'atom_name', 'coords',
    'element' and 'resname'."""
    order = {}
    for i in range(len(table)):
        key = (table.chain[i], int(table.residue[i]), table.resname[i])
        order.setdefault(key, []).append(i)
    out: List[GroupedResidue] = []
    for key in sorted(order.keys()):
        idx = np.array(order[key], dtype=np.int64)
        out.append((key, {
            "atom_name": table.atom_name[idx],
            "coords": table.coords[idx],
            "element": table.element[idx],
            "resname": key[2],
        }))
    return out


def ca_coords(table: AtomTable) -> np.ndarray:
    """CA atom coordinates in file order (the evaluator's convention)."""
    return table.coords[table.atom_name == "CA"].astype(np.float32)
