"""Minimal fixed-column PDB reader/writer: the port's copy of
`equidock_public_tpu/data/pdb.py`. Only ATOM records are parsed, with the
columns the pipeline uses (PDB 3.3 column layout). `write_pdb_renumbered`
writes the frozen test sets (residue and atom numbers from 1);
`build_atom_table` makes a table of raw fields (DIPS pair frames).
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


def _regen_ids(values: np.ndarray) -> np.ndarray:
    """Number consecutive runs of equal values 1, 2, 3, ..."""
    out = np.empty(len(values), dtype=np.int64)
    cur_id, cur_val = 1, values[0]
    for i, v in enumerate(values):
        if v != cur_val:
            cur_val = v
            cur_id += 1
        out[i] = cur_id
    return out


def write_pdb_renumbered(path: str, table: AtomTable, new_coords: np.ndarray) -> None:
    """`write_pdb` with atom serials 1, 2, ... and residues numbered from 1
    in file order (a new residue wherever chain, number or insertion code
    changes), as the frozen test sets are written."""
    if new_coords.shape != (len(table), 3):
        raise ValueError(f"coords {new_coords.shape} vs {len(table)} atoms")
    res_ids = _regen_ids(np.array(
        [f"{table.chain[i]}|{table.residue[i]}|{table.insertion[i]}"
         for i in range(len(table))], dtype=object))
    with open(path, "w") as f:
        for i, line in enumerate(table.lines):
            line = line.ljust(80)
            x, y, z = new_coords[i]
            line = (line[:6] + f"{i + 1:5d}" + line[11:22] + f"{res_ids[i]:4d}" + line[26:30]
                    + f"{x:8.3f}{y:8.3f}{z:8.3f}" + line[54:])
            f.write(line + "\n")
        f.write("END\n")


def build_atom_table(atom_name, resname, chain, residue, coords, element) -> AtomTable:
    """An AtomTable of raw field arrays, with fixed-column ATOM lines made up
    for them so the writers apply (the DIPS pair frames are no PDB files)."""
    coords = np.asarray(coords, dtype=np.float32)
    n = coords.shape[0]
    lines = []
    for i in range(n):
        name = str(atom_name[i])
        name_f = name if len(name) >= 4 else f" {name:<3s}"   # short names from column 14
        lines.append(
            f"ATOM  {i + 1:5d} {name_f}{'':1s}{str(resname[i])[:3]:>3s} "
            f"{str(chain[i])[:1]:1s}{int(residue[i]):4d}{'':4s}"
            f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}"
            f"{1.0:6.2f}{0.0:6.2f}{'':10s}{str(element[i])[:2]:>2s}")
    return AtomTable(
        atom_name=np.asarray(atom_name, dtype=str),
        resname=np.asarray(resname, dtype=str),
        chain=np.asarray([str(c)[:1] for c in chain], dtype=str),
        residue=np.asarray(residue, dtype=np.int64),
        insertion=np.asarray([""] * n, dtype=str),
        coords=coords,
        element=np.asarray(element, dtype=str),
        lines=lines)


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
