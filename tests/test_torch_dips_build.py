"""The port's DIPS builders (`data/dips.py`: the pair-pickle readers,
`build_dips_cache`; `cli/partition_dips.py`) against the JAX package's, on
pair pickles made from tracked chains (each cut in two: df0 the first
half, df1 the rest) in atom3 and in biopandas column names, and the
port's shard index and streamed batches on the shards they build."""

import os
import types

import numpy as np
import pandas as pd
import pytest

from equidock_public_tpu.cli import partition_dips as jax_partition
from equidock_public_tpu.config import Config as JConfig, DataConfig as JData
from equidock_public_tpu.data import dips as jdips
from equidock_public_tpu_torch.cli import partition_dips
from equidock_public_tpu_torch.config import Config, DataConfig
from equidock_public_tpu_torch.data import dips
from equidock_public_tpu_torch.data.dataset import DockingDataset
from equidock_public_tpu_torch.data.pdb import read_pdb

from .torch_utils import assert_npz_equal, chain_file, f32_default  # noqa: F401

QUIET = lambda *a: None
ATOM3 = ("chain", "residue", "resname", "atom_name", "x", "y", "z", "element")
BIOPANDAS = ("chain_id", "residue_number", "residue_name", "atom_name", "x_coord", "y_coord",
             "z_coord", "element_symbol")


def frame(table, rows, names):
    cols = (table.chain[rows], table.residue[rows], table.resname[rows], table.atom_name[rows],
            table.coords[rows, 0].astype(np.float64), table.coords[rows, 1].astype(np.float64),
            table.coords[rows, 2].astype(np.float64), table.element[rows])
    df = pd.DataFrame({n: c for n, c in zip(names, cols)})
    df["aid"] = np.arange(len(df))
    return df


def write_pair(path, code, names):
    """A pair pickle of a tracked chain cut at half its residues."""
    t = read_pdb(chain_file(code))
    keys = list(dict.fromkeys(zip(t.chain, t.residue)))
    first = set(keys[:len(keys) // 2])
    in_first = np.array([k in first for k in zip(t.chain, t.residue)])
    pair = types.SimpleNamespace(df0=frame(t, np.where(in_first)[0], names),
                                 df1=frame(t, np.where(~in_first)[0], names))
    pd.to_pickle(pair, path)


CODES = ("2VDB", "2SNI", "6B0S", "1NW9")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dips_raw")
    names = []
    for i, code in enumerate(CODES):
        fam = root / f"f{i % 2}"
        fam.mkdir(exist_ok=True)
        write_pair(fam / f"{code.lower()}.dill", code, ATOM3 if i % 2 else BIOPANDAS)
        names.append(f"f{i % 2}/{code.lower()}.dill")
    pd.to_pickle("not a pair", root / "f0" / "broken.dill")
    names.append("f0/broken.dill")
    lists = root / "lists"
    lists.mkdir()
    (lists / "pairs-postprocessed-train.txt").write_text("\n".join(names) + "\n")
    return str(root), str(lists), names


@pytest.mark.parametrize("i", range(len(CODES)))
def test_the_pair_readers_equal_jax(pairs, i):
    root, _, names = pairs
    path = os.path.join(root, names[i])
    for got, want in zip(dips.read_dips_pair(path), jdips.read_dips_pair(path)):
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g["resname"] == w["resname"]
            for key in ("atom_name", "coords", "element"):
                assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key])
    for got, want in zip(dips.read_dips_pair_tables(path), jdips.read_dips_pair_tables(path)):
        assert got.lines == want.lines
        for key in ("atom_name", "resname", "chain", "residue", "insertion", "coords",
                    "element"):
            g, w = getattr(got, key), getattr(want, key)
            assert g.dtype == w.dtype and np.array_equal(g, w), key


@pytest.mark.parametrize("fraction,n_jobs", [(1.0, 2), (0.5, 1)])
def test_build_dips_cache_is_bit_equal_to_jax(pairs, tmp_path, fraction, n_jobs):
    root, lists, names = pairs
    jcfg = JConfig(data=JData(data="dips", data_fraction=fraction, n_jobs=1,
                              cache_dir=str(tmp_path / "j")))
    cfg = Config(data=DataConfig(data="dips", data_fraction=fraction, n_jobs=n_jobs,
                                 cache_dir=str(tmp_path / "p")))
    want = jdips.build_dips_cache(jcfg, "train", root, lists, log=QUIET)
    got = dips.build_dips_cache(cfg, "train", root, lists, log=QUIET)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert_npz_equal(g, w)
    kept = dips.load_shard_samples(got[0])[1]
    listed = list(names)
    if fraction < 1.0:          # the JAX package's shuffle, then the leading share
        np.random.default_rng(cfg.train.random_seed).shuffle(listed)
        listed = listed[:int(fraction * len(names))]
    assert kept == [n for n in listed if n != "f0/broken.dill"]


def test_the_shard_index_and_streamed_batches_read_built_shards(pairs, tmp_path):
    root, lists, _ = pairs
    cfg = Config(data=DataConfig(data="dips", n_jobs=1, cache_dir=str(tmp_path),
                                 stream_dips=True, stream_window=1))
    dips.build_dips_cache(cfg, "train", root, lists, log=QUIET)
    index = dips.DipsShardIndex(cfg.cache_path(), "train")
    ds = DockingDataset.from_cache(cfg, "train")
    whole = DockingDataset.from_cache(Config(data=DataConfig(data="dips", cache_dir=str(
        tmp_path))), "train")
    assert index.codes == ds.codes == whole.codes and len(index) == 4
    assert index.n_lig == [s.lig.num_nodes for s in whole.samples]
    batches = list(ds.batches(np.random.default_rng(0), device="cpu"))
    assert sum(int(b.lig.node_mask.any(-1).sum()) for b in batches) >= 1
    assert os.path.exists(index.shard_paths[0] + ".index.json")


def test_partition_dips_writes_jax_splits(tmp_path, monkeypatch):
    """44 families of one small pair each, two over the atom limit: the
    same kept list and the same family splits as the JAX CLI's."""
    data = tmp_path / "pairs"
    for i in range(44):
        fam = data / f"fam{i:02d}"
        fam.mkdir(parents=True)
        n = 12 if i in (5, 17) else 3
        df = pd.DataFrame({"chain": ["A"] * n, "residue": range(n)})
        pd.to_pickle(types.SimpleNamespace(df0=df, df1=df), fam / f"p{i}.dill")
    args = ["-data_dir", str(data), "-max_atom_count", "10", "-seed", "3"]
    assert partition_dips.main(args + ["-out_dir", str(tmp_path / "port")]) == 0
    monkeypatch.setattr("sys.argv", ["partition_dips"] + args + ["-out_dir",
                                                                 str(tmp_path / "jax")])
    jax_partition.main()
    for name in ("", "-train", "-val", "-test"):
        f = f"pairs-postprocessed{name}.txt"
        got = (tmp_path / "port" / f).read_text()
        assert got == (tmp_path / "jax" / f).read_text()
    assert len((tmp_path / "port" / "pairs-postprocessed.txt").read_text().split()) == 42
    assert len((tmp_path / "port" / "pairs-postprocessed-val.txt").read_text().split()) == 20
