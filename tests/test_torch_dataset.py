"""The port's training data path against the JAX package: `extract_pocket`,
`uniform_rotation_translation` (same numpy generator, same draws), and
`DockingDataset.batches` on split-chain complexes under one seed (swap,
random pose, size sort, chunking, collate): every array of every batch
equal to the JAX package's, to f32 rounding of the featurizers."""

import os
import tempfile

import numpy as np
import pytest

from equidock_public_tpu.config import Config as JaxConfig
from equidock_public_tpu.config import DataConfig as JaxDataConfig
from equidock_public_tpu.config import TrainConfig as JaxTrainConfig
from equidock_public_tpu.data import dataset as jds
from equidock_public_tpu.data import featurize as jf
from equidock_public_tpu_torch import config as tc
from equidock_public_tpu_torch.data import dataset as tds
from equidock_public_tpu_torch.data import featurize as tf
from equidock_public_tpu_torch.data.pdb import group_residues, read_pdb

from . import torch_golden as tg
from .torch_utils import f32_default, port_batch  # noqa: F401

CODES = ("2SNI", "1QA9", "2AYO", "6B0S", "1NW9")


def _residues(code):
    return tf.filter_residues(group_residues(read_pdb(os.path.join(tg.REPO,
                                                                   tg.pdb_path(code)))))


def test_extract_pocket_matches(rng):
    a = (rng.standard_normal((40, 3)) * 6).astype(np.float32)
    b = (rng.standard_normal((50, 3)) * 6 + 4).astype(np.float32)
    want, got = jf.extract_pocket(a, b, 8.0), tf.extract_pocket(a, b, 8.0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert tf.extract_pocket(a, b + 100, 8.0) is None is jf.extract_pocket(a, b + 100, 8.0)


def test_random_pose_draws_match():
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        for w, g in zip(jf.uniform_rotation_translation(r1, 5.0),
                        tf.uniform_rotation_translation(r2, 5.0)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bs,seed", [(2, 0), (5, 3)])
def test_batches_match_the_jax_dataset(bs, seed):
    pcfg = tc.Config(train=tc.TrainConfig(bs=bs),
                     data=tc.DataConfig(node_buckets=(32, 64), pocket_buckets=(64, 128)))
    jcfg = JaxConfig(train=JaxTrainConfig(bs=bs),
                     data=JaxDataConfig(node_buckets=(32, 64), pocket_buckets=(64, 128)))
    samples = [tds.split_chain_complex(_residues(c), pcfg.graph) for c in CODES]
    jsamples = [tg.jax_split_chain(c, jcfg.graph) for c in CODES]
    out = {"codes": np.array(CODES)}
    for i, s in enumerate(jsamples):
        jds._graph_to_npz(f"c{i}/lig/", s.lig, out)
        jds._graph_to_npz(f"c{i}/rec/", s.rec, out)
        out[f"c{i}/gt_lig"], out[f"c{i}/gt_rec"] = s.gt_lig, s.gt_rec
        out[f"c{i}/pocket"] = s.pocket
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "train.npz"), **out)
        want = list(jds.DockingDataset(jcfg, "train", cache_path=os.path.join(d, "train.npz"))
                    .batches(np.random.default_rng(seed)))
    got = list(tds.DockingDataset(pcfg, samples).batches(np.random.default_rng(seed),
                                                         device="cpu"))
    assert len(got) == len(want) == -(-len(CODES) // bs)
    for g, w in zip(got, want):
        w = port_batch(w)
        for side in ("lig", "rec"):
            for field in ("res_id", "x", "mu_r_norm", "nbr", "nbr_mask", "edge_feat",
                          "node_mask"):
                np.testing.assert_allclose(getattr(getattr(g, side), field).numpy(),
                                           getattr(getattr(w, side), field).numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=f"{side}.{field}")
        for field in ("gt_lig", "pocket_lig", "pocket_rec", "pocket_mask", "pair_mask"):
            np.testing.assert_allclose(getattr(g, field).numpy(), getattr(w, field).numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=field)


def test_packed_batches_are_refused():
    """Packed batches are ported (`tests/test_torch_packing.py`); what still
    refuses them is the device-resident store, which is unpacked: the JAX
    package's own refusal, in its words."""
    from equidock_public_tpu_torch.train.resident import build_resident_split

    ds = tds.DockingDataset(tc.Config(data=tc.DataConfig(pack=True)), [])
    with pytest.raises(ValueError, match="-device_resident already removes the "
                                         "padding-collate cost; it does not compose with -pack"):
        build_resident_split(ds, ds.cfg, "cpu")
