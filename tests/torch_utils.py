"""Helpers shared by the tests of the PyTorch port (`test_torch_*.py`):
an autouse fixture that pins torch's default dtype to float32 (another test
module sets float64 at import), converters from the JAX package's
batches to the port's, and a small raw DB5 tree with the npz comparison
of the host-builder tests."""

import os

import numpy as np
import pytest
import torch

from equidock_public_tpu_torch.graph import PairBatch, ProteinBatch


@pytest.fixture(autouse=True)
def f32_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(old)


def t(a, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a copy)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def port_protein(pb) -> ProteinBatch:
    seg = getattr(pb, "seg_id", None)
    return ProteinBatch(res_id=t(pb.res_id, torch.int64), x=t(pb.x),
                        mu_r_norm=t(pb.mu_r_norm), nbr=t(pb.nbr, torch.int32),
                        nbr_mask=t(pb.nbr_mask), edge_feat=t(pb.edge_feat),
                        node_mask=t(pb.node_mask),
                        seg_id=None if seg is None else t(seg, torch.int32))


def port_batch(b) -> PairBatch:
    """JAX PairBatch (unpacked or packed) -> the port's PairBatch on the CPU."""
    seg_mask = getattr(b, "seg_mask", None)
    return PairBatch(lig=port_protein(b.lig), rec=port_protein(b.rec),
                     gt_lig=t(b.gt_lig), pocket_lig=t(b.pocket_lig),
                     pocket_rec=t(b.pocket_rec), pocket_mask=t(b.pocket_mask),
                     pair_mask=t(b.pair_mask),
                     seg_mask=None if seg_mask is None else t(seg_mask),
                     n_segs=getattr(b, "n_segs", 1))


def port_halo_batch(jhb):
    """JAX HaloBatch -> the port's HaloBatch on the CPU, field by field."""
    import dataclasses

    from equidock_public_tpu_torch.parallel.halo import HaloBatch, HaloPlan, exchange_table

    def arrays(jp):
        return {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(HaloPlan)
                if getattr(jp, f.name) is not None}

    plan = lambda a: HaloPlan(**{k: t(v, torch.int32) for k, v in a.items()})
    pair = jhb.pair
    lig, rec = arrays(jhb.plan_lig), arrays(jhb.plan_rec)
    # the JAX plans' arrays, and the port-only exchange tables built from them
    return HaloBatch(pair=port_batch(pair), plan_lig=plan(lig), plan_rec=plan(rec),
                     table_lig=exchange_table(lig, pair.lig.x.shape[1]),
                     table_rec=exchange_table(rec, pair.rec.x.shape[1]))


def jax_batch(pb):
    """The port's PairBatch -> the JAX package's (unpacked), same values."""
    import jax.numpy as jnp

    from equidock_public_tpu.graph import PairBatch as JPair, ProteinBatch as JProt

    def a(x, dtype=None):
        v = x.detach().cpu().numpy()
        return jnp.asarray(v if dtype is None else v.astype(dtype))

    def side(s):
        return JProt(res_id=a(s.res_id, np.int32), x=a(s.x), mu_r_norm=a(s.mu_r_norm),
                     nbr=a(s.nbr), nbr_mask=a(s.nbr_mask), edge_feat=a(s.edge_feat),
                     node_mask=a(s.node_mask))

    return JPair(lig=side(pb.lig), rec=side(pb.rec), gt_lig=a(pb.gt_lig),
                 pocket_lig=a(pb.pocket_lig), pocket_rec=a(pb.pocket_rec),
                 pocket_mask=a(pb.pocket_mask), pair_mask=a(pb.pair_mask))


def port_config(jcfg):
    """The JAX package's Config -> the port's: every field the port has,
    from the JAX value (the port's field names and defaults are the JAX
    package's)."""
    import dataclasses

    from equidock_public_tpu_torch import config as tc

    def section(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tc.Config(model=section(tc.ModelConfig, jcfg.model),
                     graph=section(tc.GraphConfig, jcfg.graph),
                     data=section(tc.DataConfig, jcfg.data),
                     train=section(tc.TrainConfig, jcfg.train),
                     parallel=section(tc.ParallelConfig, jcfg.parallel), debug=jcfg.debug,
                     checkpoint_dir=jcfg.checkpoint_dir, log_dir=jcfg.log_dir)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tracked chains cut in two for the host-builder tests: 4 train, 1 val, 1 test
SMALL_TREE = ("2VDB", "2SNI", "6B0S", "2AYO", "1NW9", "1QA9")


def chain_file(code: str) -> str:
    return os.path.join(REPO, "artifacts", "db5_test_outputs", f"{code}_l_b_EQUIDOCK_TPU.pdb")


def write_small_tree(root, codes=SMALL_TREE, splits=(("train", 4), ("val", 1), ("test", 1))):
    """A raw DB5 tree of tracked chains cut in two (`write_db5_raw_tree`);
    returns (structures dir, split-files dir)."""
    from equidock_public_tpu_torch.data.synth import write_db5_raw_tree

    return write_db5_raw_tree(str(root), {c: chain_file(c) for c in codes}, splits)


def assert_npz_equal(got_path, want_path):
    """Every key of both files, bit-equal in value and dtype."""
    with np.load(got_path) as a, np.load(want_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
