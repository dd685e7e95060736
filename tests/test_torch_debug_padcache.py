"""The last JAX-only flags, ported: `-debug` and `-pad_cache_gb`.

* `docking_forward(debug=True)` returns "trace", one dict of the ligand's
  activation maxima a layer under the JAX package's labels, equal to JAX's
  `docking_forward(debug=True)` on the same weights and batch (relative
  1e-5, the forward's own gate in `tests/test_torch_model.py`), both
  stages' layers with a fine-tune stage; it runs the plain layer body, as
  JAX's debug mode runs its XLA path (`tests/test_pallas.py::
  test_debug_trace_collects_layer_stats`).
* `graph.py::PadCache` against JAX's (`tests/test_dips_stream.py::
  test_pad_cache_byte_budget`): the same entries, under the byte budget
  through eviction, dropped with their graphs (weak keys); a dataset's batches bit-equal with and
  without the cache, packed too (`tests/test_model.py::
  test_pad_cache_collation_identical`).
"""

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from equidock_public_tpu.data.featurize import ProteinGraph as JaxGraph
from equidock_public_tpu.data.synth import synth_graph
from equidock_public_tpu.graph import PadCache as JaxPadCache
from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu_torch.data.featurize import ProteinGraph
from equidock_public_tpu_torch.graph import PadCache, pad_protein
from equidock_public_tpu_torch.models import iegmn as tm
from equidock_public_tpu_torch.params import params_from_numpy

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

LABELS = ("x_now", "h_feat", "x_rel", "msg", "aggr_cross_msg", "x_final", "h_final")


@pytest.mark.parametrize("fine_tune", [False, True])
def test_the_debug_trace_matches_jax(rng, fine_tune):
    jcfg = tiny_config(fine_tune=fine_tune)
    batch = synth_batch(rng, B=2)
    jp = jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, b: jm.docking_forward(p, jcfg.model, b, debug=True))(jp, batch)
    cfg = port_config(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg.model)
    before = tm.plain_body_calls
    got = tm.docking_forward(params, cfg.model, port_batch(batch), debug=True)
    assert len(got["trace"]) == len(want["trace"]) == 2 + (2 if fine_tune else 0)
    for g, w in zip(got["trace"], want["trace"]):
        assert set(g) == set(w) == set(LABELS)
        for k in LABELS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert tm.plain_body_calls - before == 2 * len(got["trace"])    # the plain layer body
    plain = tm.docking_forward(params, cfg.model, port_batch(batch))
    assert "trace" not in plain
    torch.testing.assert_close(got["R"], plain["R"], rtol=1e-5, atol=1e-5)
    assert not tm.fused_edge_eligible(cfg.model, train=False, debug=True)


def _graphs(n=12, size=24):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        d = synth_graph(rng, size, k=4)
        e = np.zeros(0, np.int32)
        kw = dict(res_id=d["res_id"], x=d["x"], mu_r_norm=d["mu_r_norm"], nbr=d["nbr"],
                  nbr_mask=d["nbr_mask"], edge_feat=d["edge_feat"])
        out.append((ProteinGraph(**kw), JaxGraph(**kw, src=e, dst=e)))
    return out


def test_the_pad_cache_keeps_jax_s_budget_and_entries():
    pairs = _graphs()
    one_entry = sum(a.nbytes for a in pad_protein(pairs[0][0], 32).values())
    cache, jcache = PadCache(4 * one_entry), JaxPadCache(4 * one_entry)
    for _ in range(3):
        for g, jg in pairs:
            for bucket in (32, 64):
                got, want = cache.get(g, bucket), jcache.get(jg, bucket)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
                assert cache.nbytes <= cache.max_bytes      # (res_id int64 here, int32 there)
    assert cache.hits == 0 and cache.misses == 3 * 24    # a cycle of 24 through 4 places
    g = pairs[0][0]
    assert cache.get(g, 40) is cache.get(g, 40) and cache.hits == 1
    before = cache.nbytes
    assert before > 0
    del pairs, g, jg
    gc.collect()
    assert cache.nbytes == 0 and len(cache) == 0       # weak keys: entries die with graphs


@pytest.mark.parametrize("pack", [False, True])
def test_batches_are_bit_equal_with_and_without_the_cache(tmp_path, pack):
    import os

    from equidock_public_tpu_torch.config import Config, DataConfig
    from equidock_public_tpu_torch.data.dataset import DockingDataset
    from equidock_public_tpu_torch.data.synth import write_synth_split

    cfg = Config(data=DataConfig(cache_dir=str(tmp_path), node_buckets=(32, 64),
                                 pocket_buckets=(16,), pack=pack, pack_max_per_slot=2))
    path = os.path.join(cfg.cache_path(), "train.npz")
    write_synth_split(path, [(12, 20), (25, 18), (9, 30), (16, 16), (22, 11)], seed=1, k=4)
    runs = []
    for gb in (4.0, 0.0):        # the default budget, and a budget that holds nothing
        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, pad_cache_gb=gb))
        ds = DockingDataset.from_cache(c, "train")
        runs.append([b for _ in range(2) for b in ds.batches(np.random.default_rng(3),
                                                             device="cpu")])
        assert (ds.pad_cache.hits > 0) == (gb > 0) and (len(ds.pad_cache) == 0) == (gb == 0)
    for a, b in zip(*runs):
        for side in ("lig", "rec"):
            for f in dataclasses.fields(a.lig):
                x, y = getattr(getattr(a, side), f.name), getattr(getattr(b, side), f.name)
                assert (x is None and y is None) or torch.equal(x, y), f.name
        assert torch.equal(a.gt_lig, b.gt_lig) and torch.equal(a.pocket_lig, b.pocket_lig)
