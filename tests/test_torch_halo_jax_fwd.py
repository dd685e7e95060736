"""The port's halo forward against the JAX package's, with
`parallel.pallas_ring_halo` on (the Pallas ring in Mosaic interpret mode on
the 8-device CPU mesh, as `tests/test_halo.py` runs it), on the same
parameters and batch: padded ring tier at gp=2 and ragged tier, dp=4.

Tolerance: R 1e-5 absolute; t, keypoints and ligand coordinates 1e-5 of
the largest JAX coordinate (f32 through three layers and an SVD on
coordinates of ~100 units: an ulp there is ~1e-5). The JAX side runs at
"highest" matmul precision (ROADMAP C)."""

import dataclasses

import jax
import numpy as np
import pytest

from equidock_public_tpu.models import iegmn as jm
from equidock_public_tpu.parallel import halo as jh
from equidock_public_tpu.parallel.mesh import make_mesh, replicate
from equidock_public_tpu_torch.params import params_from_numpy
from equidock_public_tpu_torch.parallel.halo import build_halo_batch, make_halo_forward
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh

from .torch_utils import f32_default, port_batch, port_config  # noqa: F401
from .utils import synth_batch, tiny_config

TIERS = {"padded_gp2": dict(gp=2), "ragged_gp2": dict(gp=2, ragged=True, dp=4)}


def jax_halo_setup(rng, **model_kw):
    """(JAX config with the Pallas ring, port config, JAX params as numpy,
    JAX batch) as `tests/test_halo.py::_setup` builds them."""
    jcfg = tiny_config(iegmn_n_lays=3, **model_kw)
    jcfg = dataclasses.replace(jcfg, parallel=dataclasses.replace(jcfg.parallel,
                                                                  pallas_ring_halo=True))
    pcfg = port_config(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_docking_model(jax.random.PRNGKey(0), jcfg.model))
    return jcfg, pcfg, jp


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_halo_forward_matches_jax_pallas_ring(rng, tier):
    jcfg, pcfg, jp = jax_halo_setup(rng)
    batch = synth_batch(rng, B=4, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0)
    kw = TIERS[tier]
    jhb, _, jperm, _ = jh.build_halo_batch(batch, **kw)
    mesh = make_mesh(dp=4, gp=2)
    with jax.default_matmul_precision("highest"), mesh:
        want = jax.jit(jh.make_halo_forward(jcfg, mesh))(replicate(jp, mesh),
                                                         jh.shard_halo_batch(jhb, mesh))
        want = {k: np.asarray(v) for k, v in want.items()}

    hb, _, perm, _ = build_halo_batch(port_batch(batch), **kw)
    np.testing.assert_array_equal(perm, jperm)
    out = make_halo_forward(pcfg, ParallelMesh(4, 2, "cpu"))(params_from_numpy(jp, pcfg.model), hb)
    np.testing.assert_allclose(out["R"].numpy(), want["R"], rtol=0, atol=1e-5)
    scale = float(np.abs(want["ligand_coords"]).max())
    for key in ("t", "keypts_lig", "keypts_rec", "ligand_coords"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=0, atol=1e-5 * scale,
                                   err_msg=key)
