"""The port's halo training step against the JAX package's
`make_halo_train_step` with `parallel.pallas_ring_halo` on, as
`tests/test_halo.py::test_halo_train_step_pallas_ring_matches_dense` runs
it: dp=2 x gp=4, a forced residual tier (spatial=False, hmax=4), the Pallas
ring and its custom VJP in Mosaic interpret mode on the 8-device CPU mesh.

Same parameters and batch on both sides: the loss terms and the gradient
norm (relative 1e-5), every leaf's gradient norm (relative 1e-5) against
`jax.grad` of the JAX halo loss, and every leaf's move (new minus old
parameters) against the JAX step's, relative to its norm (1e-5). The JAX
side runs at "highest" matmul precision."""

import jax
import jax.numpy as jnp
import numpy as np

from equidock_public_tpu.parallel import halo as jh
from equidock_public_tpu.parallel.mesh import make_mesh, replicate
from equidock_public_tpu.train import step as js
from equidock_public_tpu.train.losses import total_loss
from equidock_public_tpu_torch.params import flatten, params_from_numpy
from equidock_public_tpu_torch.parallel.halo import (build_halo_batch, make_halo_loss,
                                                     make_halo_train_step)
from equidock_public_tpu_torch.parallel.mesh import ParallelMesh
from equidock_public_tpu_torch.train.step import create_train_state, loss_and_grads

from .test_torch_halo_jax_fwd import jax_halo_setup
from .torch_utils import f32_default, port_batch  # noqa: F401
from .utils import synth_batch

LOSS_KEYS = ("loss", "ligand_coors_loss", "receptor_coors_loss", "ot_loss",
             "intersection_loss", "grad_norm")


def test_halo_step_matches_jax_pallas_ring(rng):
    jcfg, pcfg, jp = jax_halo_setup(rng)
    batch = synth_batch(rng, B=2, N_l=16, N_r=16, n_l=14, n_r=13, coord_scale=50.0)
    kw = dict(gp=4, spatial=False, hmax=4)
    jhb, stats, _, _ = jh.build_halo_batch(batch, **kw)
    assert stats.hres_lig > 0 and np.asarray(stats.sizes_lig)[:, 0, 2:].sum() > 0
    mesh = make_mesh(dp=2, gp=4)
    with jax.default_matmul_precision("highest"), mesh:
        hb_s = jh.shard_halo_batch(jhb, mesh)
        fwd = jh.make_halo_forward(jcfg, mesh)
        jgrads = jax.jit(jax.grad(lambda p: total_loss(fwd(p, hb_s), hb_s.pair,
                                                       jcfg.train)[0]))(replicate(jp, mesh))
        state = jax.tree.map(lambda x: replicate(x, mesh), js.create_train_state(jp, jcfg))
        jstate, jmetrics = jh.make_halo_train_step(jcfg, mesh)(
            state, hb_s, jax.random.PRNGKey(3), jnp.asarray(1.0))
    jgrads = flatten(jax.tree.map(np.asarray, jgrads))

    hb, _, _, _ = build_halo_batch(port_batch(batch), **kw)
    mesh_p = ParallelMesh(2, 4, "cpu")
    params = params_from_numpy(jp, pcfg.model)
    grads, _, _ = loss_and_grads(params, pcfg, hb, loss_fn_=make_halo_loss(pcfg, mesh_p))
    pstate, pmetrics = make_halo_train_step(pcfg, mesh_p)(
        create_train_state(params, pcfg, "cpu"), hb)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(float(pmetrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert set(grads) == set(jgrads)
    for key, g in grads.items():
        want = float(np.linalg.norm(jgrads[key]))
        assert abs(float(g.norm()) - want) <= 1e-5 * max(want, 1e-12) + 1e-9, key
    j0 = flatten(jax.tree.map(np.asarray, jp))
    j1 = flatten(jax.tree.map(np.asarray, jstate.params))
    p0 = flatten(params)
    for key, v in flatten(pstate.params).items():
        move = v.numpy().astype(np.float64) - p0[key].numpy()
        want = j1[key].astype(np.float64) - j0[key]
        assert np.linalg.norm(want) > 0, key
        assert np.linalg.norm(move - want) <= 1e-5 * np.linalg.norm(want), key
