"""The port's RMSD meter (`train/meter.py`) against the JAX package's, on
the same padded predictions: `complex_rmsd`, `RmsdMeter.update_batch` for
training and with `meter_interface`, and the summaries. Both are numpy on
the host; tolerance 1e-5 A (f64 and f32 sums in other orders)."""

import numpy as np
import pytest

from equidock_public_tpu.data import featurize as jf
from equidock_public_tpu.train import meter as jmeter
from equidock_public_tpu_torch.data import featurize as tf
from equidock_public_tpu_torch.train import meter as tmeter

from .torch_utils import f32_default, port_batch  # noqa: F401
from .utils import synth_batch


def test_kabsch_and_complex_rmsd_match(rng):
    A = rng.standard_normal((3, 40))
    B = rng.standard_normal((3, 40)) * 3 + 1
    for w, g in zip(jf.rigid_transform_kabsch(A, B), tf.rigid_transform_kabsch(A, B)):
        np.testing.assert_allclose(g, w, atol=1e-12)
    pts = [(rng.standard_normal((n, 3)) * 10).astype(np.float32) for n in (30, 50, 30, 50)]
    np.testing.assert_allclose(tmeter.complex_rmsd(*pts), jmeter.complex_rmsd(*pts), atol=1e-5)


@pytest.mark.parametrize("interface", [False, True])
def test_update_batch_matches(rng, interface):
    # receptor near the ligand, so the interface (CA pairs under 8 A) is not empty
    batch = synth_batch(rng, B=3, N_l=24, N_r=32, n_l=20, n_r=27, coord_scale=4.0)
    pred = (np.asarray(batch.gt_lig) + rng.standard_normal(batch.gt_lig.shape) * 2
            ).astype(np.float32)
    want, got = jmeter.RmsdMeter(), tmeter.RmsdMeter()
    want.update_batch(batch, pred, meter_interface=interface)
    got.update_batch(port_batch(batch), pred, meter_interface=interface)
    for attr in ("ligand", "receptor", "complex", "interface"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), atol=1e-5)
    assert bool(got.interface) == interface
    for red in ("median", "mean"):
        np.testing.assert_allclose(got.summarize(red), want.summarize(red), atol=1e-5)
        np.testing.assert_allclose(got.summarize_interface(red),
                                   want.summarize_interface(red), atol=1e-5)
        np.testing.assert_allclose(got.summarize_with_std(red),
                                   want.summarize_with_std(red), atol=1e-5)


def test_empty_meter_reads_nan():
    m = tmeter.RmsdMeter()
    assert all(np.isnan(v) for v in m.summarize()) and np.isnan(m.summarize_interface())
