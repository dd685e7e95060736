"""`equidock_public_tpu_torch/assets/slice9.golden.json`, which the card's
check (`chip_smoke.py`, phase `slice9`) holds the port's host builders to,
recomputed from the JAX package on the CPU from its own recipe: the split
caches' digests and the codes kept and dropped, the frozen test set, its
DIPS shards, the aligned ligand, the crop corpus, the padding report, the
surface rhos and the hyper-search draws must all equal the committed file.
The port's side of each is held to the JAX package live in
`test_torch_preprocess.py`, `test_torch_dips_build.py`, `test_torch_crops.py`
and `test_torch_tools.py`."""

import json

import pytest

from .torch_golden import SLICE9_GOLDEN, SLICE9_RECIPE, jax_slice9_golden


@pytest.fixture(scope="module")
def golden():
    with open(SLICE9_GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def recomputed(tmp_path_factory, golden):
    assert golden["recipe"] == json.loads(json.dumps(SLICE9_RECIPE))
    return json.loads(json.dumps(jax_slice9_golden(str(tmp_path_factory.mktemp("slice9")))))


@pytest.mark.parametrize("part", ["db5_cache", "testset", "dips_frozen", "align_receptor",
                                  "crop_sizes", "crops", "padding_report", "surface_rhos",
                                  "hyper_search"])
def test_the_committed_golden_is_the_jax_package_s(golden, recomputed, part):
    assert recomputed[part] == golden[part]
