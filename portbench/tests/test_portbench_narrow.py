"""The narrow CPU copies, found by the cell's driver under
``tests/narrow/``, return what ``tiny.py`` returned before it looked
them up there: each cell's ``(config_override, workload_override)``,
frozen here, and a weight file whose arrays are frozen by digest."""

import hashlib

import numpy as np
import pytest

from portbench.tests import tiny

MODEL = {"fmap_base": 16, "fmap_max": 8, "fmap_min": 8,
         "compute_dtype": "float32", "conv_kernel": "xla",
         "dblock_kernel": "xla"}
TRAIN = {"unroll": 2, "stage_batch_sizes": [8, 8, 8, 8, 8, 8, 8]}
WORKLOADS = {
    "train.s6-cached": {"traffic": {"stage": 1, "cached_notes": 32}},
    "serve.single-client": {"traffic": {"clients": 1, "reference_sample": 4,
                                        "keep": {"per_client": 4}}},
    "serve.closed-mixed": {"traffic": {"clients": 4, "reference_sample": 4,
                                       "keep": {"per_client": 1}}},
}
# sha256 over the weight file's arrays in key order: key, dtype, shape,
# bytes (46 arrays: 22 layers' kernel and bias, step and stage)
ARRAYS = "ba15d99546a8cf9ee24b3215e554169bdc38db112477191429a79292370160c1"


def arrays_digest(path):
    h = hashlib.sha256()
    with np.load(path) as z:
        for k in sorted(z.files):
            a = z[k]
            for part in (k, str(a.dtype), str(a.shape)):
                h.update(part.encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", list(WORKLOADS))
def test_the_narrow_overrides_are_frozen(cell, tmp_path):
    cfg, wl = tiny.overrides(cell, tmp_path)
    assert wl == WORKLOADS[cell]
    path = tmp_path / "tiny_ema.npz"
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    assert cfg == {"weights": {"path": str(path), "sha256": digest,
                               "step": 415000, "stage": 1},
                   "model": MODEL, "train": TRAIN}
    assert arrays_digest(path) == ARRAYS
