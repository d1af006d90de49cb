"""The committed reference output of the flagship generator in bf16
(``tests/data/flagship_stage6_bf16.npz``, made on the CPU by
``tests/make_torch_reference_data.py``) and the bar the port is held to.

Numpy only: the card test reads it on a machine without JAX.

The bar, from the port's own CPU run against the file (float32 CPU
convs, bf16 activations; measured before the card test was written):
mean |diff| 2.03e-3, 99.9th percentile 0.060, RMS of the difference
0.85 % of the image's RMS (0.725), max 0.277 (a few tanh outputs where
one-ulp bf16 differences, compounded over 14 conv layers, land on a
steep part of tanh). On the card the convs (cuDNN, K2) sum in other
orders again, so each statistic may be 2.5x the CPU's; the max is not
bounded, since it is set by a handful of such pixels. A wrong conv or a
lost block moves the mean by two orders of magnitude.
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "flagship_stage6_bf16.npz")
MEAN_ABS_BAR = 5e-3
P999_BAR = 0.15
REL_RMS_BAR = 2.5e-2


def load():
    """The file's arrays: image [2, 128, 1024, 2] (float32 from float16),
    z [2, 256], labels [2, 61], seeds, pitches, stage."""
    with np.load(PATH) as d:
        out = {k: d[k] for k in d.files}
    out["image"] = out["image"].astype(np.float32)
    return out


def gap(got: np.ndarray, want: np.ndarray) -> dict:
    err = np.abs(np.asarray(got, np.float32) - want)
    return {"mean_abs": float(err.mean()),
            "p999": float(np.quantile(err, 0.999)),
            "rel_rms": float(np.sqrt((err ** 2).mean())
                             / np.sqrt((want ** 2).mean())),
            "max": float(err.max())}


def check(got: np.ndarray, want: np.ndarray) -> dict:
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    g = gap(got, want)
    assert g["mean_abs"] <= MEAN_ABS_BAR, g
    assert g["p999"] <= P999_BAR, g
    assert g["rel_rms"] <= REL_RMS_BAR, g
    return g
