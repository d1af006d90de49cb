"""One whole training step of the port against the reference's, in float32.

Both packages start from the same state (the reference's
``create_train_state`` mapped across with ``from_jax_params``; Adam fresh
in both), take the same waves, pitches and alpha, and the same noise: the
port gets the z_d, u and z_g that the reference draws from its key
schedule (``step.py:76-77``, ``losses.py:27``), and the same real image:
the port's frontend is handed the reference's. The two frontends agree
(``test_helpers_match_reference``, ``test_torch_spectral_analysis.py``)
except that the phase of a bin with next to no energy is noise, so a few
mel-IF entries wrap to the other side of +-pi; that moves the critic's
first-layer gradients by ~0.5% and would hide a fault in the step behind
it. Every metric must agree to rtol 1e-4 (float32 sums taken in other
orders, through a second-order gradient penalty).

Parameters are compared through the gradients. With b1 = 0 the first
Adam update is lr * g / (|g| + eps), about lr * sign(g): a gradient that
is rounding noise in both packages may take the other sign and move its
parameter by up to 2 lr the other way. So the gradients (Adam's first
moment after one step is the gradient itself) are held tightly, within
``floor`` = 1e-4 of each tensor's largest entry plus rtol 1e-3; the
updated parameters are held to 1e-6 wherever |g| is above that noise
floor, and to 2 lr + 1e-6 where it is not. The EMA follows from the
generator.

Cases here: stages 0 and 1 of a narrow config (every ``fused_critic``
schedule, the pre-release pitch losses, a fade-in alpha). Stage 4 with
both kernels is in ``test_torch_train_step_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.train.step import pitch_to_onehot as j_onehot
from gansynth_tpu.train.step import real_image_for_stage as j_real
from gansynth_tpu_torch.train.step import (
    make_train_step,
    pitch_to_onehot,
    real_image_for_stage,
)
from gansynth_tpu_torch.utils.config import Config
from torch_step_parity import check, configs, run_both, waves

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NARROW = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=16,
                        fmap_min=8),
          "train": dict(batch_size=4)}



@pytest.mark.parametrize("stage,alpha,train", [
    (0, 1.0, {}),
    (1, 0.5, {}),
    (1, 1.0, {"fused_critic": "pair"}),
    (1, 0.5, {"fused_critic": "all", "d_pitch_ce_on_fake": False}),
    (1, 1.0, {"pitch_consistency_weight": 10.0,
              "pitch_consistency_min_stage": 1}),
])
def test_step_matches_reference(monkeypatch, stage, alpha, train):
    overrides = {"model": NARROW["model"],
                 "train": {**NARROW["train"], **train}}
    new, jm, ts, tm = run_both(monkeypatch, overrides, stage, alpha)
    if train.get("pitch_consistency_weight"):
        assert "g_pitch_consistency" in tm
    check(new, jm, ts, tm, Config().train.learning_rate)


def test_helpers_match_reference():
    jcfg, tcfg = configs(NARROW)
    wave, _ = waves(2)
    pitch = np.array([0, 24, 50, 84, 127], dtype=np.int32)
    np.testing.assert_array_equal(
        pitch_to_onehot(torch.from_numpy(pitch), tcfg).numpy(),
        np.asarray(j_onehot(jnp.asarray(pitch), jcfg)))
    for stage in (0, 6):
        want = np.asarray(j_real(jnp.asarray(wave), stage, jcfg))
        got = real_image_for_stage(torch.from_numpy(wave), stage,
                                   tcfg).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got[..., 0], want[..., 0], atol=2e-3)


def test_unknown_fused_critic_raises():
    _, tcfg = configs({"train": {"fused_critic": "both"}})
    with pytest.raises(ValueError, match="fused_critic"):
        make_train_step(tcfg, 0)
