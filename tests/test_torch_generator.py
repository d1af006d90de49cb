"""The port's generator against the reference's, same weights and inputs.

A narrow config (widths 16/16/16/8, latent 8, 5 pitches) with the
reference's 7-stage ladder. Weights come from the flax init (plus random
biases) through ``from_jax_params``. float32 agrees to ~1e-5 (stacked
float32 conv sums); bfloat16 only loosely, since the two libraries round
bfloat16 activations at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.models import Generator as JGenerator
from gansynth_tpu.utils.config import ModelConfig as JModel
from gansynth_tpu_torch.models.generator import Generator as TGenerator
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import ModelConfig as TModel

SMALL = dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8,
             num_pitches=5, pitch_max=28)


def _models(dtype):
    jg = JGenerator(JModel(compute_dtype=dtype, **SMALL))
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[[1, 3]]
    params = jg.init(jax.random.key(0), jnp.asarray(z), jnp.asarray(labels),
                     0, jnp.float32(1.0))
    params = jax.tree.map(
        lambda p: p + jnp.asarray(
            0.1 * rng.standard_normal(p.shape).astype(np.float32)),
        params,
    )
    tg = TGenerator(TModel(compute_dtype=dtype, **SMALL))
    tg.load_state_dict(from_jax_params(params))
    return jg, params, tg, z, labels


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


def _run(models, stage, alpha):
    jg, params, tg, z, labels = models
    want = np.asarray(jg.apply(params, jnp.asarray(z), jnp.asarray(labels),
                               stage, jnp.float32(alpha)))
    with torch.no_grad():
        got = tg(torch.from_numpy(z), torch.from_numpy(labels), stage,
                 alpha).numpy()
    return want, got


@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 1.0), (2, 1.0),
                                         (3, 1.0), (2, 0.37)])
def test_generator_f32(f32_models, stage, alpha):
    want, got = _run(f32_models, stage, alpha)
    h, w = 2 << stage, 16 << stage
    assert got.shape == want.shape == (2, h, w, 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_generator_bf16_loose():
    want, got = _run(_models("bfloat16"), 2, 1.0)
    # tanh outputs in [-1, 1]; a bfloat16 ulp near 1 is 7.8e-3, and three
    # blocks of bf16 convs compound it
    np.testing.assert_allclose(got, want, atol=0.1)
    assert np.mean(np.abs(got - want)) < 1e-2


def test_generator_bf16_gap_per_block():
    """Where the two packages round bf16 differently, block by block at
    stage 3, each block fed the same bf16 input in both packages.

    The reference's ``jax.nn.leaky_relu`` multiplies by the slope 0.2
    rounded to bf16 (0.2001953125); the port rounds it the same way
    (``utils.device.slope_in``), and with that the convs, biases, pixel
    norms and up-convs agree bit for bit. What is left is the conv
    library's accumulation order: one conv1 output of block 3 lands one
    bf16 ulp away (9.8e-4 at 0.98 of an output scale of 5.7). Pinned here
    at one ulp of the block's output scale per block, and for the whole
    stage-3 generator at a mean gap below 1e-4 (it was 4.6e-3 with the
    slope in float32).
    """
    from gansynth_tpu.models.generator import GeneratorBlock as JBlock

    jg, params, tg, z, labels = _models("bfloat16")
    cfg = TModel(compute_dtype="bfloat16", **SMALL)
    rng = np.random.default_rng(5)
    for i in range(4):
        h, w = cfg.stage_resolution(max(i - 1, 0))
        x = rng.standard_normal((2, h, w, cfg.stage_channels(max(i - 1, 0))))
        xb = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
        want = np.asarray(JBlock(cfg.stage_channels(i), upsample=i > 0,
                                 compute_dtype="bfloat16").apply(
            {"params": params["params"][f"block_{i}"]}, xb
        ).astype(jnp.float32))
        with torch.no_grad():
            got = tg.blocks[i](torch.from_numpy(
                np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
        gap = np.abs(got.float().numpy() - want)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert gap.max() <= ulp, (i, gap.max(), ulp)
    want, got = _run((jg, params, tg, z, labels), 3, 1.0)
    assert np.mean(np.abs(got - want)) < 1e-4
    np.testing.assert_allclose(got, want, atol=0.02)


def test_parameter_set_is_stage_independent(f32_models):
    tg = f32_models[2]
    names = set(tg.state_dict())
    assert len(names) == 2 + 7 * 4 + 7 * 2  # dense, blocks, toRGB heads
    with pytest.raises(ValueError, match="stage"):
        tg(torch.zeros(1, 8), torch.zeros(1, 5), 7)
