"""The port's critic and its pieces against the reference's.

Minibatch stddev, the average-pool downsample and LeakyReLU against the
reference's functions; the whole discriminator at stages 0, 1 and 2 (the
fade-in skip, minibatch stddev, the final conv and dense, both heads)
from a flax init mapped across with ``from_jax_params``, with K3 on the
64-channel stage-2 block against the reference's ``fused_dblock`` in
interpret mode. float32 agrees to float32 rounding of the conv sums
(atol 1e-5 on O(1) values; 2e-5 through a whole critic); bfloat16 to a
few bf16 ulps of the critic's output (each side accumulates its convs in
its own order and rounds once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gansynth_tpu.kernels.pallas_dblock as pd
from gansynth_tpu.models import layers as jl
from gansynth_tpu.models.discriminator import Discriminator as JDisc
from gansynth_tpu.utils.config import ModelConfig as JModel
from gansynth_tpu_torch.models import discriminator as tdisc
from gansynth_tpu_torch.models import layers as tl
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import ModelConfig as TModel

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# widths 64 at stages 0-2, so block_2 (8 x 64, 64 -> 64 -> 64) is K3's
SMALL = dict(latent_dim=8, fmap_base=256, fmap_max=64, fmap_min=8,
             num_pitches=5, pitch_max=28, num_stages=3)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,group,replicas", [
    ((4, 2, 16, 8), 4, 1), ((8, 2, 4, 3), 4, 1), ((6, 2, 4, 3), 4, 1),
    ((8, 2, 4, 3), 2, 2), ((2, 2, 4, 3), 4, 4)])
def test_minibatch_stddev(shape, group, replicas):
    x = _x(shape, 0) * 3.0
    want = np.asarray(jl.minibatch_stddev(jnp.asarray(x), group, 1e-8,
                                          replicas))
    got = tl.minibatch_stddev(torch.from_numpy(x), group, 1e-8,
                              replicas).numpy()
    assert got.shape == want.shape == shape[:3] + (shape[3] + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tl.minibatch_stddev(torch.zeros(6, 2, 2, 1), 2, 1e-8, 4)


def test_minibatch_stddev_group_order():
    """Sample g_idx * (B/g) + m carries stat[m]: with B = 8 and g = 4,
    samples 0, 2, 4, 6 share one statistic and 1, 3, 5, 7 the other."""
    x = np.zeros((8, 1, 1, 1), np.float32)
    x[1::2] = np.arange(4, dtype=np.float32)[:, None, None, None]
    stat = tl.minibatch_stddev(torch.from_numpy(x), 4)[..., 1].reshape(-1)
    assert float(stat[0]) == pytest.approx(1e-4, abs=1e-6)   # sqrt(eps)
    assert float(stat[1]) == pytest.approx(np.std(np.arange(4)), rel=1e-6)
    assert torch.equal(stat[0::2], stat[0].expand(4))
    assert torch.equal(stat[1::2], stat[1].expand(4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_avg(dtype, factor):
    x = jnp.asarray(_x((2, 8, 16, 3), 1)).astype(dtype)
    want = np.asarray(jl.downsample_avg(x, factor).astype(jnp.float32))
    got = tl.downsample_avg(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            getattr(torch, dtype)), factor)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_relu_matches_reference_bitwise(dtype):
    """In bfloat16 the reference's slope is 0.2 rounded to bfloat16."""
    x = jnp.asarray(_x((4, 64), 2) * 5).astype(dtype)
    want = np.asarray(jl.leaky_relu(x, 0.2).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    np.testing.assert_array_equal(tl.leaky_relu(xt, 0.2).float().numpy(),
                                  want)


def _critics(dtype="float32", dblock="xla"):
    jd = JDisc(JModel(compute_dtype=dtype, dblock_kernel=dblock, **SMALL))
    img = jnp.zeros((1, 2, 16, 2), jnp.float32)
    params = jd.init(jax.random.key(0), img, 0)
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: p + jnp.asarray(
        0.1 * rng.standard_normal(p.shape).astype(np.float32)), params)
    td = tdisc.Discriminator(TModel(compute_dtype=dtype,
                                    dblock_kernel=dblock, **SMALL))
    td.load_state_dict(from_jax_params(params))
    return jd, params, td


@pytest.fixture(scope="module")
def f32_critics():
    return _critics()


def _run(critics, stage, alpha, batch=4, seed=3):
    jd, params, td = critics
    h, w = 2 << stage, 16 << stage
    img = _x((batch, h, w, 2), seed + stage)
    c_j, l_j = jd.apply(params, jnp.asarray(img), stage, jnp.float32(alpha))
    with torch.no_grad():
        c_t, l_t = td(torch.from_numpy(img), stage, alpha)
    assert c_t.dtype == l_t.dtype == torch.float32
    return (np.asarray(c_j), np.asarray(l_j)), (c_t.numpy(), l_t.numpy())


@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 1.0), (1, 0.37),
                                         (2, 0.6)])
def test_discriminator_f32(f32_critics, stage, alpha):
    (c_j, l_j), (c_t, l_t) = _run(f32_critics, stage, alpha)
    assert c_t.shape == (4,) and l_t.shape == (4, 5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=2e-5)


def test_discriminator_k3_stage(monkeypatch):
    """dblock_kernel='pallas' at stage 2: block_2 runs K3 in both packages
    (the reference's in interpret mode) and the critics agree."""
    calls = []
    real = tdisc.fused_dblock
    monkeypatch.setattr(tdisc, "fused_dblock",
                        lambda x, *a: calls.append(x.shape) or real(x, *a))
    real_j = pd.fused_dblock
    monkeypatch.setattr(pd, "fused_dblock",
                        lambda x, k0, b0, k1, b1, slope, interpret: real_j(
                            x, k0, b0, k1, b1, slope, True))
    (c_j, l_j), (c_t, l_t) = _run(_critics(dblock="pallas"), 2, 0.6)
    assert calls == [(4, 8, 64, 64)]
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=2e-5)


def test_discriminator_bf16():
    (c_j, l_j), (c_t, l_t) = _run(_critics("bfloat16"), 2, 1.0)
    scale = float(np.abs(l_j).max())
    np.testing.assert_allclose(c_t, c_j, atol=0.02 * scale)
    np.testing.assert_allclose(l_t, l_j, atol=0.02 * scale)


def test_parameter_set_is_stage_independent(f32_critics):
    _, params, td = f32_critics
    assert set(td.state_dict()) == set(from_jax_params(params))
    with pytest.raises(ValueError, match="expects"):
        td(torch.zeros(1, 4, 32, 2), 0)
