"""K3, the port's fused critic block (``kernels/dblock.py``), against the
reference's ``fused_dblock`` run in interpret mode, and its routing in the
critic.

On the CPU the port's wrapper takes its plain version (the literal chain)
through the same autograd Function that launches the kernel on the card,
so these tests hold the Function's explicit adjoints to the reference's
VJP. Tolerances are those of ``tests/test_pallas_dblock.py``: values
1e-5; first order rtol 1e-3, atol 1e-4; the gradient-penalty second
order rtol 1e-4, atol 1e-5, where the second order's atol is taken of
the gradient's scale (its largest entry, about 20 here): that file
compares two lowerings inside one library, and here the convs of the
two libraries sum in other orders, which leaves a few entries of
cancelling sums about 3e-5 apart (1.6e-6 of the scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gansynth_tpu.kernels.pallas_dblock as pd
from gansynth_tpu.models.discriminator import DiscriminatorBlock as JBlock
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.models import discriminator as tdisc
from gansynth_tpu_torch.utils.checkpoint import from_jax_params

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _inputs(b, h, w, c1=128, seed=0):
    """x, k0, b0, k1, b1 as numpy; kernels HWIO (the reference's)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    return (f(b, h, w, 64), f(3, 3, 64, 64, scale=0.1), f(64, scale=0.1),
            f(3, 3, 64, c1, scale=0.1), f(c1, scale=0.1))


def _torch(args, grad=False):
    x, k0, b0, k1, b1 = (np.array(a) for a in args)
    out = [torch.from_numpy(x), torch.from_numpy(k0.transpose(3, 2, 0, 1)
                                                 .copy()),
           torch.from_numpy(b0), torch.from_numpy(k1.transpose(3, 2, 0, 1)
                                                  .copy()),
           torch.from_numpy(b1)]
    return [t.requires_grad_(grad) for t in out]


def _hwio(t):
    return t.numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("shape", [(2, 8, 32), (1, 8, 48), (3, 12, 16)])
def test_forward_matches_reference(shape):
    args = _inputs(*shape)
    want = np.asarray(pd.fused_dblock(*map(jnp.asarray, args), 0.2, True))
    got = K3.fused_dblock(*_torch(args), 0.2).numpy()
    b, h, w = shape
    assert got.shape == want.shape == (b, h // 2, w // 2, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_forward_matches_reference():
    args = _inputs(2, 8, 32, c1=64, seed=1)
    jx = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = np.asarray(pd._literal_chain(jx, *map(jnp.asarray, args[1:]),
                                        slope=0.2).astype(jnp.float32))
    t = _torch(args)
    got = K3.fused_dblock(t[0].to(torch.bfloat16), *t[1:], 0.2).float()
    # bf16 in, f32 accumulation inside both; last bits only
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


def test_first_order_matches_reference():
    args = _inputs(1, 8, 16, seed=2)
    jg = jax.grad(
        lambda *a: jnp.sum(pd.fused_dblock(*a, 0.2, True) ** 2),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    t = _torch(args, grad=True)
    tg = torch.autograd.grad((K3.fused_dblock(*t, 0.2) ** 2).sum(), t)
    for i, (a, b) in enumerate(zip(tg, jg)):
        a = _hwio(a) if i in (1, 3) else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4)


def test_second_order_gp_matches_reference():
    """d/dk0 of ||d sum(block(x))/dx||^2 — the double backward of the
    explicit adjoints."""
    x, k0, b0, k1, b1 = _inputs(1, 8, 16, seed=3)

    def gp(k0_):
        gx = jax.grad(lambda xi: jnp.sum(pd.fused_dblock(
            xi, k0_, jnp.asarray(b0), jnp.asarray(k1), jnp.asarray(b1),
            0.2, True)))(jnp.asarray(x))
        return jnp.sum(gx ** 2)

    want = np.asarray(jax.grad(gp)(jnp.asarray(k0)))
    t = _torch((x, k0, b0, k1, b1))
    t[0].requires_grad_()
    t[1].requires_grad_()
    gx, = torch.autograd.grad(K3.fused_dblock(*t, 0.2).sum(), t[0],
                              create_graph=True)
    got, = torch.autograd.grad((gx ** 2).sum(), t[1])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_hwio(got), want, rtol=1e-4,
                               atol=1e-5 * scale)


def test_grads_when_x_needs_none():
    """The critic's real and fake passes: only the weights need grads."""
    t = _torch(_inputs(1, 8, 16, seed=4))
    for p in t[1:]:
        p.requires_grad_()
    g_k = torch.autograd.grad(K3.fused_dblock(*t, 0.2).sum(), t[1:])
    g_p = torch.autograd.grad(K3.dblock_plain(*t, 0.2).sum(), t[1:])
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x_shape,c0,c1", [
    ((8, 128, 1024, 64), 64, 128), ((8, 64, 512, 128), 128, 256),
    ((8, 128, 1024, 64), 128, 128), ((8, 130, 1024, 64), 64, 128),
    ((8, 128, 1020, 64), 64, 128), ((8, 4, 16, 64), 64, 128),
    ((2, 8, 32, 64), 64, 96)])
def test_gate_is_the_reference_gate(x_shape, c0, c1):
    assert K3.dblock_eligible(x_shape, c0, c1) == pd.dblock_eligible(
        x_shape, c0, c1)


def test_block_routes_eligible_input_to_k3(monkeypatch):
    """DiscriminatorBlock(dblock_kernel='pallas') takes K3 on the 64-channel
    geometry with the plain path's parameters, and equals the reference's
    block; a 128-channel input stays on the convs."""
    calls = []
    real = tdisc.fused_dblock

    def counted(x, *a):
        calls.append(tuple(x.shape))
        return real(x, *a)

    monkeypatch.setattr(tdisc, "fused_dblock", counted)
    real_j = pd.fused_dblock
    monkeypatch.setattr(pd, "fused_dblock",
                        lambda x, k0, b0, k1, b1, slope, interpret: real_j(
                            x, k0, b0, k1, b1, slope, True))
    x = np.random.default_rng(5).standard_normal((2, 8, 32, 64)).astype(
        np.float32)
    jb = JBlock(64, 96, dblock_kernel="pallas")
    params = jb.init(jax.random.key(1), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.1, params)   # nonzero biases
    want = np.asarray(jb.apply(params, jnp.asarray(x)))
    fused = tdisc.DiscriminatorBlock(64, 96, dblock_kernel="pallas")
    plain = tdisc.DiscriminatorBlock(64, 96)
    state = from_jax_params(params)
    fused.load_state_dict(state)
    plain.load_state_dict(state)
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
        got_plain = plain(torch.from_numpy(x)).numpy()
        tdisc.DiscriminatorBlock(128, 96, dblock_kernel="pallas")(
            torch.zeros(2, 8, 32, 128))
    assert calls == [(2, 8, 32, 64)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_plain, want, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_shapes_and_counts_only_launches():
    before = K3.fused_dblock.launches
    K3.fused_dblock(*_torch(_inputs(1, 8, 16)), 0.2)
    assert K3.fused_dblock.launches == before   # the CPU takes the plain path
    t = _torch(_inputs(1, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        K3.fused_dblock(t[0][..., :32], *t[1:], 0.2)
