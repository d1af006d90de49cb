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
import torch.nn.functional as F

import gansynth_tpu.kernels.pallas_dblock as pd
from gansynth_tpu.models.discriminator import DiscriminatorBlock as JBlock
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import launch_counts
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
    before = launch_counts()
    K3.fused_dblock(*_torch(_inputs(1, 8, 16)), 0.2)
    assert launch_counts() == before   # the CPU takes the plain path
    t = _torch(_inputs(1, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        K3.fused_dblock(t[0][..., :32], *t[1:], 0.2)


# The card's routing of K3's backward, on the CPU: ``_on_card`` answers
# True, the forward's kernel is the chain's saving version and the
# backward's kernels are their plain versions, so that the Function takes
# the route it takes on a card.
def _install_kernel_route(monkeypatch):
    calls = {"spread": 0, "mask": 0}

    def launch(x, k0, b0, k1, b1, slope, save):
        if save:
            return K3.dblock_saving_plain(x, k0, b0, k1, b1, slope)
        return K3.dblock_plain(x, k0, b0, k1, b1, slope), None, None

    def spread(g, mask, slope, bias):
        calls["spread"] += 1
        return K3.spread_plain(g, mask, slope)

    def mask_grad(a0, g_a0, slope, bias):
        calls["mask"] += 1
        return K3.mask_grad_plain(a0, g_a0, slope)

    monkeypatch.setattr(K3, "_on_card", lambda x: True)
    monkeypatch.setattr(K3, "_launch", launch)
    monkeypatch.setattr(K3, "_spread", spread)
    monkeypatch.setattr(K3, "_mask_grad", mask_grad)
    return calls


@pytest.fixture
def kernel_route(monkeypatch):
    return _install_kernel_route(monkeypatch)


def _backwards(before):
    """K3's backwards by route since ``before`` (``launch_counts()``)."""
    now = launch_counts()
    return {route: now[name] - before[name] for route, name in
            (("kernel", "dblock_backward"),
             ("plain", "dblock_backward_plain"))}


def _critic_and_images(seed=6, remat=False):
    """A narrow critic whose stage-3 block (64 channels at 16 x 128) takes
    K3, and a real and a fake image at that stage."""
    from gansynth_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(fmap_base=512, fmap_max=128, fmap_min=8,
                      dblock_kernel="pallas", remat=remat)
    critic = tdisc.Discriminator(cfg, generator=torch.Generator()
                                 .manual_seed(seed))
    rng = np.random.default_rng(seed)
    real, fake = (torch.from_numpy(rng.standard_normal((2, 16, 128, 2))
                                   .astype(np.float32)) for _ in range(2))
    return critic, real, fake


def _critic_loss(critic, real, fake):
    """WGAN-GP's critic loss as the training step takes it: the real and
    fake scores, and the penalty's gradient at interpolates
    (``create_graph=True``)."""
    from gansynth_tpu_torch.train import losses

    fn = lambda image: critic(image, 3)   # noqa: E731
    u = torch.full((2, 1, 1, 1), 0.375)
    return (losses.wgan_critic_loss(fn(real)[0], fn(fake)[0])
            + 10.0 * losses.gradient_penalty(fn, real, fake, u))


def test_kernel_route_under_backward_never_under_create_graph(kernel_route):
    """The penalty's ``create_graph`` call takes the plain adjoints; the
    loss's ``backward()`` takes the kernels at each of its three K3 nodes
    (real, fake, and the interpolates' forward), as a critic update does
    on a card; the counters say so."""
    from gansynth_tpu_torch.train import losses

    critic, real, fake = _critic_and_images()
    before = launch_counts()
    x_hat = losses.interpolate(real, fake, torch.full((2, 1, 1, 1), 0.375))
    x_hat.requires_grad_()
    torch.autograd.grad(critic(x_hat, 3)[0].sum(), x_hat, create_graph=True)
    assert kernel_route == {"spread": 0, "mask": 0}
    assert _backwards(before) == {"kernel": 0, "plain": 1}
    _critic_loss(critic, real, fake).backward()
    assert kernel_route == {"spread": 3, "mask": 3}
    assert _backwards(before) == {"kernel": 3, "plain": 2}


@pytest.mark.parametrize("remat", [False, True])
def test_critic_gradients_through_the_kernel_route(monkeypatch, remat):
    """The critic's gradients (WGAN-GP's loss, the penalty's second order
    included) through the kernel route equal the plain route's: the
    route's a0 and masks are the chain's, and its convs the same. With
    ``remat`` each block runs under non-reentrant checkpointing, whose
    saved tensors a backward may unpack only once."""
    critic, real, fake = _critic_and_images(remat=remat)
    _critic_loss(critic, real, fake).backward()
    want = {k: p.grad.clone() for k, p in critic.named_parameters()
            if p.grad is not None}
    assert "blocks.3.conv0.weight" in want
    critic.zero_grad(set_to_none=True)
    calls = _install_kernel_route(monkeypatch)
    _critic_loss(critic, real, fake).backward()
    assert calls == {"spread": 3, "mask": 3}
    got = {k: p.grad for k, p in critic.named_parameters()
           if p.grad is not None}
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_saving_forward_and_the_plain_kernels():
    """The chain's saving forward gives dblock_plain's y to the bit, and a0
    and the mask in the kernel's layout (8 bytes a 64-channel pass:
    channel 8 j + 2 t + e of a pass is bit 2 j + e of its halfword t);
    the spread's and the mask kernel's plain versions give the plain
    route's g_z1 and g_z0."""
    x, k0, b0, k1, b1 = _torch(_inputs(1, 8, 16, c1=72, seed=7))
    y, a0, mask = K3.dblock_saving_plain(x, k0, b0, k1, b1, 0.2)
    assert torch.equal(y, K3.dblock_plain(x, k0, b0, k1, b1, 0.2))
    assert mask.dtype == torch.uint8 and mask.shape == (1, 8, 16, 16)
    z1 = F.conv2d(a0.permute(0, 3, 1, 2), k1, padding=1) + b1[:, None, None]
    bits = (z1 >= 0).permute(0, 2, 3, 1)
    assert torch.equal(K3.unpack_mask(mask, 72), bits)
    assert not K3.unpack_mask(mask, 128)[..., 72:].any()   # past C1: 0
    for channel, byte, bit in ((10, 2, 2), (63, 7, 7), (64, 8, 0),
                               (71, 14, 1)):
        one = torch.zeros(1, 1, 1, 72, dtype=torch.bool)
        one[..., channel] = True
        want = [0] * 16
        want[byte] = 1 << bit
        assert K3.pack_mask(one)[0, 0, 0].tolist() == want
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        y.shape).astype(np.float32))
    g_z1, db1 = K3.spread_plain(g, mask, 0.2)
    g_a1 = (g * 0.25).repeat_interleave(2, 1).repeat_interleave(2, 2)
    assert torch.equal(g_z1, torch.where(bits, g_a1, 0.2 * g_a1))
    assert torch.equal(db1, g_z1.sum((0, 1, 2)))
    g_z0, db0 = K3.mask_grad_plain(a0, g_z1[..., :64], 0.2)
    assert torch.equal(g_z0, torch.where(a0 >= 0, g_z1[..., :64],
                                         0.2 * g_z1[..., :64]))
    assert torch.equal(db0, g_z0.sum((0, 1, 2)))


def test_a_width_the_kernels_lack_keeps_the_plain_backward(kernel_route,
                                                           monkeypatch):
    """A C1 that is no multiple of 8 (``cli train --fmap-max 100`` gives
    the stage-6 block 100) passes K3's gate; its forward keeps nothing and
    its backward under grad mode off takes the plain adjoints, with the
    plain route's gradients; a width the kernels take keeps a0 and the
    mask."""
    saves = []
    launch = K3._launch

    def recording(*args):
        saves.append(args[-1])
        return launch(*args)

    monkeypatch.setattr(K3, "_launch", recording)
    assert K3.dblock_eligible((1, 8, 16, 64), 64, 100)
    assert not K3.keeps_for_backward(100) and K3.keeps_for_backward(72)
    args = _torch(_inputs(1, 8, 16, c1=100, seed=9), grad=True)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, 4, 8, 100)).astype(np.float32))
    before = launch_counts()
    got = torch.autograd.grad(K3.fused_dblock(*args, 0.2), args, g)
    assert saves == [False]
    assert kernel_route == {"spread": 0, "mask": 0}
    assert _backwards(before) == {"kernel": 0, "plain": 1}
    want = torch.autograd.grad(K3.dblock_plain(*args, 0.2), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    K3.fused_dblock(*_torch(_inputs(1, 8, 16, c1=72, seed=9), grad=True),
                    0.2)
    assert saves == [False, True]
