"""K5, the critic's fromRGB (``kernels/from_rgb.py``), on the CPU.

On a CPU tensor the layer runs the plain chain itself, bit for bit as
before and counting nothing. The plain versions of the two kernels of its
backward, ``contract`` and ``expand``, are held to autograd of the chain
(first order) and to each other's derivatives; the autograd functions
that the card runs pass ``gradcheck`` and ``gradgradcheck`` in float64 with
them, and WGAN-GP's penalty differentiated through them equals the
chain's. With the card's route installed (``_on_card`` answers True and
the launches are the plain versions), a training step takes every
fromRGB call through K5, counted by ``kernels.count``, and the critic's
gradients, the penalty's second order included, are the chain's.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import from_rgb as K5
from gansynth_tpu_torch.kernels import launch_counts, record
from gansynth_tpu_torch.models.layers import EqualizedConv, leaky_relu

SLOPE = 0.2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _inputs(shape=(2, 3, 5, 2), c_out=8, dtype=torch.float64, seed=0):
    """x [B, H, W, C_in], w [C_out, C_in], b [C_out] and a gradient g of y,
    in ``dtype``."""
    gen = _gen(seed)
    x = 2 * torch.rand(shape, generator=gen, dtype=torch.float64) - 1
    w = torch.randn((c_out, shape[-1]), generator=gen, dtype=torch.float64)
    b = 0.3 * torch.randn(c_out, generator=gen, dtype=torch.float64)
    g = torch.randn((*shape[:-1], c_out), generator=gen, dtype=torch.float64)
    return [t.to(dtype) for t in (x, w, b, g)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_layer_is_the_chain_on_the_cpu(dtype):
    """``EqualizedConv.lrelu`` on a fromRGB gives ``leaky_relu(conv(x))``
    and its gradients to the bit, and launches nothing."""
    conv = EqualizedConv(2, 64, kernel_size=(1, 1), compute_dtype=dtype,
                         generator=_gen(1))
    with torch.no_grad():
        conv.bias.copy_(0.1 * torch.randn(64, generator=_gen(2)))
    x = (2 * torch.rand((2, 8, 16, 2), generator=_gen(3)) - 1)
    outs = []
    before = record()
    for fn in (lambda v: conv.lrelu(v, SLOPE),
               lambda v: leaky_relu(conv(v), SLOPE)):
        xr = x.clone().requires_grad_()
        y = fn(xr)
        g = torch.randn(y.shape, generator=_gen(4)).to(y.dtype)
        outs.append((y, *torch.autograd.grad(
            y, (xr, conv.weight, conv.bias), g)))
    assert record() == before
    for got, want in zip(*outs):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_the_gate_takes_the_fromrgb_widths():
    """1x1, fan-in 1 to 4, float32 or bf16, C_out a power of two from 8 to
    256: every fromRGB of the configs (``fmap_base >> stage``); nothing
    else."""
    ok = K5.from_rgb_eligible
    for c_out in (8, 16, 32, 64, 128, 256):
        assert ok((1, 1), 2, c_out, torch.bfloat16)
        assert ok((1, 1), 2, c_out, torch.float32)
    for c_in in (1, 3, 4):
        assert ok((1, 1), c_in, 64, torch.bfloat16)
    assert not ok((3, 3), 2, 64, torch.bfloat16)
    assert not ok((1, 1), 5, 64, torch.bfloat16)
    assert not ok((1, 1), 0, 64, torch.bfloat16)
    for c_out in (4, 24, 96, 512):
        assert not ok((1, 1), 2, c_out, torch.bfloat16)
    assert not ok((1, 1), 2, 64, torch.float16)
    assert not ok((1, 1), 2, 64, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_contract_is_the_chains_first_order(dtype):
    """contract(g; x, w) is the chain's backward: (gx, gw, gb) of autograd
    through ``from_rgb_plain`` (in bf16 the chain rounds each product
    before its sum, contract sums in float32: within 1 % by relative L2);
    ``want`` drops outputs."""
    x, w, b, g = _inputs((2, 4, 6, 2), 16, dtype, seed=5)
    xs = [t.clone().requires_grad_() for t in (x, w, b)]
    chain = torch.autograd.grad(K5.from_rgb_plain(*xs, SLOPE), xs, g)
    got = K5.from_rgb_contract_plain(g, x, w, x, w, b, SLOPE)
    bar = {torch.float64: 1e-12, torch.float32: 1e-6,
           torch.bfloat16: 1e-2}[dtype]
    for a, c in zip(got, chain):
        assert a.dtype == dtype and a.shape == c.shape
        err = float((a.double() - c.double()).norm() / c.double().norm())
        assert err <= bar
    none = K5.from_rgb_contract_plain(g, None, w, x, w, b, SLOPE,
                                      (True, False, False))
    assert none[1] is None and none[2] is None
    assert torch.equal(none[0], got[0])


def test_expand_is_the_derivative_of_contract():
    """In float64: the derivative of contract's (A, B, C) for (dA, dB, dC)
    with respect to g is expand(dA, dB, dC; x1, w1), and with respect to
    x1 and w1 it is contract(g; dA, dB)'s A and B."""
    x, w, b, g = _inputs((2, 3, 4, 3), 8, seed=6)
    x1, w1 = torch.randn_like(x), torch.randn_like(w)
    da = torch.randn_like(x)
    dB, dc = torch.randn_like(w), torch.randn_like(b)
    leaves = [t.clone().requires_grad_() for t in (g, x1, w1)]
    out = K5.from_rgb_contract_plain(*leaves, x, w, b, SLOPE)
    dg, dx1, dw1 = torch.autograd.grad(out, leaves, (da, dB, dc))
    expand = K5.from_rgb_expand_plain(da, dB, dc, x1, w1, x, w, b, SLOPE)
    torch.testing.assert_close(dg, expand, rtol=1e-12, atol=1e-12)
    a, bb, _ = K5.from_rgb_contract_plain(g, da, dB, x, w, b, SLOPE)
    torch.testing.assert_close(dx1, a, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw1, bb, rtol=1e-12, atol=1e-12)
    # a term left out adds nothing
    only = K5.from_rgb_expand_plain(None, None, dc, None, None, x, w, b,
                                    SLOPE)
    z = K5._preact(x, w, b)
    assert torch.equal(only, torch.where(z > 0, dc.expand_as(only),
                                         dc * SLOPE))


def _functions(x, w, b, g):
    """The three autograd functions as functions of their differentiable
    inputs, the mask's (x, w, b) held."""
    xd, wd, bd = x.detach(), w.detach(), b.detach()
    return {
        "forward": (lambda x_, w_, b_: K5._FromRGB.apply(x_, w_, b_, SLOPE),
                    (x, w, b)),
        "contract": (lambda g_, x1, w1: K5._Contract.apply(
            g_, x1, w1, xd, wd, bd, SLOPE, (True, True, True)),
            (g, torch.randn_like(x), torch.randn_like(w))),
        "expand": (lambda dx, dw, db, x1, w1: K5._Expand.apply(
            dx, dw, db, x1, w1, xd, wd, bd, SLOPE),
            (torch.randn_like(x), torch.randn_like(w), torch.randn_like(b),
             torch.randn_like(x), torch.randn_like(w))),
    }


@pytest.mark.parametrize("fn", ["forward", "contract", "expand"])
def test_the_route_is_differentiable_twice(fn):
    """gradcheck and gradgradcheck in float64 of each autograd function
    (the CPU runs their plain versions): the forward's backward is
    contract, contract's is expand and contract, expand's is contract."""
    x, w, b, g = _inputs((1, 2, 3, 2), 8, seed=7)
    f, args = _functions(x, w, b, g)[fn]
    args = [a.detach().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(f, args)
    assert torch.autograd.gradgradcheck(f, args)


def _score(fromrgb, x, w, b, k, v):
    """A small critic around a fromRGB: its LeakyReLU'd output through a 3x3
    conv, a LeakyReLU and a dense head of its squares (so that the
    penalty's gradient reaches every parameter), a score a sample."""
    a = fromrgb(x, w, b, SLOPE).permute(0, 3, 1, 2)
    a = F.leaky_relu(F.conv2d(a, k, padding=1), SLOPE)
    return (a * a).flatten(1) @ v


def _penalty_grads(fromrgb, x, params):
    x_hat = x.detach().requires_grad_()
    gx, = torch.autograd.grad(_score(fromrgb, x_hat, *params).sum(), x_hat,
                              create_graph=True)
    penalty = ((gx.flatten(1).norm(dim=1) - 1) ** 2).mean()
    return torch.autograd.grad(penalty, params)


def test_the_penalty_double_backward_equals_the_chains():
    """WGAN-GP's penalty differentiated for the critic's parameters, in
    float64: through the route (its create_graph call and its double
    backward run contract and expand) as through the chain."""
    x, w, b, _ = _inputs((2, 4, 8, 2), 8, seed=8)
    gen = _gen(9)
    k = 0.3 * torch.randn((4, 8, 3, 3), generator=gen, dtype=torch.float64)
    v = 0.1 * torch.randn((4 * 4 * 8,), generator=gen, dtype=torch.float64)
    params = [t.requires_grad_() for t in (w, b, k, v)]
    route = _penalty_grads(K5._FromRGB.apply, x, params)
    chain = _penalty_grads(K5.from_rgb_plain, x, params)
    for a, c in zip(route, chain):
        assert float(c.abs().max()) > 0
        torch.testing.assert_close(a, c, rtol=1e-10, atol=1e-12)


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's route on the CPU: ``_on_card`` answers True and the three
    launches are their plain versions, so that the layer takes the
    autograd functions and ``kernels.count`` files each call."""
    monkeypatch.setattr(K5, "_on_card", lambda t: True)
    monkeypatch.setattr(K5, "_launch_forward", K5.from_rgb_plain)
    monkeypatch.setattr(K5, "_launch_contract", K5.from_rgb_contract_plain)
    monkeypatch.setattr(K5, "_launch_expand", K5.from_rgb_expand_plain)


def _k5_delta(before):
    """K5's calls in the record since ``before`` (an earlier ``record()``),
    by ``(role, B, H, W, C_out)``."""
    now = record()
    return {k[1:]: now[k] - before.get(k, 0) for k in now
            if k[0] == "from_rgb" and now[k] != before.get(k, 0)}


# A narrow config at stage 2 (8 x 64): from_rgb[2] 64 wide, the fade-in
# skip's from_rgb[1] 128.
NARROW = {"model": dict(latent_dim=8, fmap_base=256, fmap_max=128,
                        fmap_min=8),
          "train": dict(batch_size=2)}


def _step_inputs():
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.utils.config import Config

    cfg = Config().with_overrides(NARROW)
    waves, pitches = note_batch(2)
    return (cfg, create_train_state(cfg, seed=3, device="cpu"),
            torch.from_numpy(waves), torch.from_numpy(pitches))


def test_a_step_takes_every_fromrgb_call_through_k5(kernel_route):
    """A training step in the fade at stage 2 calls K5 at both fromRGBs:
    each 4 forwards (real, fake, the interpolates, the generator update's
    fake), 6 contracts (the critic loss's backward through real, fake and
    the interpolates' forward; the penalty's create_graph call; its double
    backward's weight term; the generator update's backward) and 1 expand
    (the double backward's gradient of g); ``launch_counts`` names them,
    and K2's and K4's views see none of it."""
    from gansynth_tpu_torch.kernels import gen_epilogue_shapes, launch_shapes
    from gansynth_tpu_torch.train.step import make_train_step

    cfg, state, waves, pitches = _step_inputs()
    views = launch_shapes(), gen_epilogue_shapes()
    before, named = record(), launch_counts()
    make_train_step(cfg, 2)(state, waves, pitches, 0.5)
    want = {}
    for shape in ((2, 8, 64, 64), (2, 4, 32, 128)):
        want.update({("forward", *shape): 4, ("contract", *shape): 6,
                     ("expand", *shape): 1})
    assert _k5_delta(before) == want
    now = launch_counts()
    assert {k: now[k] - named[k] for k in now if k.startswith("from_rgb")} \
        == {"from_rgb_forward": 8, "from_rgb_contract": 12,
            "from_rgb_expand": 2, "from_rgb_recompute": 0}
    assert (launch_shapes(), gen_epilogue_shapes()) == views


def _critic_grads(critic, real, fake):
    """The critic's gradients of WGAN-GP's loss as the step takes it (the
    real and fake scores, and the penalty at interpolates with
    ``create_graph``), at stage 2 in the fade."""
    from gansynth_tpu_torch.train import losses

    def critic_fn(x):
        return critic(x, 2, 0.5)

    u = torch.full((2, 1, 1, 1), 0.375)
    c_real, _ = critic_fn(real)
    c_fake, _ = critic_fn(fake)
    loss = (losses.wgan_critic_loss(c_real, c_fake)
            + 10.0 * losses.gradient_penalty(critic_fn, real, fake, u)
            + 1e-3 * losses.drift_penalty(c_real))
    params = dict(critic.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: g for k, g in zip(params, grads) if g is not None}


def test_the_critic_through_k5_has_the_chains_gradients(kernel_route):
    """The critic's float32 gradients (the penalty's second order
    included) through the route equal the chain's up to the float32
    sums' order (the forward is the chain's to the bit), both fromRGBs
    among them; a training step's metrics too."""
    from gansynth_tpu_torch.train.step import make_train_step

    cfg, state, waves, pitches = _step_inputs()
    rng = np.random.default_rng(11)
    real, fake = (torch.from_numpy(rng.uniform(-1, 1, (2, 8, 64, 2))
                                   .astype(np.float32)) for _ in range(2))
    got = _critic_grads(state.d, real, fake)
    chain_state = copy.deepcopy(state)
    _, metrics = make_train_step(cfg, 2)(state, waves, pitches, 0.5)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(K5, "_on_card", lambda t: False)
        want = _critic_grads(chain_state.d, real, fake)
        _, chain_metrics = make_train_step(cfg, 2)(chain_state, waves,
                                                   pitches, 0.5)
    assert {"from_rgb.2.weight", "from_rgb.1.weight",
            "from_rgb.2.bias"} <= want.keys()
    assert got.keys() == want.keys()
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()), msg=k)
    for k, v in chain_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
