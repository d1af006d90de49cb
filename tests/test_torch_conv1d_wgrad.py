"""K6's route on the CPU (``kernels/conv1d_wgrad.py``, ``models/wavegan.py``):
the SAME conv ``C``, its input gradient ``T`` and its weight gradient
``W`` as three autograd functions, each differentiable through the
others, with ``W``'s plain version (the sum the kernel computes, folded
into seven taps) in float64.

- ``gradcheck`` and ``gradgradcheck`` of the three functions at each
  shape class of WaveGAN's layers at small B and L: C_in = 1 (the
  critic's first layer, the generator's last, K6's CUDA-core kernel); a
  4 C_in that is no multiple of the kernel's 64-channel tiles; L = 16
  (the critic's last layer, several batches a K tile); an odd L.
- The plain weight gradient against ``F.conv2d``'s own.
- The critic's gradients of a critic update's loss (real, fake and the
  penalty's second order through phase shuffle) and the generator
  update's, through the route, equal to the built-in ``F.conv2d`` /
  ``F.conv_transpose2d`` route within float64 rounding (1e-10 of each
  leaf's norm: the two sum the same products in another order).
- The launch record through the card's route (``kernel_route``: K6's gate
  takes the widths and the launch is the plain version): a WaveGAN step
  at d = 8 files 90 ``conv`` and 36 ``transpose`` calls, 15 and 6 at each
  layer's shape; the penalty's first-order call and the generator
  update's pass through the critic file none for the critic; a GANSynth
  step files none.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import conv1d_wgrad as K6
from gansynth_tpu_torch.kernels import launch_counts, record
from gansynth_tpu_torch.models import wavegan as wg
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    train_key,
)
from gansynth_tpu_torch.utils.config import Config
from torch_threads import two_torch_threads  # noqa: F401

# (B, C_in, C_out, L): C_in = 1 at L = 16; 4 C_in = 12 and 72, no
# multiple of 64; an odd L
SHAPES = [(2, 1, 3, 16), (2, 3, 8, 8), (1, 18, 2, 4), (3, 2, 5, 5)]


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _inputs(shape, seed=0):
    b, c_in, c_out, length = shape
    gen = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=gen, dtype=torch.float64)

    return (_cl(randn(b, c_in, 1, 4 * length)).requires_grad_(),
            _cl(randn(b, c_out, 1, length)).requires_grad_(),
            randn(c_out, c_in, 25).requires_grad_(),
            randn(c_out).requires_grad_())


FUNCTIONS = {
    "conv": (lambda x, gy, w, b: (x, w, b),
             lambda x, w, b: wg._SameConv.apply(x, w, b)),
    "transpose": (lambda x, gy, w, b: (gy, w),
                  lambda gy, w: wg._SameConvT.apply(gy, w)),
    "wgrad": (lambda x, gy, w, b: (x, gy),
              lambda x, gy: wg._Wgrad.apply(x, gy, "conv")),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_the_three_functions_differentiate_to_second_order(name, shape):
    pick, fn = FUNCTIONS[name]
    args = pick(*_inputs(shape))
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


@pytest.mark.parametrize("shape", SHAPES)
def test_the_plain_weight_gradient_is_conv2ds(shape):
    x, gy, w, _ = _inputs(shape, seed=1)
    w = w.detach().requires_grad_()
    y = F.conv2d(wg._pad_length(x.detach(), 10, 11), w.unsqueeze(2),
                 stride=(1, 4))
    want, = torch.autograd.grad(y, w, gy.detach())
    got = K6.conv1d_wgrad_plain(x.detach(), gy.detach())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # an NCHW-strided x reads the same
    got = K6.conv1d_wgrad_plain(x.detach().contiguous(), gy.detach())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_the_float32_card_form_is_the_plain_sum(shape):
    """``conv1d_wgrad_cudnn``, which float32 card tensors take, computes the
    plain version's sum (here in float64 on the CPU)."""
    x, gy, _, _ = _inputs(shape, seed=2)
    got = K6.conv1d_wgrad_cudnn(x.detach(), gy.detach())
    want = K6.conv1d_wgrad_plain(x.detach(), gy.detach())
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_a_call_off_the_cpu_that_k6_cannot_take_raises():
    """Off the CPU only K6 (bf16) and cuDNN (float32) serve: a bf16 call K6
    does not take raises rather than run the plain version unseen."""
    x = torch.empty(2, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    gy = torch.empty(2, 16, 1, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="K6 takes bf16"):
        K6.conv1d_wgrad(x, gy, "conv")


def test_wanted_raises_what_is_not_the_engines_leaf_refusal():
    """``_wanted`` reads only the engine's refusal for a leaf that
    ``autograd.grad`` asked for as "used"; any other error of the engine's
    question (here: asked outside a backward pass) is raised."""
    class Ctx:
        needs_input_grad = (True,)

    t = torch.ones(2, requires_grad=True) * 2
    with pytest.raises(RuntimeError):
        wg._wanted(Ctx, 0, t)


def _builtin_same_conv(h, w, b, stride):
    total = w.shape[-1] - stride
    return F.conv2d(wg._pad_length(h, total // 2, total - total // 2),
                    w.unsqueeze(2), b, stride=(1, stride))


def _builtin_same_conv_transpose(h, w, b, stride):
    total = w.shape[-1] - stride
    y = F.conv_transpose2d(h, w.unsqueeze(2), b, stride=(1, stride),
                           padding=(0, total // 2))
    return y[..., :stride * h.shape[-1]]


def _model_config(d):
    return Config().with_overrides({
        "model": {"architecture": "wavegan", "wavegan_dim": d,
                  "latent_dim": 16, "compute_dtype": "float32"},
        "train": {"critic_updates": 5, "batch_size": 2, "drift_weight": 0.0,
                  "unroll": 1}})


def _float64_nets(seed=5):
    cfg = _model_config(2)
    g = wg.WaveGANGenerator(cfg.model)
    d = wg.WaveGANDiscriminator(cfg.model)
    wg.init_wavegan(g, (0, seed))
    wg.init_wavegan(d, (1, seed))
    for net in (g, d):
        net.double()
        net.cdt = torch.float64
    return cfg, g, d


def _update_grads(cfg, g, d):
    """A critic update's loss gradients for the critic (real, fake and the
    penalty at interpolates, through phase shuffle) and the generator
    update's for G, in float64."""
    from gansynth_tpu_torch.train import losses

    gen = torch.Generator().manual_seed(9)
    labels = F.one_hot(torch.tensor([3, 40]), cfg.model.num_pitches).double()
    z = torch.rand(2, cfg.model.latent_dim, generator=gen,
                   dtype=torch.float64) * 2 - 1
    real = 0.3 * torch.randn(2, wg.SLICE_LEN, generator=gen,
                             dtype=torch.float64)
    u = torch.rand(2, 1, generator=gen, dtype=torch.float64)
    shifts = torch.tensor([[2, -1, 0, 1], [-2, 1, 2, 0], [1, 0, -1, 2]])
    with torch.no_grad():
        fake = g(z, labels)
    c_real, logits = d(real, shifts[0])
    c_fake, _ = d(fake, shifts[1])
    gp = losses.gradient_penalty(lambda x: d(x, shifts[2]), real, fake, u)
    d_loss = losses.wgan_critic_loss(c_real, c_fake) + 10.0 * gp \
        + losses.pitch_cross_entropy(logits, labels)
    d_grads = torch.autograd.grad(d_loss, list(d.parameters()),
                                  allow_unused=True)
    c_gen, _ = d(g(z, labels), shifts[0])
    g_grads = torch.autograd.grad(-c_gen.mean(), list(g.parameters()))
    return d_grads, g_grads


def test_an_updates_gradients_are_the_builtin_routes(monkeypatch):
    cfg, g, d = _float64_nets()
    got = _update_grads(cfg, g, d)
    monkeypatch.setattr(wg, "same_conv", _builtin_same_conv)
    monkeypatch.setattr(wg, "same_conv_transpose",
                        _builtin_same_conv_transpose)
    want = _update_grads(cfg, g, d)
    names = [n for n, _ in d.named_parameters()] + \
        [n for n, _ in g.named_parameters()]
    for name, a, b in zip(names, got[0] + got[1], want[0] + want[1]):
        assert (a is None) == (b is None), name
        if b is not None:
            assert float((a - b).norm()) <= 1e-10 * float(b.norm()), name


@pytest.fixture
def kernel_route(monkeypatch):
    """The card's route on the CPU: K6's gate takes every call whose widths
    fit, and the launch is the plain version, so that ``kernels.count``
    files each call."""
    monkeypatch.setattr(K6, "wgrad_eligible",
                        lambda x, gy: K6.widths_fit(x.shape[1], gy.shape[1]))
    monkeypatch.setattr(K6, "_launch", K6.conv1d_wgrad_plain)


def _k6_delta(before):
    now = record()
    return {k[1:]: now[k] - before.get(k, 0) for k in now
            if k[0] == "conv1d_wgrad" and now[k] != before.get(k, 0)}


def _wavegan_state(cfg):
    g = wg.WaveGANGenerator(cfg.model)
    d = wg.WaveGANDiscriminator(cfg.model)
    ema = wg.WaveGANGenerator(cfg.model)
    for i, net in enumerate((g, d, ema)):
        wg.init_wavegan(net, (i, 7))
    for p in ema.parameters():
        p.requires_grad_(False)
    return TrainState(g=g, d=d, ema=ema,
                      g_opt=make_optimizer(cfg, g.parameters()),
                      d_opt=make_optimizer(cfg, d.parameters()),
                      rng=train_key(11))


def _layer_shapes(d, batch):
    """(B, L, C_in, C_out) of the critic's six layers (the generator's
    mirror them)."""
    chans = wg.widths(_model_config(d).model)
    return [(batch, wg.SLICE_LEN // 4 ** (i + 1), chans[i], chans[i + 1])
            for i in range(wg.LAYERS)]


def test_a_wavegan_step_takes_every_weight_gradient_through_k6(
        kernel_route):
    cfg = _model_config(8)
    state = _wavegan_state(cfg)
    rng = np.random.default_rng(3)
    waves = torch.from_numpy(
        (0.3 * rng.standard_normal((4, 64000))).astype(np.float32))
    pitches = torch.from_numpy(rng.integers(24, 85, 4).astype(np.int32))
    superstep = tstep.make_cached_superstep(cfg, 0, 4)
    before, named = record(), launch_counts()
    superstep(state, waves, pitches, [1.0])
    want = {}
    for shape in _layer_shapes(8, 2):
        want[("conv", *shape)] = 15         # real, fake, interpolates x 5
        want[("transpose", *shape)] = 6     # 5 penalties + G's mirror
    assert _k6_delta(before) == want
    now = launch_counts()
    assert now["conv1d_wgrad_conv"] - named["conv1d_wgrad_conv"] == 90
    assert now["conv1d_wgrad_transpose"] \
        - named["conv1d_wgrad_transpose"] == 36


def test_unread_weight_gradients_launch_nothing(kernel_route):
    """The penalty's first-order call asks for the interpolates' gradient
    alone, and the generator update's loss for G's: neither launches K6
    for the critic's weights."""
    cfg = _model_config(8)
    state = _wavegan_state(cfg)
    gen = torch.Generator().manual_seed(2)
    shifts = torch.tensor([1, -2, 0, 2])
    x = (0.3 * torch.randn(2, wg.SLICE_LEN, generator=gen)).requires_grad_()
    before = record()
    gx, = torch.autograd.grad(state.d(x, shifts)[0].sum(), x,
                              create_graph=True)
    assert _k6_delta(before) == {}
    labels = F.one_hot(torch.tensor([3, 40]), cfg.model.num_pitches).float()
    z = torch.rand(2, cfg.model.latent_dim, generator=gen) * 2 - 1
    score, _ = state.d(state.g(z, labels), shifts)
    torch.autograd.grad(score.mean(), list(state.g.parameters()))
    assert _k6_delta(before) == {("transpose", *s): 1
                                 for s in _layer_shapes(8, 2)}
    assert gx.shape == x.shape


def test_a_gansynth_step_launches_no_k6(kernel_route):
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.state import create_train_state

    cfg = Config().with_overrides({
        "model": dict(latent_dim=8, fmap_base=256, fmap_max=128,
                      fmap_min=8),
        "train": dict(batch_size=2)})
    state = create_train_state(cfg, seed=0, device="cpu")
    waves, pitches = note_batch(2)
    before = record()
    tstep.make_train_step(cfg, 1)(state, torch.from_numpy(waves),
                                  torch.from_numpy(pitches), 1.0)
    assert _k6_delta(before) == {}
