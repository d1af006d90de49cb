"""The port's losses, Adam, EMA update and schedule against the reference's
(``train/losses.py``, ``train/state.py``, ``train/schedule.py``).

Inputs are numpy arrays from a seed handed to both packages; the
gradient penalty's interpolation weights are the reference's draw from
its key, passed to the port. Losses agree to float32 rounding (rtol
1e-6). Adam is held to optax over 3 updates in which one parameter's
stage activates at update 3: optax keeps one step count and gives the
inactive parameter zero gradients, the port's Adam gets ``None`` there
and must update as optax does (rtol 1e-6, atol 1e-9).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gansynth_tpu.train import losses as jlosses
from gansynth_tpu.train import schedule as jsched
from gansynth_tpu.train.state import ema_update as j_ema
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.cli import run_config
from gansynth_tpu_torch.train import losses as tlosses
from gansynth_tpu_torch.train import schedule as tsched
from gansynth_tpu_torch.train.state import Adam, ema_update, make_optimizer
from gansynth_tpu_torch.utils.config import Config


FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runs", "flagship_r4")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_scalar_losses():
    cr, cf = _x((6,), 0), _x((6,), 1)
    logits, labels = _x((6, 61), 2, 3.0), np.eye(61, dtype=np.float32)[
        [0, 5, 9, 60, 33, 2]]
    pairs = [
        (tlosses.wgan_critic_loss(_t(cr), _t(cf)),
         jlosses.wgan_critic_loss(cr, cf)),
        (tlosses.drift_penalty(_t(cr)), jlosses.drift_penalty(cr)),
        (tlosses.generator_adversarial_loss(_t(cf)),
         jlosses.generator_adversarial_loss(cf)),
        (tlosses.pitch_cross_entropy(_t(logits), _t(labels)),
         jlosses.pitch_cross_entropy(logits, labels)),
        (tlosses.penalty_from_grads(_t(_x((6, 3, 4, 2), 3))),
         jlosses.penalty_from_grads(_x((6, 3, 4, 2), 3))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_gradient_penalty_with_the_reference_draw():
    """A critic coupled across samples (like minibatch stddev): the
    gradient of the SUM of scores with respect to the whole batch."""
    real, fake = _x((3, 2, 4, 1), 4), _x((3, 2, 4, 1), 5)
    wj = _x((8,), 6)
    key = jax.random.key(11)

    def jcritic(x):
        flat = x.reshape(x.shape[0], -1)
        return (flat ** 2) @ wj + jnp.mean(flat), None

    def tcritic(x):
        flat = x.reshape(x.shape[0], -1)
        return (flat ** 2) @ _t(wj) + torch.mean(flat), None

    want = jlosses.gradient_penalty(jcritic, jnp.asarray(real),
                                    jnp.asarray(fake), key)
    u = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))
    np.testing.assert_allclose(
        tlosses.interpolate(_t(real), _t(fake), _t(u)).numpy(),
        np.asarray(jlosses.interpolate(jnp.asarray(real), jnp.asarray(fake),
                                       key)), rtol=1e-6)
    got = tlosses.gradient_penalty(tcritic, _t(real), _t(fake), _t(u))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_gradient_penalty_is_second_order():
    w = torch.ones(4, 1, requires_grad=True)
    real, fake = _t(_x((3, 2, 2, 1), 7)), _t(_x((3, 2, 2, 1), 8))
    gp = tlosses.gradient_penalty(
        lambda x: ((x.reshape(3, -1) ** 2) @ w, None), real, fake,
        torch.rand((3, 1, 1, 1), generator=torch.Generator().manual_seed(0)))
    g, = torch.autograd.grad(gp, w)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_adam_matches_optax_with_a_stage_that_activates():
    cfg = Config()
    t = cfg.train
    p1, p2 = _x((5, 3), 9), _x((4,), 10)
    grads = [(_x((5, 3), 20 + i), _x((4,), 30 + i)) for i in range(3)]
    active = [False, False, True]     # p2's stage starts at update 3

    opt = optax.adam(t.learning_rate, b1=t.adam_beta1, b2=t.adam_beta2,
                     eps=t.adam_eps)
    jp = {"a": jnp.asarray(p1), "b": jnp.asarray(p2)}
    jstate = opt.init(jp)
    tp = [torch.nn.Parameter(_t(p1)), torch.nn.Parameter(_t(p2))]
    topt = make_optimizer(cfg, tp)
    assert isinstance(topt, Adam)
    for (g1, g2), on in zip(grads, active):
        jg = {"a": jnp.asarray(g1),
              "b": jnp.asarray(g2 if on else np.zeros_like(g2))}
        upd, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp[0].grad = _t(g1)
        tp[1].grad = _t(g2) if on else None
        topt.step()
        np.testing.assert_allclose(tp[0].detach().numpy(),
                                   np.asarray(jp["a"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tp[1].detach().numpy(),
                                   np.asarray(jp["b"]), rtol=1e-6, atol=1e-9)
    assert topt.count == 3
    # the first active update moves p2 by optax's count-3 step, not by
    # a fresh count-1 step
    assert not np.allclose(tp[1].detach().numpy(), p2)


def test_ema_update_matches_reference():
    tree = {"w": _x((3, 4), 12), "b": _x((4,), 13)}
    new = {"w": _x((3, 4), 14), "b": _x((4,), 15)}
    want = j_ema({k: jnp.asarray(v) for k, v in tree.items()},
                 {k: jnp.asarray(v) for k, v in new.items()}, 0.999)
    ema, model = torch.nn.ParameterDict(), torch.nn.ParameterDict()
    for k in tree:
        ema[k] = torch.nn.Parameter(_t(tree[k]), requires_grad=False)
        model[k] = torch.nn.Parameter(_t(new[k]))
    ema_update(ema, model, 0.999)
    for k in tree:
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=0)


def _flagship_steps():
    cfg = run_config(FLAGSHIP)
    steps = [0, 1, 208000, 415000, 10**9]
    for _, start, end in tsched.schedule_from_config(cfg).stage_boundaries():
        steps += [start, start + 1, end - 1, end, (start + end) // 2]
    return sorted(set(steps))


@pytest.mark.parametrize("step", _flagship_steps())
def test_stage_and_alpha_at_flagship_boundaries(step):
    with open(os.path.join(FLAGSHIP, "train_config.json")) as f:
        jcfg = JConfig().with_overrides(json.load(f))
    tcfg = run_config(FLAGSHIP)
    want = jsched.schedule_from_config(jcfg).stage_and_alpha(step)
    got = tsched.schedule_from_config(tcfg).stage_and_alpha(step)
    assert got == want
    if step == 415000:
        assert got == (6, 1.0)
