"""``ModelConfig.remat``: the port rematerialises its trunk blocks as the
reference wraps them in ``nn.remat`` (``gansynth_tpu/models/
generator.py:96``, ``models/discriminator.py:139``), with non-reentrant
``torch.utils.checkpoint`` (``models.layers.remat_call``).

- In float32 on the CPU, the generator's and the critic's outputs, their
  first-order gradients, the gradient penalty and the critic's
  second-order gradient through it equal ``remat=False``'s to the bit (the
  recompute runs the same kernels on the same inputs).
- One training step with ``remat=True`` matches the reference's
  ``remat=True`` step at ``test_torch_train_step.py``'s bars
  (``torch_step_parity.check``), and the state the port makes for a seed
  does not depend on ``remat``, as the reference's does not.
- The recompute runs inside ``kernels.recomputing``, where the kernels
  count their launches apart; the model's own forward does not.
- Without gradients (the samplers) the blocks run plainly.
"""

import pytest
import torch

from gansynth_tpu_torch import kernels
from gansynth_tpu_torch.models.discriminator import Discriminator
from gansynth_tpu_torch.models.generator import Generator
from gansynth_tpu_torch.train import losses
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.utils.config import Config, ModelConfig
from torch_step_parity import check, run_both

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SMALL = dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8)


def _pair(stage):
    """The same G and D with remat off and on, and one batch."""
    out = []
    for remat in (False, True):
        cfg = Config().with_overrides({"model": dict(remat=remat, **SMALL)})
        out.append(create_train_state(cfg, seed=0, device="cpu"))
    gen = torch.Generator().manual_seed(stage)
    z = torch.randn(4, 8, generator=gen)
    labels = torch.nn.functional.one_hot(torch.tensor([3, 9, 27, 60]),
                                         61).float()
    real = torch.randn((4, *out[0].g.config.stage_resolution(stage), 2),
                       generator=gen)
    u = torch.rand((4, 1, 1, 1), generator=gen)
    return out, z, labels, real, u


def _grads(loss, module):
    return torch.autograd.grad(loss, list(module.parameters()),
                               allow_unused=True)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("stage", [1, 3])
def test_generator_remat_equals_plain_to_the_bit(stage):
    states, z, labels, _, _ = _pair(stage)
    outs = []
    for st in states:
        image = st.g(z, labels, stage, 0.7)
        outs.append((image.detach(), _grads(image.square().mean(), st.g)))
    assert torch.equal(outs[0][0], outs[1][0])
    _equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("stage", [1, 3])
def test_critic_remat_equals_plain_through_the_gradient_penalty(stage):
    states, z, labels, real, u = _pair(stage)
    outs = []
    for st in states:
        fake = st.g(z, labels, stage, 0.7).detach()

        def critic(x, st=st):
            return st.d(x, stage, 0.7)

        c_real, logits = critic(real)
        gp = losses.gradient_penalty(critic, real, fake, u)
        first = _grads(c_real.mean() + logits.square().mean(), st.d)
        second = _grads(gp, st.d)   # through the penalty's double backward
        outs.append((c_real.detach(), gp.detach(), first, second))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    _equal(outs[0][2], outs[1][2])
    _equal(outs[0][3], outs[1][3])


def test_remat_step_matches_the_references(monkeypatch):
    overrides = {"model": dict(remat=True, **SMALL),
                 "train": dict(batch_size=4)}
    new, jm, ts, tm = run_both(monkeypatch, overrides, 1, 0.5)
    check(new, jm, ts, tm, Config().train.learning_rate)


def test_the_seeded_state_does_not_depend_on_remat():
    a, b = (create_train_state(
        Config().with_overrides({"model": dict(remat=r, **SMALL)}), seed=4,
        device="cpu") for r in (False, True))
    for net in ("g", "d", "ema"):
        for (k, x), y in zip(getattr(a, net).state_dict().items(),
                             getattr(b, net).state_dict().values()):
            assert torch.equal(x, y), (net, k)


def test_the_recompute_runs_inside_recomputing(monkeypatch):
    """Block 1's forward runs twice under remat, the second time (the
    backward's recompute) inside ``kernels.recomputing``: a kernel there
    counts its launch apart."""
    g = Generator(ModelConfig(remat=True, **SMALL))
    seen = []
    block = g.blocks[1]
    inner = block.forward
    monkeypatch.setattr(block, "forward", lambda x: (
        seen.append(kernels.is_recomputing()), inner(x))[1])
    z = torch.randn(2, 8)
    labels = torch.zeros(2, 61)
    g(z, labels, 1, 1.0).sum().backward()
    assert seen == [False, True]
    assert not kernels.is_recomputing()


def test_no_remat_without_gradients(monkeypatch):
    """The samplers run under ``inference_mode``: no checkpointing."""
    from gansynth_tpu_torch.models import layers

    calls = []
    monkeypatch.setattr(
        "gansynth_tpu_torch.models.generator.remat_call",
        lambda *a: calls.append(a) or layers.remat_call(*a))
    g = Generator(ModelConfig(remat=True, **SMALL))
    with torch.inference_mode():
        g(torch.randn(2, 8), torch.zeros(2, 61), 2, 1.0)
    assert calls == []
    g(torch.randn(2, 8), torch.zeros(2, 61), 2, 1.0)
    assert len(calls) == 3


@pytest.mark.parametrize("network", [Generator, Discriminator])
def test_remat_off_builds(network):
    assert not ModelConfig().remat
    network(ModelConfig(**SMALL))
