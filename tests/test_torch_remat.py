"""``ModelConfig.remat`` is refused by the port, not ignored.

The reference wraps its blocks in ``nn.remat`` when it is set
(``gansynth_tpu/models/generator.py:96``,
``models/discriminator.py:139``): the values stay the same and memory
drops. The port does not rematerialise yet, so it raises at the
construction of either network, naming the option.
"""

import pytest

from gansynth_tpu_torch.models.discriminator import Discriminator
from gansynth_tpu_torch.models.generator import Generator
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.utils.config import Config, ModelConfig

SMALL = dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8)


@pytest.mark.parametrize("network", [Generator, Discriminator])
def test_remat_raises(network):
    with pytest.raises(ValueError, match="remat"):
        network(ModelConfig(remat=True, **SMALL))


def test_remat_raises_in_the_train_state():
    cfg = Config().with_overrides({"model": dict(remat=True, **SMALL)})
    with pytest.raises(ValueError, match="remat"):
        create_train_state(cfg, device="cpu")


@pytest.mark.parametrize("network", [Generator, Discriminator])
def test_remat_off_builds(network):
    assert not ModelConfig().remat
    network(ModelConfig(**SMALL))
