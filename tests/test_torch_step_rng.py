"""The training step's noise against the reference's key schedule.

The reference draws z_d, u and z_g from ``split(fold_in(state.rng,
state.step), 3)`` (``gansynth_tpu/train/step.py:76-77``,
``train/losses.py:27``), with ``state.rng`` the third key of
``split(key(seed), 3)`` (``train/state.py:46-47, 65``). The port's
``fold_in``, ``split`` and ``uniform`` must equal ``jax.random``'s bit for
bit (threefry, partitionable layout, as ``tests/conftest.py`` pins);
normal draws to 1e-6 (see ``test_torch_random.py``). A whole step with
drawn noise is then held to the reference's at the bars of
``test_torch_train_step.py``, and a run resumed from a saved state
replays the noise and the results of an unbroken one exactly. The
initial weights come from the same seed as the reference's (flax's
per-parameter keys, ``train/state.py:init_like_reference``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu_torch.data.fixtures import note_batch
from gansynth_tpu_torch.synth import random as R
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import create_train_state, train_key
from gansynth_tpu_torch.train.step import make_train_step, step_noise
from gansynth_tpu_torch.utils.config import Config
from torch_step_parity import check, run_both

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SEEDS = [0, 1, 42, 12345, 2 ** 31 - 1, 2 ** 32 - 1]
NARROW = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=16,
                        fmap_min=8),
          "train": dict(batch_size=4)}


def _data(key):
    return tuple(int(v) for v in jax.random.key_data(key))


def _jkey(seed):
    return jax.random.key(jnp.uint32(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 415000, 2 ** 31 - 1,
                                  2 ** 32 - 1])
def test_fold_in_bitwise(seed, data):
    want = _data(jax.random.fold_in(_jkey(seed), jnp.uint32(data)))
    assert R.fold_in(R.seed_to_key(seed), data) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bitwise(seed, num):
    want = [_data(k) for k in jax.random.split(_jkey(seed), num)]
    assert R.split(R.seed_to_key(seed), num) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (8, 1, 1, 1), (3, 5)])
def test_uniform_bitwise(seed, shape):
    key = jax.random.fold_in(_jkey(seed), 3)
    want = np.asarray(jax.random.uniform(key, shape))
    got = R.uniform(_data(key), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_train_key_is_the_reference_state_key(seed):
    _, _, krest = jax.random.split(jax.random.key(seed), 3)
    assert train_key(seed) == _data(krest)
    cfg = Config().with_overrides(NARROW)
    assert create_train_state(cfg, seed=seed, device="cpu").rng == \
        _data(krest)


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_seeded_weights_are_the_references(seed):
    """``create_train_state(config, seed)`` holds the reference's initial
    G, D and EMA (``g.init(kg, ...)``, ``d.init(kd, ...)``): each kernel
    is drawn from flax's key of its module path, biases are zero. The
    normals equal JAX's within 4 ulp (measured: 3; the port takes
    ``log1p`` in float64, XLA in float32), every other value to the bit."""
    from gansynth_tpu.train import create_train_state as j_create
    from gansynth_tpu.utils.config import Config as JConfig
    from gansynth_tpu_torch.utils.checkpoint import to_jax_params

    want = j_create(JConfig().with_overrides(NARROW), seed=seed)
    got = create_train_state(Config().with_overrides(NARROW), seed=seed,
                             device="cpu")
    for net, params in (("g", want.g_params), ("d", want.d_params),
                        ("ema", want.ema_params)):
        flat = {"".join(f"['{k.key}']" for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
        mine = to_jax_params(dict(getattr(got, net).named_parameters()))
        assert sorted(mine) == sorted(flat)
        for k, w in flat.items():
            ulp = np.spacing(np.abs(w).astype(np.float32))
            assert np.all(np.abs(mine[k] - w) <= 4 * ulp), (net, k)
            if k.endswith("['bias']"):
                assert not mine[k].any()


@pytest.mark.parametrize("step", [0, 1, 2, 415000])
def test_step_noise_is_the_reference_draw(step):
    rng = jax.random.split(jax.random.key(0), 3)[2]
    k_zd, k_interp, k_zg = jax.random.split(jax.random.fold_in(rng, step), 3)
    got = step_noise(_data(rng), step, 4, 16)
    np.testing.assert_allclose(
        got["z_d"], np.asarray(jax.random.normal(k_zd, (4, 16))), rtol=0,
        atol=1e-6)
    np.testing.assert_array_equal(
        got["u"], np.asarray(jax.random.uniform(k_interp, (4, 1, 1, 1))))
    np.testing.assert_allclose(
        got["z_g"], np.asarray(jax.random.normal(k_zg, (4, 16))), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 0.5)])
def test_step_with_drawn_noise_matches_reference(monkeypatch, stage, alpha):
    """No noise injected: the port draws from its own key and step."""
    new, jm, ts, tm = run_both(monkeypatch, NARROW, stage, alpha,
                               inject=False)
    assert ts.step == 1
    check(new, jm, ts, tm, Config().train.learning_rate)


def test_resume_replays_the_noise(monkeypatch):
    """Steps 1 and 2 from a state saved after step 1 draw the noise of
    steps 1 and 2 of an unbroken run and give the same results."""
    cfg = Config().with_overrides(NARROW)
    waves, pitches = note_batch(4)
    waves, pitches = torch.from_numpy(waves), torch.from_numpy(pitches)
    step_fn = make_train_step(cfg, 1)
    drawn = []

    def recording(rng, step, batch, latent_dim):
        drawn.append((step, rng))
        return step_noise(rng, step, batch, latent_dim)

    monkeypatch.setattr(tstep, "step_noise", recording)

    def run(state, n):
        out = []
        for _ in range(n):
            _, m = step_fn(state, waves, pitches, 0.7)
            out.append({k: float(v) for k, v in m.items()})
        return out

    state = create_train_state(cfg, seed=3, device="cpu")
    run(state, 1)
    saved = copy.deepcopy(state)
    unbroken = run(state, 2)
    drawn_unbroken = drawn[1:]
    del drawn[:]
    resumed = run(saved, 2)
    assert drawn == drawn_unbroken == [(1, train_key(3)), (2, train_key(3))]
    assert resumed == unbroken
    for a, b in zip(saved.d.parameters(), state.d.parameters()):
        assert torch.equal(a, b)


def test_adam_count_survives_copy_and_state_dict():
    """Resume needs Adam's shared step count: ``torch.optim.Optimizer``
    drops attributes of its own on copy and in ``state_dict``."""
    from gansynth_tpu_torch.train.state import Adam

    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    opt.step()
    assert copy.deepcopy(opt).count == 2
    other = Adam([torch.nn.Parameter(torch.ones(3))], lr=0.1)
    other.load_state_dict(opt.state_dict())
    assert other.count == 2
    assert torch.equal(other.state_dict()["state"][0]["mu"],
                       opt.state_dict()["state"][0]["mu"])
