"""The port's superstep and cached data stream against the reference
(``gansynth_tpu/train/step.py:202-341``).

- ``permutation`` and ``randint`` equal ``jax.random``'s bit for bit
  (JAX's ``_shuffle``: two sort rounds at N = 256 and 2048, none at N = 1;
  ``_randint``: two words per value), so ``cached_batch_indices`` gives the
  reference's indices under both laws, across epoch boundaries.
- ``make_superstep`` with K = 4 equals 4 single steps of the port to the
  bit (the same noise, from ``(state.rng, state.step)``).
- The port's ``make_superstep`` and ``make_cached_superstep`` against the
  reference's, from one state, with the reference's real image handed to
  the port (the two frontends differ in the phase of near-silent bins, as
  in ``torch_step_parity.py``), checked by that file's ``check``:
  metrics at ``rtol=1e-4, atol=1e-5``; the last step's gradients (Adam's
  ``mu``, b1 = 0) at ``rtol=1e-3`` above the noise floor; a parameter
  within 1e-6, unless its reference gradient sits at the noise floor at
  one of the K steps (read from the reference's state after each step),
  when Adam may push it by up to 2 lr a step; the EMA within K times the
  one-step bar, since each step adds 1e-3 of that step's difference.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.train.step import cached_batch_indices as j_indices
from gansynth_tpu.train.step import make_cached_superstep as j_cached
from gansynth_tpu.train.step import make_superstep as j_superstep
from gansynth_tpu.train.step import real_image_for_stage as j_real
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.data.fixtures import note_batch
from gansynth_tpu_torch.synth import random as R
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import Config
from torch_step_parity import check
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SEEDS = [0, 42, 2 ** 31 - 1]
SIZES = [1, 7, 256, 2048]
NARROW = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=16,
                        fmap_min=8),
          "train": dict(batch_size=2)}
STAGE = 1


def _key_data(key):
    return tuple(int(v) for v in jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_permutation_bitwise(seed, n):
    key = jax.random.key(seed)
    want = np.asarray(jax.random.permutation(key, n))
    got = R.permutation(_key_data(key), n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_randint_bitwise(seed, n):
    key = jax.random.key(seed)
    for shape, lo, hi in (((64,), 0, n), ((3, 5), 2, 2 + n), ((8,), 5, 5)):
        want = np.asarray(jax.random.randint(key, shape, lo, hi))
        got = R.randint(_key_data(key), shape, lo, hi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("law", ["shuffle", "replacement"])
@pytest.mark.parametrize("n,batch,steps", [
    (7, 3, range(0, 8)),          # a boundary in most batches
    (16, 2, range(6, 10)),        # the fixture dataset of the loop test
    (256, 8, range(30, 34)),      # boundary at step 32
    (2048, 8, range(254, 258)),   # the flagship's cache, boundary at 256
])
def test_cached_batch_indices_bitwise(law, n, batch, steps):
    rng = jax.random.fold_in(jax.random.key(3), 11)
    for step in steps:
        want = np.asarray(j_indices(rng, jnp.int32(step), batch, n, law))
        got = tstep.cached_batch_indices(_key_data(rng), step, batch, n, law)
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")


def test_shuffle_law_reads_each_example_once_per_epoch():
    rng, n, batch = (5, 9), 16, 2
    seen = np.concatenate([tstep.cached_batch_indices(rng, s, batch, n)
                           for s in range(n // batch)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(n))


def _port_state(tcfg):
    return create_train_state(tcfg, seed=0, device="cpu")


def _snapshot(state):
    tensors = {}
    for name in ("g", "d", "ema"):
        for k, v in getattr(state, name).state_dict().items():
            tensors[f"{name}.{k}"] = v.clone()
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                tensors[f"{name}.{i}.{k}"] = v.clone()
    return tensors, state.step, state.g_opt.count, state.d_opt.count


def test_superstep_equals_single_steps_bitwise():
    tcfg = Config().with_overrides(NARROW)
    waves, pitches = note_batch(8)
    waves = torch.from_numpy(waves).reshape(4, 2, -1)
    pitches = torch.from_numpy(pitches).reshape(4, 2)
    alphas = np.array([0.25, 0.5, 0.75, 1.0], np.float32)

    fused = _port_state(tcfg)
    single = copy.deepcopy(fused)
    _, m_fused = tstep.make_superstep(tcfg, STAGE)(fused, waves, pitches,
                                                   alphas)
    step_fn = tstep.make_train_step(tcfg, STAGE)
    m_single = [step_fn(single, w, p, float(a))[1]
                for w, p, a in zip(waves, pitches, alphas)]

    (a, step_a, ga, da), (b, step_b, gb, db) = (_snapshot(fused),
                                                _snapshot(single))
    assert (step_a, ga, da) == (step_b, gb, db) == (4, 4, 4)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in m_fused:
        want = 1.0 if k == "alpha" else float(
            torch.stack([m[k] for m in m_single]).mean())
        assert float(m_fused[k]) == want, k


@pytest.fixture
def parity(monkeypatch):
    """The reference's seed-0 state in both packages, and the port's
    frontend replaced by the reference's image of the same wave."""
    jcfg, tcfg = JConfig().with_overrides(NARROW), \
        Config().with_overrides(NARROW)
    real = jax.jit(lambda w: j_real(w, STAGE, jcfg))
    monkeypatch.setattr(
        tstep, "real_image_for_stage",
        lambda wave, s, c: torch.from_numpy(
            np.array(real(jnp.asarray(wave.numpy())))))
    jstate = j_create(jcfg, seed=0)
    ts = _port_state(tcfg)
    assert ts.rng == _key_data(jstate.rng)
    for name in ("g", "d", "ema"):
        getattr(ts, name).load_state_dict(
            from_jax_params(getattr(jstate, f"{name}_params")))
    return jcfg, tcfg, jstate, ts


def test_superstep_matches_reference(parity):
    jcfg, tcfg, jstate, ts = parity
    k = 2
    waves, pitches = note_batch(2 * k)
    waves = waves.reshape(k, 2, -1)
    pitches = pitches.reshape(k, 2).astype(np.int32)
    alphas = np.array([0.25, 0.5], np.float32)
    superstep = jax.jit(j_superstep(jcfg, STAGE))
    new, jm = superstep(jstate, jnp.asarray(waves), jnp.asarray(pitches),
                        jnp.asarray(alphas))
    first, _ = superstep(jstate, jnp.asarray(waves[:1]),
                         jnp.asarray(pitches[:1]), jnp.asarray(alphas[:1]))
    _, tm = tstep.make_superstep(tcfg, STAGE)(
        ts, torch.from_numpy(waves), torch.from_numpy(pitches), alphas)
    assert ts.step == int(new.step) == k
    check(new, jm, ts, tm, jcfg.train.learning_rate, earlier=[first])


def test_cached_superstep_matches_reference(parity):
    jcfg, tcfg, jstate, ts = parity
    k, n = 2, 5   # 5 examples, batch 2: the second step crosses an epoch
    waves, pitches = note_batch(n)
    pitches = pitches.astype(np.int32)
    alphas = np.array([0.5, 0.75], np.float32)
    jstate = jstate.replace(step=jnp.int32(2))
    ts.step = 2
    superstep = jax.jit(j_cached(jcfg, STAGE, n))
    new, jm = superstep(jstate, jnp.asarray(waves), jnp.asarray(pitches),
                        jnp.asarray(alphas))
    first, _ = superstep(jstate, jnp.asarray(waves), jnp.asarray(pitches),
                         jnp.asarray(alphas[:1]))
    _, tm = tstep.make_cached_superstep(tcfg, STAGE, n)(
        ts, torch.from_numpy(waves), torch.from_numpy(pitches), alphas)
    assert ts.step == int(new.step) == 2 + k
    check(new, jm, ts, tm, jcfg.train.learning_rate, earlier=[first])


def test_cached_superstep_refuses_a_batch_above_the_dataset():
    tcfg = Config().with_overrides(NARROW)
    with pytest.raises(ValueError, match="batch"):
        tstep.make_cached_superstep(tcfg, STAGE, 1)
    replacement = tcfg.with_overrides({"train": {"cached_stream":
                                                 "replacement"}})
    tstep.make_cached_superstep(replacement, STAGE, 1)
    with pytest.raises(ValueError, match="cached_stream"):
        tstep.make_cached_superstep(
            tcfg.with_overrides({"train": {"cached_stream": "other"}}),
            STAGE, 4)
