"""The port's checkpoints and EMA export (``utils/checkpoint.py``).

- ``to_jax_params`` inverts ``from_jax_params`` on the reference's
  generator and critic, key for key and bit for bit.
- ``save_ema_npz`` writes what the reference's ``load_ema_npz(path,
  template)`` loads with no missing key and no shape mismatch, with
  ``__step__`` and ``__stage__``, and the optional float16 cast.
- ``Checkpointer`` round-trips the whole state (three networks, both
  Adams with their shared ``count``, the key and the step) into a fresh
  state, so the next step is the same to the bit; it keeps the newest
  three digit-named directories and lists nothing half-written.
"""

import copy
import os

import numpy as np
import pytest
import torch

from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.utils.checkpoint import load_ema_npz as j_load_ema_npz
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.data.fixtures import note_batch
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.train.step import make_train_step
from gansynth_tpu_torch.utils.checkpoint import (
    Checkpointer,
    _flatten,
    from_jax_params,
    load_ema_generator,
    save_ema_npz,
    to_jax_params,
)
from gansynth_tpu_torch.utils.config import Config
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NARROW = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=32,
                        fmap_min=8),
          "train": dict(batch_size=2)}


@pytest.fixture(scope="module")
def jstate():
    return j_create(JConfig().with_overrides(NARROW), seed=3)


@pytest.mark.parametrize("net", ["g_params", "d_params"])
def test_to_jax_params_inverts_from_jax_params(jstate, net):
    want = _flatten(getattr(jstate, net))
    got = to_jax_params(from_jax_params(getattr(jstate, net)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_ema_npz_loads_in_the_reference(jstate, tmp_path, dtype):
    tcfg = Config().with_overrides(NARROW)
    ts = create_train_state(tcfg, seed=0, device="cpu")
    ts.ema.load_state_dict(from_jax_params(jstate.ema_params))
    path = save_ema_npz(str(tmp_path / "ema.npz"), ts.ema, 1234, stage=2,
                        dtype=dtype)
    assert os.listdir(tmp_path) == ["ema.npz"]   # no temporary left over
    params, step, stage = j_load_ema_npz(path, jstate.ema_params)
    assert (step, stage) == (1234, 2)
    want, got = _flatten(jstate.ema_params), _flatten(params)
    assert got.keys() == want.keys()
    for k in want:
        cast = want[k] if dtype is None else want[k].astype(dtype)
        np.testing.assert_array_equal(got[k], cast.astype(np.float32),
                                      err_msg=k)
    # and the port's own loader (what `cli serve` uses) reads it back
    g, step, stage = load_ema_generator(path, tcfg.model, "cpu")
    assert (step, stage) == (1234, 2)
    for name, p in g.named_parameters():
        want_p = dict(ts.ema.named_parameters())[name].detach()
        if dtype is not None:
            want_p = want_p.half().float()
        assert torch.equal(p.detach(), want_p), name


def _step(state, cfg, stage=1):
    waves, pitches = note_batch(2)
    return make_train_step(cfg, stage)(state, torch.from_numpy(waves),
                                       torch.from_numpy(pitches), 0.5)[1]


def test_checkpointer_round_trip_resumes_bitwise(tmp_path):
    cfg = Config().with_overrides(NARROW)
    state = create_train_state(cfg, seed=1, device="cpu")
    for _ in range(2):
        _step(state, cfg)
    assert state.g_opt.count == state.d_opt.count == 2
    ckpt = Checkpointer(str(tmp_path / "checkpoints"))
    ckpt.save(2, state)
    assert ckpt.latest_step() == 2
    assert os.listdir(tmp_path / "checkpoints") == ["2"]

    fresh = create_train_state(cfg, seed=9, device="cpu")
    restored, step = ckpt.restore(fresh)
    assert restored is fresh and step == 2
    assert (fresh.step, fresh.rng) == (state.step, state.rng)
    assert fresh.g_opt.count == fresh.d_opt.count == 2
    m_a, m_b = _step(state, cfg), _step(fresh, cfg)
    for k in m_a:
        assert float(m_a[k]) == float(m_b[k]), k
    for name in ("g", "d", "ema"):
        a, b = getattr(state, name), getattr(fresh, name)
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), f"{name}.{n}"


def test_checkpointer_keeps_three_and_lists_only_whole_saves(tmp_path):
    cfg = Config().with_overrides(NARROW)
    state = create_train_state(cfg, seed=1, device="cpu")
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    os.makedirs(tmp_path / ".tmp-99-1")   # an interrupted save
    for step in (10, 20, 30, 40):
        state.step = step
        ckpt.save(step, state)
    assert ckpt.steps() == [20, 30, 40]
    assert sorted(p for p in os.listdir(tmp_path) if p.isdigit()) == \
        ["20", "30", "40"]
    state.step = 40
    ckpt.save(40, copy.deepcopy(state))   # the same step saved again
    assert ckpt.steps() == [20, 30, 40]
    fresh = create_train_state(cfg, seed=2, device="cpu")
    assert ckpt.restore(fresh, step=30)[1] == 30 and fresh.step == 30
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(fresh)
