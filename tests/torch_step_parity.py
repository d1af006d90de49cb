"""Shared setup of the whole-step parity tests (``test_torch_train_step*.py``,
``test_torch_step_rng.py``): one state, one batch, one real image and one
noise draw in both packages, and the checks of metrics, gradients,
parameters and EMA that those files' docstrings state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.train import make_train_step as j_make_step
from gansynth_tpu.train.step import real_image_for_stage as j_real
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import create_train_state
from gansynth_tpu_torch.train.step import make_train_step
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import Config


def waves(batch):
    rng = np.random.default_rng(0)
    t = np.arange(64000) / 16000
    freqs = [220.0, 440.0, 880.0, 1760.0][:batch]
    w = np.stack([np.sin(2 * np.pi * f * t) for f in freqs])
    w = (w + 0.01 * rng.standard_normal(w.shape)).astype(np.float32)
    return w, np.array([45, 57, 69, 81][:batch], dtype=np.int32)


def configs(overrides):
    return JConfig().with_overrides(overrides), Config().with_overrides(
        overrides)


def run_both(monkeypatch, overrides, stage, alpha, inject=True):
    """One step in both packages from the reference's seed-0 state. With
    ``inject`` the port is handed the reference's z_d, u and z_g; without
    it the port draws them from its own state key, which must be the
    reference's."""
    jcfg, tcfg = configs(overrides)
    batch = jcfg.train.batch_for_stage(stage)
    wave, pitch = waves(batch)
    real = np.array(j_real(jnp.asarray(wave), stage, jcfg))
    monkeypatch.setattr(tstep, "real_image_for_stage",
                        lambda wave, s, c: torch.from_numpy(real))
    state = j_create(jcfg, seed=0)
    base = jax.random.fold_in(state.rng, state.step)
    k_zd, k_interp, k_zg = jax.random.split(base, 3)
    latent = jcfg.model.latent_dim
    noise = {
        "z_d": jax.random.normal(k_zd, (batch, latent), jnp.float32),
        "u": jax.random.uniform(k_interp, (batch, 1, 1, 1)),
        "z_g": jax.random.normal(k_zg, (batch, latent), jnp.float32),
    }

    ts = create_train_state(tcfg, seed=0, device="cpu")
    assert ts.rng == tuple(int(v) for v in jax.random.key_data(state.rng))
    ts.g.load_state_dict(from_jax_params(state.g_params))
    ts.d.load_state_dict(from_jax_params(state.d_params))
    ts.ema.load_state_dict(from_jax_params(state.ema_params))

    new, jm = jax.jit(j_make_step(jcfg, stage))(
        state, jnp.asarray(wave), jnp.asarray(pitch), jnp.float32(alpha))
    given = ({k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
             if inject else {})
    _, tm = make_train_step(tcfg, stage)(
        ts, torch.from_numpy(wave), torch.from_numpy(pitch), alpha, **given)
    return new, jm, ts, tm


def grads_from_adam(opt_state):
    """optax adam state -> its first moment, which after one step with
    b1 = 0 is the gradient."""
    return from_jax_params(opt_state[0].mu)


def check(new, jm, ts, tm, lr, floor_rel=1e-4, earlier=()):
    """Metrics, the last step's gradients, parameters and EMA of the port
    (``ts``, ``tm``) against the reference (``new``, ``jm``).

    For a superstep of K steps, ``earlier`` holds the reference's states
    after its first K - 1 steps. An element whose gradient sits at the
    noise floor at any of the K steps may then move by up to 2 lr at each
    of them, and the EMA, which takes (1 - decay) = 1e-3 of each step's
    parameter difference, may differ by K times the one-step bar."""
    steps = 1 + len(earlier)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for module, opt, j_params, j_opt, opt_name in (
            (ts.d, ts.d_opt, new.d_params, new.d_opt, "d_opt"),
            (ts.g, ts.g_opt, new.g_params, new.g_opt, "g_opt")):
        want_p = from_jax_params(j_params)
        want_g = grads_from_adam(j_opt)
        earlier_g = [grads_from_adam(getattr(s, opt_name)) for s in earlier]
        assert set(want_p) == {n for n, _ in module.named_parameters()}
        for name, p in module.named_parameters():
            g_ref = want_g[name].numpy()
            st = opt.state.get(p)
            g_got = (st["mu"].numpy() if st is not None
                     else np.zeros_like(g_ref))
            floor = floor_rel * max(float(np.abs(g_ref).max()), 1e-30)
            np.testing.assert_allclose(g_got, g_ref, rtol=1e-3, atol=floor,
                                       err_msg=f"grad {name}")
            diff = np.abs(p.detach().numpy() - want_p[name].numpy())
            noisy = np.abs(g_ref) <= floor
            for g in earlier_g:
                g = np.abs(g[name].numpy())
                noisy |= g <= floor_rel * max(float(g.max()), 1e-30)
            assert diff[~noisy].max(initial=0.0) <= 1e-6, name
            assert diff[noisy].max(initial=0.0) <= 2 * lr * steps + 1e-6, \
                name
    want_ema = from_jax_params(new.ema_params)
    for name, e in ts.ema.named_parameters():
        np.testing.assert_allclose(e.detach().numpy(),
                                   want_ema[name].numpy(), atol=1e-8 +
                                   2e-3 * lr * steps, err_msg=f"ema {name}")
