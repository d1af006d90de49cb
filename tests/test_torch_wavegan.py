"""WaveGAN in the port (``models/wavegan.py``, ``model.architecture =
"wavegan"``, ``train.critic_updates``) against its plain float32
reference (``wavegan_reference.py``, equal in text to the benchmark's
``portbench/reference/wavegan.py``), on the CPU at width d = 2, the full
65536 samples, batch 2 (``TINY``): the pieces (the "SAME" conv and its
transpose against explicit pad-and-crop, phase shuffle at every shift
against a pure-index version, its second-order gradient), both networks'
forwards, the penalty's gradient through phase shuffle, the noise
contract and three whole steps of the cached superstep (losses, the
first gradients, the parameters' change). Then ``cli train`` trains,
checkpoints and resumes a WaveGAN run, and the spectral commands refuse
one.

Tolerances. Port and reference compute the same float32 function in
another order (cuDNN-free CPU convs over [B, C, 1, L] against ``conv1d``
over [B, C, L], a gather against reflect padding): forwards agree to a
few float32 ulps, so ``rtol`` 1e-5 with an ``atol`` of 1e-6 of the
output's scale. Gradients pass through the penalty's double backward,
whose sums of 65536 terms round differently: 1e-4 of each leaf's norm.
After three steps Adam's update is ``lr * m / (sqrt(v) + eps)``, which
turns a gradient element near zero into a full step of either sign, so
the changes are held by the median leaf's relative gap (1e-3) and every
leaf at 5e-2, not element by element."""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import wavegan_reference as ref
from gansynth_tpu_torch import cli
from gansynth_tpu_torch.models import wavegan as wg
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import TrainState, make_optimizer
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import Config
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": {"architecture": "wavegan", "wavegan_dim": 2,
                  "latent_dim": 100, "compute_dtype": "float32"},
        "train": {"critic_updates": 5, "batch_size": 2,
                  "learning_rate": 1e-4, "adam_beta1": 0.5,
                  "adam_beta2": 0.9, "drift_weight": 0.0, "unroll": 2,
                  "stable_steps": 1000, "checkpoint_every": 2,
                  "log_every": 1}}
CFG = Config().with_overrides(TINY)
MODEL = {**TINY["model"], **{k: getattr(CFG.model, k) for k in (
    "num_pitches", "pitch_min", "leaky_relu_slope")}}
TRAIN = {k: getattr(CFG.train, k) for k in (
    "critic_updates", "batch_size", "learning_rate", "adam_beta1",
    "adam_beta2", "adam_eps", "gp_weight", "drift_weight",
    "aux_pitch_weight", "ema_decay")}
NOTES = 16


def _params(seed=3):
    return ref.draw_params(MODEL, seed, torch.device("cpu"))


def _load(module, params):
    module.load_state_dict(from_jax_params(
        {"".join(f"['{p}']" for p in ["params", *k.split("/")]): v.numpy()
         for k, v in params.items()}))
    return module


def _notes():
    rng = np.random.default_rng(7)
    waves = 0.5 * np.sin(np.linspace(0, 900, 64000))[None] * \
        rng.uniform(0.2, 1.0, (NOTES, 1)) + 0.01 * rng.standard_normal(
            (NOTES, 64000))
    return (torch.from_numpy(waves.astype(np.float32)),
            torch.from_numpy(rng.integers(24, 85, NOTES).astype(np.int32)))


def _port_layout(t):
    """A reference (TF-layout) tensor in the port's layout: its axes
    reversed."""
    return t.permute(*range(t.ndim - 1, -1, -1))


def _close(got, want, rtol=1e-5):
    scale = float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6 * scale)


def test_the_reference_is_the_benchmarks_copy():
    with open(os.path.join(ROOT, "tests", "wavegan_reference.py")) as f:
        mine = f.read()
    with open(os.path.join(ROOT, "portbench", "reference",
                           "wavegan.py")) as f:
        assert f.read() == mine


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    with open(os.path.join(ROOT, "tests", "wavegan_reference.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch", "torch.nn.functional", "portbench.reference"}


def _explicit_same_conv(x, w, b, s):
    """[B, C, L] -> the strided conv of x padded 10 left, 11 right."""
    xp = torch.cat([x.new_zeros(*x.shape[:2], 10), x,
                    x.new_zeros(*x.shape[:2], 11)], -1)
    return F.conv1d(xp, w, b, stride=s)


@pytest.mark.parametrize("length", [16, 64])
def test_same_conv_and_its_transpose_pad_and_crop_as_tf(length):
    torch.manual_seed(0)
    x = torch.randn(2, 3, 4 * length, dtype=torch.float64)
    w = torch.randn(5, 3, 25, dtype=torch.float64)
    b = torch.randn(5, dtype=torch.float64)
    to_cl = lambda t: t[:, :, None].contiguous(  # noqa: E731
        memory_format=torch.channels_last)
    got = wg.same_conv(to_cl(x), w, b, 4)[:, :, 0]
    torch.testing.assert_close(got, _explicit_same_conv(x, w, b, 4))
    assert got.shape[-1] == length
    # the transpose is the conv's gradient: the full output, cropped
    y = torch.randn(2, 5, length, dtype=torch.float64)
    full = F.conv_transpose1d(y, w, stride=4)
    assert full.shape[-1] == 4 * length + 21
    got_t = wg.same_conv_transpose(to_cl(y), w, None, 4)[:, :, 0]
    torch.testing.assert_close(got_t, full[..., 10:10 + 4 * length])
    # <conv(x), y> == <x, convT(y)>: the adjoint of the SAME conv
    lhs = (_explicit_same_conv(x, w, None, 4) * y).sum()
    rhs = (x * got_t).sum()
    torch.testing.assert_close(lhs, rhs)


def _reflect_index(n, s):
    out = []
    for t in range(n):
        i = t - s
        out.append(-i if i < 0 else 2 * (n - 1) - i if i > n - 1 else i)
    return out


@pytest.mark.parametrize("shift", [-2, -1, 0, 1, 2])
def test_phase_shuffle_at_every_shift(shift):
    torch.manual_seed(1)
    x = torch.randn(2, 3, 1, 9).contiguous(memory_format=torch.channels_last)
    got = wg.phase_shuffle(x, torch.tensor(shift))
    want = x[..., _reflect_index(9, shift)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        got[:, :, 0], ref.phase_shuffle(x[:, :, 0], shift), rtol=0, atol=0)


def test_phase_shuffle_second_order_gradient():
    x = torch.randn(2, 3, 1, 7, dtype=torch.float64).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    for s in (-2, 1):
        f = lambda t: wg.phase_shuffle(t, torch.tensor(s)) ** 3  # noqa
        assert torch.autograd.gradcheck(f, (x,))
        assert torch.autograd.gradgradcheck(f, (x,))


def _nets(seed=3):
    g0, d0 = _params(seed)
    g = _load(wg.WaveGANGenerator(CFG.model), g0)
    d = _load(wg.WaveGANDiscriminator(CFG.model), d0)
    return g, d, g0, d0


def test_generator_and_critic_forwards_are_the_references():
    g, d, g0, d0 = _nets()
    torch.manual_seed(2)
    z = torch.rand(2, 100) * 2 - 1
    labels = ref.onehot(torch.tensor([30, 70]), MODEL)
    with torch.no_grad():
        wave = g(z, labels)
        assert wave.shape == (2, 65536)
        _close(wave, ref.generator(g0, z, labels, MODEL))
        shifts = [2, -1, 0, -2]
        got = d(wave, torch.tensor(shifts))
        want = ref.critic(d0, wave, shifts, MODEL)
    for a, b in zip(got, want):
        _close(a, b)


def test_the_penalty_gradient_through_phase_shuffle_is_the_references():
    """The critic's parameters' gradient of the WGAN-GP penalty, whose
    second order runs back through every shuffle's gather."""
    g, d, g0, d0 = _nets()
    torch.manual_seed(4)
    x = (0.3 * torch.randn(2, 65536)).requires_grad_()
    shifts = [-2, 1, 2, -1]
    gx, = torch.autograd.grad(d(x, torch.tensor(shifts))[0].sum(), x,
                              create_graph=True)
    got = torch.autograd.grad(((gx.norm(dim=1) - 1) ** 2).mean(),
                              list(d.parameters()), allow_unused=True)
    d0 = {k: v.clone().requires_grad_() for k, v in d0.items()}
    xr = x.detach().clone().requires_grad_()
    gr, = torch.autograd.grad(ref.critic(d0, xr, shifts, MODEL)[0].sum(),
                              xr, create_graph=True)
    want = torch.autograd.grad(((gr.norm(dim=1) - 1) ** 2).mean(),
                               list(d0.values()), allow_unused=True)
    names = [n for n, _ in d.named_parameters()]
    assert [a is None for a in got] == [b is None for b in want]
    # the pitch head and the score bias do not reach the input gradient
    assert sum(a is None for a in got) == 3
    for name, a, (key, b) in zip(names, got, zip(d0, want)):
        if b is None:
            continue
        b = _port_layout(b)
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()), (name, key)


@pytest.mark.parametrize("step", [0, 9])
def test_the_noise_contract_is_the_references(step):
    key = ref.train_key(5)
    got = wg.wavegan_noise(key, step, 3, 100, 5)
    z_d, u, sh_d, z_g, sh_g = ref.step_noise(key, step, 3, 100, 5)
    np.testing.assert_array_equal(got["z_d"], np.stack(z_d))
    np.testing.assert_array_equal(got["u"], np.stack(u))
    np.testing.assert_array_equal(got["shifts_d"], np.stack(sh_d))
    np.testing.assert_array_equal(got["z_g"], z_g)
    np.testing.assert_array_equal(got["shifts_g"], sh_g)
    assert got["z_d"].min() >= -1 and got["z_d"].max() < 1
    assert set(np.unique(got["shifts_d"])) <= {-2, -1, 0, 1, 2}
    for j in range(5):
        np.testing.assert_array_equal(
            tstep.cached_batch_indices(key, step * 5 + j, 3, NOTES),
            ref.batch_indices(key, step * 5 + j, 3, NOTES))


def test_staged_rows_read_back_on_the_device():
    g, d, _, _ = _nets()
    state = TrainState(g=g, d=d, ema=g, g_opt=make_optimizer(
        CFG, g.parameters()), d_opt=make_optimizer(CFG, d.parameters()),
        rng=ref.train_key(5), step=4)
    state.d_opt.count, state.g_opt.count = 20, 4
    idx = [[np.arange(2) + i * 10 + j for j in range(5)] for i in range(2)]
    rows = tstep._stage_wavegan_rows(state, [1.0, 1.0], CFG, idx)
    r = tstep._Rows(torch.device("cpu"), 2, 100, 2, 1, 2, 5, 64)
    r.load(rows)
    for i in range(2):
        row = r.read()
        want = wg.wavegan_noise(state.rng, 4 + i, 2, 100, 5)
        np.testing.assert_array_equal(row.z_d.numpy(), want["z_d"])
        np.testing.assert_array_equal(row.shifts_d.numpy(),
                                      want["shifts_d"])
        np.testing.assert_array_equal(row.shifts_g.numpy(),
                                      want["shifts_g"])
        np.testing.assert_array_equal(row.idx.numpy(), np.stack(idx[i]))
        assert float(row.bc_d[4][0]) == float(
            1 - np.float32(0.5) ** (20 + 5 * i + 5))
        assert float(row.bc_g[1]) == float(1 - np.float32(0.9) ** (5 + i))
        r.write(torch.zeros(1))


def _program_steps(steps, seed=3):
    g, d, g0, d0 = _nets(seed)
    ema = _load(wg.WaveGANGenerator(CFG.model), g0).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
    state = TrainState(g=g, d=d, ema=ema,
                       g_opt=make_optimizer(CFG, g.parameters()),
                       d_opt=make_optimizer(CFG, d.parameters()),
                       rng=ref.train_key(seed))
    waves, pitches = _notes()
    superstep = tstep.make_cached_superstep(CFG, 0, NOTES)
    first = {}   # the critic's gradients of step 1's first critic update

    def keep(name):
        def hook(grad):   # returns None: the gradient goes on unchanged
            first.setdefault(name, grad.clone())
        return hook

    for name, p in d.named_parameters():
        p.register_hook(keep(name))
    out = {"d_loss": [], "g_loss": []}
    for i in range(steps):
        state, m = superstep(state, waves, pitches, [1.0])
        out["d_loss"].append(float(m["d_loss"]))
        out["g_loss"].append(float(m["g_loss"]))
        if i == 0:   # G's as the step left it
            out["grad_d"] = dict(first)
            out["grad_g"] = {n: p.grad.clone() for n, p in
                             state.g.named_parameters()}
    out["state"] = state
    out["phases"] = superstep.program.phases.read()
    return out, g0, d0, waves, pitches


def _port_name(key):
    name, leaf = key.split("/")
    return f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"


def test_three_steps_are_the_references():
    prog, g0, d0, waves, pitches = _program_steps(3)
    want = ref.run_steps({"model": MODEL, "train": TRAIN}, g0, d0, waves,
                         pitches, ref.train_key(3), 0, 3)
    for a, b in zip(prog["d_loss"] + prog["g_loss"],
                    want["d_loss"] + want["g_loss"]):
        assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (a, b)
    for net in ("d", "g"):
        for key, b in want["grads_" + net].items():
            a = prog["grad_" + net][_port_name(key)]
            b = _port_layout(b)
            assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12, \
                key
    state = prog["state"]
    gaps = []
    for net, after, before in (("g", want["g"], g0), ("d", want["d"], d0),
                               ("ema", want["ema"], g0)):
        module = getattr(state, net)
        mine = dict(module.named_parameters())
        for key in after:
            r = ref.changes(after, before)[key]
            r = _port_layout(r)
            p = mine[_port_name(key)].detach() - _port_layout(before[key])
            gap = float((p - r).norm()) / max(float(r.norm()), 1e-30)
            assert gap <= 5e-2, (net, key, gap)
            gaps.append(gap)
    assert float(np.median(gaps)) <= 1e-3
    assert prog["phases"]["steps"] == 3
    assert prog["phases"]["critic_updates"] == 15
    assert state.d_opt.count == 15 and state.g_opt.count == 3


def test_the_uncached_steps_refuse_wavegan():
    for make in (tstep.make_train_step, tstep.make_superstep):
        with pytest.raises(ValueError, match="device cache"):
            make(CFG, 0)
    with pytest.raises(ValueError, match="critic_updates"):
        tstep.make_cached_superstep(Config().with_overrides(
            {"train": {"critic_updates": 5}}), 6, 16)


@pytest.fixture(scope="module")
def wavegan_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("wavegan")
    config = base / "wavegan.json"
    config.write_text(json.dumps(
        {**TINY, "train": {**TINY["train"], "sample_every": 3,
                           "sample_pitches": [60]}}))
    run = str(base / "run")
    argv = ["train", "--model-dir", run, "--synthetic", "--device-cache",
            "--device", "cpu", "--config", str(config)]
    assert cli.main([*argv, "--num-steps", "3"]) == 0
    return run, argv


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_checkpoints_resumes_and_exports(wavegan_run, tmp_path):
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.utils.checkpoint import Checkpointer

    run, argv = wavegan_run
    ckpt = os.path.join(run, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["2", "3"]
    assert os.path.exists(os.path.join(run, "samples",
                                       "step00000003_pitch60.wav"))
    with open(os.path.join(run, "train_config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["architecture"] == "wavegan"
    assert saved["train"]["critic_updates"] == 5
    rows = _metrics(run)
    assert [r["step"] for r in rows] == [2, 3]
    assert all(math.isfinite(r["d_loss"]) for r in rows)
    state, step = Checkpointer(ckpt).restore(
        create_train_state(CFG, seed=11, device="cpu"))
    assert step == 3 and state.step == 3
    assert state.d_opt.count == 15 and state.g_opt.count == 3
    fresh = create_train_state(CFG, device="cpu")
    moved = [float((a - b).detach().abs().max()) for a, b in
             zip(state.d.parameters(), fresh.d.parameters())]
    assert max(moved) > 0
    # a second call resumes at 3 and replays an unbroken run's noise
    assert cli.main([*argv, "--num-steps", "2"]) == 0
    assert [r["step"] for r in _metrics(run)] == [2, 3, 5]
    out = str(tmp_path / "ema.npz")
    assert cli.main(["export-ema", "--model-dir", run, "--device", "cpu",
                     "--output", out]) == 0
    with np.load(out) as z:
        assert int(z["__step__"]) == 5
        # TF's layout of a transposed conv: [k, out, in] (d = 2: 64 -> 32)
        assert z["['params']['upconv_0']['kernel']"].shape == (25, 32, 64)


@pytest.mark.parametrize("command", ["generate", "serve", "export-model",
                                     "evaluate", "interpolate"])
def test_the_spectral_commands_refuse_wavegan(command, wavegan_run, capsys,
                                              tmp_path):
    run, _ = wavegan_run
    extra = {"generate": ["--output-dir", str(tmp_path)],
             "interpolate": ["--output-dir", str(tmp_path)]}.get(command, [])
    capsys.readouterr()
    assert cli.main([command, "--model-dir", run, "--device", "cpu",
                     *extra]) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "'wavegan'" in err[0] and command in err[0]
