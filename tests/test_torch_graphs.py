"""The port's step and samplers in the form a CUDA graph holds them, on the
CPU (``gansynth_tpu_torch/utils/graphs.py``, ``train/step.py``).

- The step reads its alpha, its noise and both Adams' bias corrections
  from its staged row: one step at Adam count 5, alpha fading in, noise
  drawn from the state's key, against the reference's step, with the bars
  of ``torch_step_parity.check``.
- The staged rows of K steps are the host's draws to the bit:
  ``step_noise``, ``cached_batch_indices`` under both ``cached_stream``
  laws across epoch boundaries, the alphas and the bias corrections, as
  the step reads them back on the device row by row.
- ``Adam.update`` with its bias corrections as tensors against
  ``optax.adam`` over 5 steps (b1 = 0.9, a parameter that joins at step
  3), at the bars of ``test_torch_train_parts.py``'s Adam test; ``step``
  lands on the same bits.
- A checkpoint written at commit 8787f8c (``tests/data/
  torch_checkpoint_8787f8c``, made by ``make_torch_checkpoint_fixture.py``)
  restores, and two more steps land on the state that commit's code
  reached, to the bit.
- The launch-count bookkeeping of ``utils/graphs.py`` with the capture
  simulated: a capture's counts are taken back, each replay adds them, a
  failed capture raises with the counts restored.
- With the capture simulated (a replay reruns the captured function,
  ``torch_graph_sim.py``), the seeded sampler (one device, and a graph per
  data-parallel replica), the keyed, latent and data-parallel keyed
  samplers (wave and image), the roundtrip's two calls and the cached
  superstep run their graph path on the CPU: equal to the eager path to
  the bit, one capture per rung, replica or state, a sampler captures
  again when its generator's weights move, a failed capture raises and
  leaves the state as it was. Off a card ``graphs.on_device`` runs the
  function eagerly.
- The names by which ``utils/profiling.py`` counts the port's kernels in
  a trace (what ``chip_smoke.py`` holds the replays' counts to) are the
  device functions of ``kernels/csrc``, and match no other kernel.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gansynth_tpu.train import create_train_state as j_create
from gansynth_tpu.train import make_train_step as j_make_step
from gansynth_tpu.train.step import real_image_for_stage as j_real
from gansynth_tpu_torch.data.fixtures import note_batch
from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import launch_counts
from gansynth_tpu_torch.kernels import synthesis as K1
from gansynth_tpu_torch.models.generator import Generator
from gansynth_tpu_torch.serve import SynthesisService
from gansynth_tpu_torch.synth.sampler import (
    make_dp_seeded_sampler,
    make_seeded_sampler,
)
from gansynth_tpu_torch.train import step as tstep
from gansynth_tpu_torch.train.state import create_train_state, make_optimizer
from gansynth_tpu_torch.utils import graphs
from gansynth_tpu_torch.utils.checkpoint import Checkpointer, from_jax_params
from gansynth_tpu_torch.utils.config import Config
from make_torch_checkpoint_fixture import (
    CONFIG,
    EXAMPLES,
    LATER_ALPHAS,
    OUT,
    STAGE,
    state_arrays,
)
import torch_graph_sim
from torch_step_parity import check, configs, waves
from torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NARROW = CONFIG   # latent 8, fmap_base 64, fmap_max 16, batch 2


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _with_count(opt_state, count):
    """An optax adam state (``(ScaleByAdamState, ...)``) at ``count``."""
    return (opt_state[0]._replace(count=jnp.asarray(count, jnp.int32)),
            *opt_state[1:])


def test_step_from_its_staged_row_matches_the_reference(monkeypatch):
    stage, alpha, count = 1, 0.4, 5
    jcfg, tcfg = configs(NARROW)
    wave, pitch = waves(2)
    real = np.array(j_real(jnp.asarray(wave), stage, jcfg))
    monkeypatch.setattr(tstep, "real_image_for_stage",
                        lambda w, s, c: torch.from_numpy(real))
    jstate = jax.jit(lambda: j_create(jcfg, seed=0))()   # eager: ~2x slower
    jstate = jstate.replace(step=jnp.int32(count),
                            g_opt=_with_count(jstate.g_opt, count),
                            d_opt=_with_count(jstate.d_opt, count))
    ts = create_train_state(tcfg, seed=0, device="cpu")
    for name in ("g", "d", "ema"):
        getattr(ts, name).load_state_dict(
            from_jax_params(getattr(jstate, f"{name}_params")))
    ts.step = ts.g_opt.count = ts.d_opt.count = count

    new, jm = jax.jit(j_make_step(jcfg, stage))(
        jstate, jnp.asarray(wave), jnp.asarray(pitch), jnp.float32(alpha))
    _, tm = tstep.make_train_step(tcfg, stage)(
        ts, torch.from_numpy(wave), torch.from_numpy(pitch), alpha)
    assert (ts.step, ts.g_opt.count, ts.d_opt.count) == (count + 1,) * 3
    assert int(new.g_opt[0].count) == count + 1
    check(new, jm, ts, tm, jcfg.train.learning_rate)


@pytest.mark.parametrize("law", ["shuffle", "replacement"])
def test_staged_rows_are_the_host_draws(law):
    cfg = Config().with_overrides(NARROW)
    state = create_train_state(cfg, seed=3, device="cpu")
    state.step, state.d_opt.count, state.g_opt.count = 7, 7, 9
    # steps 7..10 read examples 14..21 of 5-example epochs: the batches
    # of steps 7 and 10 straddle epoch boundaries under "shuffle"
    n, batch, k, latent = EXAMPLES, 2, 4, cfg.model.latent_dim
    alphas = [0.125, 0.3, 0.7, 1.0]
    idx = [tstep.cached_batch_indices(state.rng, 7 + i, batch, n, law)
           for i in range(k)]
    if law == "shuffle":
        assert sorted(np.concatenate(idx[:3]).tolist()[1:]) == \
            sorted(range(n))   # positions 15..19: one whole epoch
    rows = tstep._stage_rows(state, alphas, batch, latent, indices=idx)
    r = tstep._Rows(torch.device("cpu"), batch, latent, k, 1, batch)
    r.load(rows)
    b1, b2 = cfg.train.adam_beta1, cfg.train.adam_beta2
    for i in range(k):
        z_d, u, z_g, alpha, bc_d, bc_g, got_idx = r.read()
        want = tstep.step_noise(state.rng, 7 + i, batch, latent)
        for got, name in ((z_d, "z_d"), (u, "u"), (z_g, "z_g")):
            assert got.shape == want[name].shape
            np.testing.assert_array_equal(_bits(got), _bits(want[name]))
        np.testing.assert_array_equal(got_idx.numpy(), idx[i])
        assert _bits(alpha) == _bits(alphas[i])
        for bc, count in ((bc_d, 8 + i), (bc_g, 10 + i)):
            want_bc = (1 - np.float32(b1) ** count,
                       1 - np.float32(b2) ** count)
            assert [float(v) for v in bc] == [float(v) for v in want_bc]
        r.write(torch.zeros(1))   # the step's metrics; advances pos
    assert int(r.pos) == k


def test_adam_update_from_tensor_bias_corrections_matches_optax():
    cfg = Config().with_overrides({"train": {"adam_beta1": 0.9}})
    t = cfg.train
    rng = np.random.default_rng(0)
    p1 = rng.standard_normal((5, 3)).astype(np.float32)
    p2 = rng.standard_normal(4).astype(np.float32)
    opt = optax.adam(t.learning_rate, b1=t.adam_beta1, b2=t.adam_beta2,
                     eps=t.adam_eps)
    jp = {"a": jnp.asarray(p1), "b": jnp.asarray(p2)}
    jstate = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p1.copy())),
          torch.nn.Parameter(torch.from_numpy(p2.copy()))]
    sp = [torch.nn.Parameter(torch.from_numpy(p1.copy())),
          torch.nn.Parameter(torch.from_numpy(p2.copy()))]
    topt, sopt = make_optimizer(cfg, tp), make_optimizer(cfg, sp)
    for step in range(1, 6):
        on = step >= 3   # p2 joins at the third update
        g1 = rng.standard_normal((5, 3)).astype(np.float32)
        g2 = rng.standard_normal(4).astype(np.float32)
        upd, jstate = opt.update(
            {"a": jnp.asarray(g1),
             "b": jnp.asarray(g2 if on else np.zeros_like(g2))}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for params in (tp, sp):
            params[0].grad = torch.from_numpy(g1)
            params[1].grad = torch.from_numpy(g2) if on else None
        topt.count += 1   # as the train step advances it
        topt.update(*(torch.tensor(v, dtype=torch.float32)
                      for v in topt.bias_corrections(topt.count)))
        sopt.step()
        for got, want in zip(tp, (jp["a"], jp["b"])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-9)
        for a, b in zip(tp, sp):
            assert torch.equal(a, b)
    assert topt.count == sopt.count == 5


def test_a_checkpoint_of_commit_8787f8c_restores_and_resumes(tmp_path):
    cfg = Config().with_overrides(CONFIG)
    ckpt = tmp_path / "checkpoints"
    shutil.copytree(os.path.join(OUT, "checkpoints"), ckpt)
    state = create_train_state(cfg, seed=0, device="cpu")
    state, step = Checkpointer(str(ckpt)).restore(state)
    assert (step, state.step, state.g_opt.count, state.d_opt.count) == \
        (2, 2, 2, 2)
    all_waves, pitches = note_batch(EXAMPLES)
    state, metrics = tstep.make_cached_superstep(cfg, STAGE, EXAMPLES)(
        state, torch.from_numpy(all_waves),
        torch.from_numpy(pitches.astype(np.int32)), list(LATER_ALPHAS))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with np.load(os.path.join(OUT, "after.npz")) as z:
        want = dict(z)
    got = state_arrays(state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _launch():
    """What the wrappers count for a small 'kernel program'."""
    K1.synthesis_spectrum.launches += 1
    K2.conv3x3_same.launches["forward"] += 2
    K3.fused_dblock.launches += 1
    return "outputs"


def _delta(after, before):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.fixture
def simulated(monkeypatch):
    """CUDA graphs on the CPU (``torch_graph_sim.install``): the warm-up
    runs ``fn``; the capture runs its Python (the wrappers count, as they
    do in a real capture) and a replay runs it again.
    ``simulated["dry"] = True`` makes the capture leave the state alone
    instead (it runs nothing, as on a card)."""
    return torch_graph_sim.install(monkeypatch.setattr)


def test_graph_launch_bookkeeping(simulated):
    before = launch_counts()
    g = graphs.Graph(_launch, "cpu", warmup=2)
    captured = launch_counts()
    one = {"synthesis_spectrum": 1, "conv3x3_forward": 2, "dblock": 1}
    assert _delta(captured, before) == {k: 2 * v for k, v in one.items()}
    assert g.launches == one
    for _ in range(3):
        assert g.replay() == "outputs"
    assert _delta(launch_counts(), captured) == {k: 3 * v
                                                 for k, v in one.items()}
    simulated["fail"] = "operation not permitted when stream is capturing"
    mark = launch_counts()
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.Graph(_launch, "cpu", warmup=0)
    assert launch_counts() == mark


def test_seeded_sampler_graphs_equal_eager(simulated):
    cfg = Config().with_overrides(NARROW)
    torch.manual_seed(0)
    g = Generator(cfg.model).eval()
    seeds, pitches = [3, 2 ** 31 + 5, 7], [36, 60, 84]
    graphed = make_seeded_sampler(cfg, g, 1)
    eager = make_seeded_sampler(cfg, g, 1, graphs=False)
    assert eager.graphed is None
    for _ in range(2):
        for b in (3, 1):
            got = graphed(seeds[:b], pitches[:b])
            assert torch.equal(got, eager(seeds[:b], pitches[:b]))
    assert simulated["captures"] == 2   # one graph per batch size
    assert sorted(k[0][0][0] for k in graphed.graphed.graphs) == [1, 3]
    service = SynthesisService(cfg, g, stage=1, max_batch=4)
    try:
        assert sorted(k[0][0][0] for k in
                      service._sample.graphed.graphs) == [1, 4]
        seed0 = (0 * 1000003 + 0) & 0x7FFFFFFF   # note 0 of seed 0
        # served at rung 1, the eager sampler at batch 1: the same bits
        np.testing.assert_array_equal(service.synthesize([60], seed=0)[0],
                                      eager([seed0], [60]).numpy()[0])
    finally:
        service.close()
    simulated["fail"] = "capture failed"
    with pytest.raises(RuntimeError, match="capture failed"):
        graphed(seeds[:2], pitches[:2])


def test_dp_seeded_sampler_graphs_each_replica(simulated):
    """Each replica's share replays its own graph, equal to the eager
    sampler's and to the single-device sampler at the share's batch."""
    cfg = Config().with_overrides(NARROW)
    torch.manual_seed(0)
    g = Generator(cfg.model).eval()
    seeds, pitches = [3, 2 ** 31 + 5, 7, 11], [36, 60, 84, 48]
    graphed = make_dp_seeded_sampler(cfg, g, ["cpu", "cpu"], 1)
    eager = make_dp_seeded_sampler(cfg, g, ["cpu", "cpu"], 1, graphs=False)
    assert eager.graphed == [] and len(graphed.graphed) == 2
    single = make_seeded_sampler(cfg, g, 1, graphs=False)
    want = torch.cat([single(seeds[:2], pitches[:2]),
                      single(seeds[2:], pitches[2:])])
    for _ in range(2):
        assert torch.equal(graphed(seeds, pitches), want)
        assert torch.equal(eager(seeds, pitches), want)
    assert simulated["captures"] == 2   # one graph per replica
    with pytest.raises(ValueError, match="divide"):
        graphed(seeds[:3], pitches[:3])


def test_keyed_samplers_graphs_equal_eager(simulated):
    """``make_sampler``, ``Sampler``, ``make_latent_sampler`` and
    ``make_dp_sampler`` replay one graph a batch size (a replica): wave and
    image equal to the eager sampler's to the bit; the latents come from
    the host's threefry as before. A generator whose weights moved is
    captured again."""
    from gansynth_tpu_torch.synth.random import normal, seed_to_key
    from gansynth_tpu_torch.synth.sampler import (
        Sampler,
        make_dp_sampler,
        make_latent_sampler,
        make_sampler,
    )

    cfg = Config().with_overrides(NARROW)
    torch.manual_seed(0)
    g = Generator(cfg.model).eval()
    key = seed_to_key(5)
    pitches = [36, 60, 84, 48]
    eager = make_sampler(cfg, g, 1, graphs=False)
    assert eager.graphed is None
    for graphed in (make_sampler(cfg, g, 1), Sampler(cfg, g, stage=1)):
        before = simulated["captures"]
        for _ in range(2):
            for b in (3, 1):
                got, want = graphed(key, pitches[:b]), eager(key,
                                                             pitches[:b])
                assert len(got) == 2
                for x, y in zip(got, want):
                    assert torch.equal(x, y)
        assert simulated["captures"] - before == 2   # one a batch size
        assert sorted(k[0][0][0] for k in graphed.graphed.graphs) == [1, 3]

    latent = make_latent_sampler(cfg, g, 1)
    latent_eager = make_latent_sampler(cfg, g, 1, graphs=False)
    z = normal(key, (4, cfg.model.latent_dim))
    labels = np.eye(cfg.model.num_pitches, dtype=np.float32)[[3, 9, 20, 1]]
    for _ in range(2):
        for x, y in zip(latent(z, labels), latent_eager(z, labels)):
            assert torch.equal(x, y)
    assert len(latent.graphed.graphs) == 1

    before = simulated["captures"]
    dp = make_dp_sampler(cfg, g, ["cpu", "cpu"], 1)
    dp_eager = make_dp_sampler(cfg, g, ["cpu", "cpu"], 1, graphs=False)
    assert dp_eager.graphed == [] and len(dp.graphed) == 2
    # each replica renders its half of the batch's latents at batch 2
    z = normal(key, (4, cfg.model.latent_dim))
    labels = torch.nn.functional.one_hot(
        torch.tensor(pitches) - cfg.model.pitch_min,
        cfg.model.num_pitches).float()
    want = torch.cat([latent_eager(z[:2], labels[:2])[0],
                      latent_eager(z[2:], labels[2:])[0]])
    for _ in range(2):
        assert torch.equal(dp(key, pitches), want)
        assert torch.equal(dp_eager(key, pitches), want)
    assert simulated["captures"] - before == 2   # one graph a replica

    # the generator's weights move (a restore into new tensors): the
    # graphs are dropped and captured again, and read the new weights
    sample = make_sampler(cfg, g, 1)
    sample(key, pitches)
    before = simulated["captures"]
    with torch.no_grad():
        for p in g.parameters():
            p.data = p.data * 0.5
    got = sample(key, pitches)
    assert simulated["captures"] - before == 1
    for x, y in zip(got, make_sampler(cfg, g, 1, graphs=False)(key,
                                                               pitches)):
        assert torch.equal(x, y)


def test_roundtrip_graphs_equal_eager(simulated):
    """``spectral_calls``: ``wave_to_image`` and ``image_to_wave`` as one
    graph each, equal to the eager calls to the bit."""
    from gansynth_tpu_torch.ops.spectral import spectral_calls
    from gansynth_tpu_torch.utils.config import AudioConfig

    audio = AudioConfig()
    wave = torch.from_numpy(note_batch(2)[0])
    to_image, to_wave = spectral_calls(audio, "cpu")
    eager_image, eager_wave = spectral_calls(audio, "cpu", graphs=False)
    assert isinstance(to_image, graphs.GraphedCall)
    assert not isinstance(eager_image, graphs.GraphedCall)
    for _ in range(2):
        image = to_image(wave)
        assert torch.equal(image, eager_image(wave))
        assert torch.equal(to_wave(image), eager_wave(image))
    assert simulated["captures"] == 2


def test_on_device_is_eager_off_a_card():
    """Off a card ``on_device`` runs ``fn`` itself on the inputs moved to
    the device; only a card's call is a ``GraphedCall``."""
    seen = []

    def fn(x):
        seen.append(x.device)
        return x + 1

    for flag in (True, False):
        call = graphs.on_device(fn, "cpu", flag)
        assert not isinstance(call, graphs.GraphedCall)
        assert torch.equal(call(torch.arange(3)), torch.arange(1, 4))
    assert seen == [torch.device("cpu")] * 2


def test_traced_kernel_names_map_to_the_port_kernels():
    """``profiling.port_kernel`` maps the device functions of
    ``kernels/csrc`` (as a trace names them: demangled, with template
    arguments, or mangled) to K1/K2/K3 and nothing else to any."""
    import re

    from gansynth_tpu_torch.utils import profiling

    csrc = os.path.join(os.path.dirname(K1.__file__), "csrc")
    found = {}
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                for fn in re.findall(r"__global__ void[^\n]*\n(\w+)",
                                     f.read()):
                    found[fn] = profiling.port_kernel(fn)
    assert found == {"synthesis_spectrum_gather": "synthesis_spectrum",
                     "conv3x3_nhwc_f32_fma": "conv3x3",
                     "conv3x3_nhwc_bf16_wgmma": "conv3x3",
                     "dblock_nhwc_f32_fma": "dblock",
                     "dblock_nhwc_bf16_wgmma": "dblock"}
    assert profiling.port_kernel(
        "void conv3x3_nhwc_bf16_wgmma<256>(CUtensorMap_st, "
        "CUtensorMap_st, __nv_bfloat16*, int, int, int)") == "conv3x3"
    assert profiling.port_kernel(
        "_Z23dblock_nhwc_bf16_wgmma14CUtensorMap_stS_PK13__nv_bfloat16"
    ) == "dblock"
    for other in ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_"
                  "nhwckrsc_nhwc_tilesize128x128x64",
                  "void at::native::vectorized_elementwise_kernel<4, "
                  "at::native::FillFunctor<float>>",
                  "void fft_r2c<unsigned int, float>(...)"):
        assert profiling.port_kernel(other) is None


def _cached_run(cfg, state, alphas, graphs_on):
    all_waves, pitches = note_batch(EXAMPLES)
    # one dataset tensor for the run: the graph holds its address
    all_waves = torch.from_numpy(all_waves)
    pitches = torch.from_numpy(pitches.astype(np.int32))
    superstep = tstep.make_cached_superstep(cfg, STAGE, EXAMPLES,
                                            graphs=graphs_on)
    metrics = []
    for chunk in alphas:
        state, m = superstep(state, all_waves, pitches, chunk)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_cached_superstep_graph_path_equals_eager(simulated):
    simulated["dry"] = True
    cfg = Config().with_overrides(
        {**NARROW, "train": {**NARROW["train"], "unroll": 3}})
    alphas = [[0.25, 0.5, 0.75], [1.0, 1.0]]
    fresh = create_train_state(cfg, seed=0, device="cpu")
    eager, m_eager = _cached_run(cfg, create_train_state(
        cfg, seed=0, device="cpu"), alphas, False)
    assert simulated["captures"] == 0
    graph, m_graph = _cached_run(cfg, fresh, alphas, True)
    assert simulated["captures"] == 1   # one state, one capture
    assert m_graph == m_eager
    a, b = state_arrays(graph), state_arrays(eager)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # a failed capture raises and leaves the state as it was
    other = create_train_state(cfg, seed=1, device="cpu")
    before = state_arrays(other)
    simulated["fail"] = "capture failed"
    with pytest.raises(RuntimeError, match="capture failed"):
        _cached_run(cfg, other, alphas[:1], True)
    after = state_arrays(other)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_a_superstep_recaptures_for_another_state(simulated):
    simulated["dry"] = True
    cfg = Config().with_overrides(NARROW)
    waves_, pitches = note_batch(4)
    superstep = tstep.make_superstep(cfg, STAGE)
    for seed in (0, 0, 1):
        state = create_train_state(cfg, seed=seed, device="cpu")
        superstep(state, torch.from_numpy(waves_).reshape(2, 2, -1),
                  torch.from_numpy(pitches).reshape(2, 2), [1.0, 1.0])
    assert simulated["captures"] == 3   # each state has its own tensors
