"""Card-only tests of the port: each CUDA kernel against its plain version,
an exported sampler that launches K1 from its program, and the CUDA
graphs of the serving rungs, the keyed samplers and the training
superstep (on one card, and in an NCCL group of one rank) against the
same work run eagerly.

Marked ``gpu``; each test skips unless ``torch.cuda.is_available()``. This
file imports neither JAX nor the reference package, so it also runs on a
machine that has PyTorch and CUDA but no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The bars of
K1 are those of ``tests/test_pallas_kernels.py``: spectrum within atol
2e-2, wave max abs error below 5e-3 with an SNR above 40 dB. K2 and K3 are
held to their plain versions (cuDNN, TF32 off) at the bars of
``tests/test_pallas_conv.py`` and ``tests/test_pallas_dblock.py`` in f32,
and within 3e-2 of the output's scale in bf16 (both sides accumulate in
f32 and round once to bf16, whose ulp is 2**-8 of the value).
"""

import dataclasses
import math

import pytest
import torch

from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import synthesis as K
from gansynth_tpu_torch.ops import spectral as tspec
from gansynth_tpu_torch.utils.config import AudioConfig

CFG = AudioConfig()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from gansynth_tpu_torch.utils.device import set_precision

    set_precision()
    return torch.device("cuda")


def _image(batch, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batch, 128, 1024, 2), generator=gen,
                      device=device) * 2 - 1


def _wave_bar(want, got):
    err = (want - got).abs()
    assert float(err.max()) < 5e-3
    snr = 10 * math.log10(float((want.double() ** 2).sum())
                          / max(float((err.double() ** 2).sum()), 1e-30))
    assert snr > 40.0


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 4, 8, 9, 16, 61])
def test_synthesis_kernel_matches_plain(cuda_device, batch):
    x = _image(batch, cuda_device, batch)
    before = K.synthesis_spectrum.launches
    re, im = K.synthesis_spectrum(x, CFG)
    torch.cuda.synchronize()
    assert K.synthesis_spectrum.launches == before + 1
    pre, pim = K.synthesis_spectrum_plain(x, CFG)
    torch.testing.assert_close(re, pre, rtol=0, atol=2e-2)
    torch.testing.assert_close(im, pim, rtol=0, atol=2e-2)
    _wave_bar(tspec.istft_rect(pre, pim, CFG), tspec.istft_rect(re, im, CFG))


@pytest.mark.gpu
def test_image_to_wave_takes_the_kernel_on_cuda(cuda_device):
    x = _image(2, cuda_device, 7)
    before = K.synthesis_spectrum.launches
    got = tspec.image_to_wave(x, CFG)
    assert K.synthesis_spectrum.launches == before + 1
    plain = tspec.image_to_wave(
        x, dataclasses.replace(CFG, synthesis_kernel="xla"))
    assert K.synthesis_spectrum.launches == before + 1
    _wave_bar(plain, got)
    with pytest.raises(ValueError, match="aligned"):
        K.synthesis_spectrum(
            x.reshape(-1)[1:1 + x.numel() // 2].reshape(1, 128, 1024, 2),
            CFG)


@pytest.mark.gpu
def test_synthesis_kernel_padded_taps_give_the_plain_value(cuda_device):
    """Bins 0 and 1023 have no mel taps, bins 1021 and 1022 one; the
    kernel pads their tap tables with index -1 and weight 0 and must read
    nothing through the padding. Every mel column those bins do not use is
    poisoned (exp overflows to inf, the IF is NaN), so a read through a
    padded tap would turn them into NaN; they must equal the plain version
    on the clean image (0 taps: exactly (sqrt(eps), 0))."""
    index, _ = K.tap_tables(K.mel_pinv(CFG, "cpu").numpy())
    bins = [0, 1021, 1022, 1023]
    assert (index[bins] >= 0).sum(axis=1).tolist() == [0, 1, 1, 0]
    used = torch.zeros(CFG.num_mel_bins, dtype=torch.bool)
    used[[int(m) for m in index[bins].reshape(-1) if m >= 0]] = True
    clean = _image(2, cuda_device, 11)
    poisoned = clean.clone()
    poisoned[:, :, ~used.to(cuda_device), 0] = 1e4
    poisoned[:, :, ~used.to(cuda_device), 1] = float("nan")
    re, im = K.synthesis_spectrum(poisoned, CFG)
    pre, pim = K.synthesis_spectrum_plain(clean, CFG)
    torch.cuda.synchronize()
    for got, want in ((re, pre), (im, pim)):
        assert bool(torch.isfinite(got[..., bins]).all())
        torch.testing.assert_close(got[..., bins], want[..., bins], rtol=0,
                                   atol=2e-2)
    for f in (0, 1023):
        torch.testing.assert_close(re[..., f], pre[..., f], rtol=0, atol=0)
        assert bool((im[..., f] == 0).all()) and bool((pim[..., f] == 0).all())


@pytest.mark.gpu
def test_synthesis_entry_refuses_a_strip_table_or_span_it_cannot_take(
        cuda_device):
    """The C entry checks the strip table's row count against its own strip
    width and the shared memory a span needs against the 48 KB default; it
    returns cudaErrorInvalidValue (1) and launches nothing otherwise."""
    fn = K._kernel(torch.float32)
    index, weight, strips, span_max = K._device_taps(CFG, cuda_device)
    x = _image(1, cuda_device, 13)
    re = torch.empty((1, 128, CFG.num_freq_bins), device=cuda_device)
    im = torch.empty_like(re)
    stream = torch.cuda.current_stream().cuda_stream

    def call(num_strips, span):
        return fn(x.data_ptr(), index.data_ptr(), weight.data_ptr(),
                  strips.data_ptr(), num_strips, span, re.data_ptr(),
                  im.data_ptr(), 1, 128, CFG.num_mel_bins, CFG.num_freq_bins,
                  1.0, 0.0, CFG.logmel_eps, stream)

    rows = strips.shape[0]
    assert rows * K.STRIP == CFG.num_freq_bins
    assert call(rows, span_max) == 0
    torch.cuda.synchronize()
    assert call(rows // 2, span_max) == 1
    assert call(rows * 2, span_max) == 1
    assert call(rows, 98) == 1   # 2 * 32 * 98 * 8 bytes > 48 KB


def _rand(shape, device, seed, dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    err = float((got.detach().float() - want.detach().float()).abs().max())
    ref = max(1.0, float(want.detach().float().abs().max()))
    assert err <= tol * ref, f"max abs err {err:.3e} > {tol} * {ref:.3e}"


_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 16, 128, 128, 256)),
    (torch.bfloat16, (2, 16, 128, 128, 256)),
    (torch.float32, (1, 5, 37, 20, 12)),
    # bf16 takes channels in multiples of 8 (TMA's 16-byte strides): ragged
    # in H and W, and in channels against the 64-channel K chunk and the
    # 128-channel N tile
    (torch.bfloat16, (1, 5, 37, 24, 40)),
])
def test_conv3x3_matches_plain(cuda_device, dtype, shape):
    """Forward and first-order dx / dw at a ladder shape and at a ragged
    one (every tile edge masked or zero-filled)."""
    b, h, w, c_in, c_out = shape
    x = _rand((b, h, w, c_in), cuda_device, 1, dtype).requires_grad_()
    wt = _rand((c_out, c_in, 3, 3), cuda_device, 2, dtype,
               (9 * c_in) ** -0.5).requires_grad_()
    r = _rand((b, h, w, c_out), cuda_device, 3, dtype)
    before = dict(K2.conv3x3_same.launches)
    y = K2.conv3x3_same(x, wt)
    gx, gw = torch.autograd.grad((y * r).sum(), (x, wt))
    torch.cuda.synchronize()
    assert K2.conv3x3_same.launches["forward"] == before["forward"] + 1
    assert K2.conv3x3_same.launches["input_grad"] == before["input_grad"] + 1
    y_p = K2.conv3x3_plain(x, wt)
    gx_p, gw_p = torch.autograd.grad((y_p * r).sum(), (x, wt))
    _close(y, y_p, _TOL[dtype])
    _close(gx, gx_p, _TOL[dtype])
    _close(gw, gw_p, _TOL[dtype] * 10)   # sums over B*H*W terms


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out", [(20, 24), (24, 12)])
def test_conv3x3_bf16_rejects_channels_off_8(cuda_device, c_in, c_out):
    x = _rand((1, 4, 16, c_in), cuda_device, 1, torch.bfloat16)
    wt = _rand((c_out, c_in, 3, 3), cuda_device, 2, torch.bfloat16)
    before = dict(K2.conv3x3_same.launches)
    with pytest.raises(ValueError, match="multiples of 8"):
        K2.conv3x3_same(x, wt)
    assert K2.conv3x3_same.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_second_order(cuda_device, dtype):
    """The WGAN-GP shape: d/dw of ||d(sum conv(x, w) r)/dx||^2; bar 1e-3
    in f32 (tests/test_pallas_conv.py), 3e-2 of the scale in bf16."""
    x = _rand((2, 8, 16, 16), cuda_device, 4, dtype).requires_grad_()
    r = _rand((2, 8, 16, 24), cuda_device, 5, dtype)

    def gp(fn, wt):
        gx = torch.autograd.grad((fn(x, wt) * r).sum(), x,
                                 create_graph=True)[0]
        return torch.autograd.grad((gx.float() ** 2).sum(), wt)[0]

    wt = _rand((24, 16, 3, 3), cuda_device, 6, dtype,
               scale=0.1).requires_grad_()
    got = gp(K2.conv3x3_same, wt)
    want = gp(K2.conv3x3_plain, wt)
    _close(got, want, 1e-3 if dtype == torch.float32 else 3e-2)


def _dblock_inputs(device, b, h, w, c1, dtype, seed=10):
    x = _rand((b, h, w, 64), device, seed, dtype)
    k0 = _rand((64, 64, 3, 3), device, seed + 1, scale=0.1)
    b0 = _rand((64,), device, seed + 2, scale=0.1)
    k1 = _rand((c1, 64, 3, 3), device, seed + 3, scale=0.1)
    b1 = _rand((c1,), device, seed + 4, scale=0.1)
    return [x, k0, b0, k1, b1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 128, 128), (1, 12, 20, 72),
                                   (1, 20, 40, 72)])
def test_dblock_matches_plain(cuda_device, dtype, shape):
    """Forward and first order against the literal chain, at a tile-aligned
    shape and two ragged ones: (1, 12, 20) is smaller than one bf16 tile
    (16 x 32 conv1 outputs), (1, 20, 40) spills into a second tile in
    both directions; C1 = 72 leaves the second 64-channel pass partial."""
    b, h, w, c1 = shape
    args = _dblock_inputs(cuda_device, b, h, w, c1, dtype)
    for a in args:
        a.requires_grad_()
    r = _rand((b, h // 2, w // 2, c1), cuda_device, 20, dtype)
    before = K3.fused_dblock.launches
    y = K3.fused_dblock(*args, 0.2)
    g = torch.autograd.grad((y * r).sum(), args)
    torch.cuda.synchronize()
    assert K3.fused_dblock.launches == before + 1
    y_p = K3.dblock_plain(*args, 0.2)
    g_p = torch.autograd.grad((y_p * r).sum(), args)
    _close(y, y_p, 1e-5 if dtype == torch.float32 else 3e-2)
    # explicit adjoints against autograd of the chain: the same cuDNN
    # convs, rounded at other places in bf16
    for a, b_ in zip(g, g_p):
        _close(a, b_, 1e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dblock_second_order(cuda_device, dtype):
    """d/dk0 of ||d sum(block(x))/dx||^2; bar 1e-4 in f32
    (tests/test_pallas_dblock.py), 3e-2 of the scale in bf16."""
    x, k0, b0, k1, b1 = _dblock_inputs(cuda_device, 1, 8, 16, 128, dtype)
    x.requires_grad_()
    k0.requires_grad_()

    def gp(fn):
        gx = torch.autograd.grad(fn(x, k0, b0, k1, b1, 0.2).sum(), x,
                                 create_graph=True)[0]
        return torch.autograd.grad((gx.float() ** 2).sum(), k0)[0]

    _close(gp(K3.fused_dblock), gp(K3.dblock_plain),
           1e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("conv_kernel", ["pallas", "xla"])
def test_flagship_bf16_generator_matches_reference_file(cuda_device,
                                                        conv_kernel):
    """The port's stage-6 flagship generator in bf16 on the card against
    the reference's output committed under tests/data (made on the CPU;
    this machine need not have JAX), at the bar that
    tests/torch_reference_data.py states: with ``conv_kernel="pallas"``
    K2 runs the eligible convs (conv1 of blocks 3-5), with ``"xla"``
    cuDNN runs them all."""
    import os

    import torch_reference_data as ref
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    flagship = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs", "flagship_r4")
    d = ref.load()
    config = run_config(flagship)
    model = dataclasses.replace(config.model, conv_kernel=conv_kernel)
    g, _, _ = load_ema_generator(os.path.join(flagship, "ema.npz"), model,
                                 cuda_device)
    before = K2.conv3x3_same.launches["forward"]
    with torch.no_grad():
        got = g(torch.from_numpy(d["z"]).to(cuda_device),
                torch.from_numpy(d["labels"]).to(cuda_device),
                int(d["stage"]), 1.0)
    torch.cuda.synchronize()
    launched = K2.conv3x3_same.launches["forward"] - before
    assert launched == (3 if conv_kernel == "pallas" else 0)
    ref.check(got.cpu().numpy(), d["image"])


@pytest.mark.gpu
def test_exported_sampler_launches_the_kernel(cuda_device, tmp_path):
    """A tiny model exported on the card keeps K1 in its program: loaded on
    the card it launches the kernel (waves within export-model --check's
    1e-3 of the in-process sampler's), and loaded on the CPU it runs the
    plain version (within the synthesis bar of the card's waves)."""
    from gansynth_tpu_torch.models.generator import Generator
    from gansynth_tpu_torch.synth.export import (
        load_sampler_artifact,
        save_sampler_artifact,
    )
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler
    from gansynth_tpu_torch.utils.config import Config, ModelConfig

    config = Config(model=ModelConfig(latent_dim=8, fmap_base=64,
                                      fmap_max=16, fmap_min=8))
    gen = Generator(config.model, generator=torch.Generator().manual_seed(0))
    gen = gen.to(cuda_device)
    path = save_sampler_artifact(str(tmp_path / "s.gsx"), config, gen,
                                 step=1, stage=2)
    on_card = load_sampler_artifact(path, "cuda")
    seeds, pitch = [0, 1, 2], [30, 60, 84]
    before = K.synthesis_spectrum.launches
    got = on_card(seeds, pitch)
    torch.cuda.synchronize()
    # the rung's first call: a warm-up batch, then the captured graph's
    # replay (utils/graphs.py), one launch each
    assert K.synthesis_spectrum.launches == before + 2
    want = make_seeded_sampler(config, gen, 2)(seeds, pitch)
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-3
    on_cpu = load_sampler_artifact(path, "cpu")
    cpu = on_cpu(seeds, pitch)
    assert cpu.device.type == "cpu"
    # two more from the in-process sampler's first call, none from the CPU
    assert K.synthesis_spectrum.launches == before + 4
    _wave_bar(cpu, got.cpu())


def _step_state(config, device, seed=0):
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.state import create_train_state

    state = create_train_state(config, seed=seed, device=device)
    waves, pitches = note_batch(config.train.batch_size)
    return (state, torch.from_numpy(waves).to(device),
            torch.from_numpy(pitches).to(device))


@pytest.mark.gpu
def test_nccl_world_one_step_equals_no_group(cuda_device):
    """One card in an NCCL group of one rank: the data-parallel cached
    superstep runs its collectives (the gradient buckets, the metrics, the
    sharded cache's gather) and ends where the superstep without a group
    ends. cuDNN runs its deterministic algorithms here (its float32 weight
    gradients may otherwise sum in another order from run to run), and
    the metrics and weights must be within twice the distance between two
    runs without a group (0 where they repeat)."""
    import copy
    import socket

    import torch.distributed as dist

    from gansynth_tpu_torch.parallel import sharding
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.config import Config

    config = Config().with_overrides({
        "model": dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8),
        "train": dict(batch_size=4, device_cache_layout="shard")})
    state, waves, pitches = _step_state(config, cuda_device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sharding.initialize_multihost(cuda_device, f"tcp://127.0.0.1:{port}",
                                  0, 1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = sharding.make_mesh()
        assert (mesh.world, mesh.grouped, dist.get_backend()) == \
            (1, True, "nccl")
        results = []
        for m in (None, None, mesh):
            st = copy.deepcopy(state)
            st, metrics = make_cached_superstep(config, 2, 4, m)(
                st, waves, pitches, [0.5, 1.0])
            results.append(({k: float(v) for k, v in metrics.items()},
                            [p.detach().clone() for p in
                             [*st.g.parameters(), *st.d.parameters()]]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    (m0, w0), (m1, w1), (m2, w2) = results
    for k in m0:
        assert abs(m2[k] - m0[k]) <= 2 * abs(m1[k] - m0[k]), k
    repeat = max(float((a - b).abs().max()) for a, b in zip(w0, w1))
    group = max(float((a - b).abs().max()) for a, b in zip(w0, w2))
    assert group <= 2 * repeat, (group, repeat)


@pytest.fixture
def nccl_mesh(cuda_device):
    """A mesh of an NCCL group of one rank on this card (the collectives
    run), destroyed after the test."""
    import socket

    import torch.distributed as dist

    from gansynth_tpu_torch.parallel import sharding

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sharding.initialize_multihost(cuda_device, f"tcp://127.0.0.1:{port}",
                                  0, 1)
    try:
        yield sharding.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["replicate", "shard"])
def test_nccl_world_cached_superstep_graph_equals_eager(nccl_mesh, layout):
    """The mesh's 3-step cached superstep at the flagship's widths (stage
    6, batch 2, bf16, K2 and K3 on) in an NCCL group of one rank: the
    CUDA graph, collectives captured, ends where the eager run ends, to
    the bit in G, D, EMA and the metrics; a replay launches K2 and K3 as
    an eager step does."""
    import copy

    from gansynth_tpu_torch.kernels import launch_counts
    from gansynth_tpu_torch.train.step import make_cached_superstep

    config, state, waves, pitches = _flagship_width_state(
        nccl_mesh.device, False)
    config = config.with_overrides(
        {"train": {"device_cache_layout": layout}})
    alphas = [0.25, 0.5, 1.0]
    eager_state = copy.deepcopy(state)
    eager = make_cached_superstep(config, 6, 6, nccl_mesh, graphs=False)
    graphed = make_cached_superstep(config, 6, 6, nccl_mesh)
    before = launch_counts()
    _, m_eager = eager(eager_state, waves, pitches, alphas)
    torch.cuda.synchronize()
    per_step = {k: (v - before[k]) / 3 for k, v in launch_counts().items()}
    _, m_graph = graphed(state, waves, pitches, alphas)
    assert graphed.program.graph is not None
    assert {k: float(v) for k, v in m_graph.items()} == \
        {k: float(v) for k, v in m_eager.items()}
    a, b = _flat(state), _flat(eager_state)
    for net in a:
        assert float((a[net] - b[net]).abs().max()) == 0.0, net
    before = launch_counts()
    graphed(state, waves, pitches, alphas)   # replays only
    torch.cuda.synchronize()
    assert {k: (v - before[k]) / 3 for k, v in launch_counts().items()} == \
        per_step


@pytest.mark.gpu
def test_remat_lowers_the_step_peak_memory(cuda_device):
    """The stage-6 step at the flagship's widths, batch 2, float32: with
    ``remat=True`` the step's peak memory is below ``remat=False``'s, and
    its metrics agree (bar of chip_smoke.py's phase 9)."""
    from gansynth_tpu_torch.train.step import make_train_step
    from gansynth_tpu_torch.utils.config import Config

    peaks, metrics = {}, {}
    for remat in (False, True):
        config = Config().with_overrides({"model": {"remat": remat},
                                          "train": {"batch_size": 2}})
        state, waves, pitches = _step_state(config, cuda_device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, m = make_train_step(config, 6)(state, waves, pitches, 1.0)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        metrics[remat] = {k: float(v) for k, v in m.items()}
        del state
        torch.cuda.empty_cache()
    assert peaks[True] < peaks[False], peaks
    for k, v in metrics[False].items():
        assert abs(metrics[True][k] - v) <= 1e-3 * max(1.0, abs(v)), k


def _tiny_generator(device):
    from gansynth_tpu_torch.models.generator import Generator
    from gansynth_tpu_torch.utils.config import Config, ModelConfig

    config = Config(model=ModelConfig(latent_dim=8, fmap_base=64,
                                      fmap_max=16, fmap_min=8))
    gen = Generator(config.model, generator=torch.Generator().manual_seed(0))
    return config, gen.to(device).eval()


@pytest.mark.gpu
def test_serving_graphs_equal_eager_at_each_rung(cuda_device, tmp_path):
    """Each rung's CUDA graph (the in-process seeded sampler, each
    data-parallel replica's share, the exported artifact) renders the
    eager batch to the bit, and launches K1 once a replay (by the
    wrapper's count and by name in a profiler trace)."""
    from gansynth_tpu_torch.synth.export import (
        load_sampler_artifact,
        save_sampler_artifact,
    )
    from gansynth_tpu_torch.synth.sampler import (
        make_dp_seeded_sampler,
        make_seeded_sampler,
    )
    from gansynth_tpu_torch.utils.profiling import kernel_launches

    config, gen = _tiny_generator(cuda_device)
    graphed = make_seeded_sampler(config, gen, 2)
    eager = make_seeded_sampler(config, gen, 2, graphs=False)
    path = save_sampler_artifact(str(tmp_path / "s.gsx"), config, gen,
                                 step=1, stage=2)
    exported = load_sampler_artifact(path, "cuda")
    exported_eager = load_sampler_artifact(path, "cuda", graphs=False)
    dp = make_dp_seeded_sampler(config, gen, ["cuda:0", "cuda:0"], 2)
    for b in (1, 4, 16):
        seeds = [1000 + 7 * i for i in range(b)]
        pitches = [24 + (5 * i) % 61 for i in range(b)]
        want = eager(seeds, pitches)
        for sample, ref in ((graphed, want),
                            (exported, exported_eager(seeds, pitches))):
            sample(seeds, pitches)   # the rung's capture
            before = K.synthesis_spectrum.launches
            got = sample(seeds, pitches)
            assert K.synthesis_spectrum.launches == before + 1
            assert torch.equal(got, ref)
            traced = kernel_launches(lambda: sample(seeds, pitches))
            assert traced["synthesis_spectrum"] == 1
        if b > 1:   # two replicas, each with its half at its own rung
            half = b // 2
            want_dp = torch.cat([eager(seeds[:half], pitches[:half]),
                                 eager(seeds[half:], pitches[half:])]).cpu()
            assert torch.equal(dp(seeds, pitches), want_dp)
    assert sorted(k[0][0][0] for k in graphed.graphed.graphs) == [1, 4, 16]
    assert [sorted(k[0][0][0] for k in g.graphs) for g in dp.graphed] == \
        [[2, 8]] * 2


@pytest.fixture
def deterministic_cudnn(cuda_device):
    """The card, with cuDNN on its deterministic algorithms for the test."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield cuda_device
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [3, 61])
def test_keyed_sampler_graphs_equal_eager(deterministic_cudnn, batch):
    """The keyed sampler (the loop's sample dumps, ``generate``,
    ``evaluate``) and the latent sampler (``interpolate``) replay one CUDA
    graph a batch size: wave and image equal to the eager call's to the
    bit, K1 once a replay. cuDNN runs its deterministic algorithms: at
    B=61 the narrow float32 generator's eager calls otherwise differ from
    each other in their last bits, graph or not."""
    from gansynth_tpu_torch.synth.random import seed_to_key
    from gansynth_tpu_torch.synth.sampler import (
        make_latent_sampler,
        make_sampler,
    )

    config, gen = _tiny_generator(deterministic_cudnn)
    key = seed_to_key(batch)
    pitches = [24 + (7 * i) % 61 for i in range(batch)]
    graphed, eager = make_sampler(config, gen, 2), make_sampler(
        config, gen, 2, graphs=False)
    want = eager(key, pitches)
    graphed(key, pitches)   # the batch size's capture
    before = K.synthesis_spectrum.launches
    got = graphed(key, pitches)
    torch.cuda.synchronize()
    assert K.synthesis_spectrum.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    z = torch.randn(batch, config.model.latent_dim,
                    generator=torch.Generator().manual_seed(batch))
    labels = torch.eye(config.model.num_pitches)[
        torch.tensor(pitches) - config.model.pitch_min]
    latent = make_latent_sampler(config, gen, 2)
    for _ in range(2):
        got = latent(z, labels)
        want = make_latent_sampler(config, gen, 2, graphs=False)(z, labels)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def _flagship_width_state(device, remat):
    """The flagship's widths at stage 6, batch 2, bf16, K2 and K3 on."""
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.utils.config import Config

    config = Config().with_overrides({
        "model": {"compute_dtype": "bfloat16", "conv_kernel": "pallas",
                  "dblock_kernel": "pallas", "remat": remat},
        "train": {"batch_size": 2, "unroll": 3}})
    state = create_train_state(config, seed=0, device=device)
    waves, pitches = note_batch(6)
    return (config, state, torch.from_numpy(waves).to(device),
            torch.from_numpy(pitches.astype("int32")).to(device))


def _flat(state):
    return {net: torch.cat([p.detach().float().reshape(-1) for p in
                            getattr(state, net).parameters()])
            for net in ("g", "d", "ema")}


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_cached_superstep_graph_equals_eager(cuda_device, remat):
    """A 3-step cached superstep at the flagship's widths (stage 6, batch
    2, bf16, K2 and K3 on; with and without remat) from one state: the
    graph's G, D and EMA at distance 0 from the eager run's, the metrics
    equal; a replay launches K2 and K3 as often as an eager step, by the
    wrappers' counts and by name in a profiler trace of the replays."""
    import copy

    from gansynth_tpu_torch.kernels import launch_counts
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.profiling import kernel_launches

    config, state, waves, pitches = _flagship_width_state(cuda_device,
                                                          remat)
    alphas = [0.25, 0.5, 1.0]
    eager_state = copy.deepcopy(state)
    eager = make_cached_superstep(config, 6, 6, graphs=False)
    graphed = make_cached_superstep(config, 6, 6)
    before = launch_counts()
    _, m_eager = eager(eager_state, waves, pitches, alphas)
    torch.cuda.synchronize()
    per_step = {k: (v - before[k]) / 3 for k, v in launch_counts().items()}
    _, m_graph = graphed(state, waves, pitches, alphas)
    assert {k: float(v) for k, v in m_graph.items()} == \
        {k: float(v) for k, v in m_eager.items()}
    a, b = _flat(state), _flat(eager_state)
    for net in a:
        assert float((a[net] - b[net]).abs().max()) == 0.0, net
    before = launch_counts()
    graphed(state, waves, pitches, alphas)   # replays only
    torch.cuda.synchronize()
    replayed = {k: (v - before[k]) / 3 for k, v in launch_counts().items()}
    assert replayed == per_step
    # the kernels the replays ran on the device, counted by name
    traced = kernel_launches(lambda: graphed(state, waves, pitches, alphas))
    assert traced["conv3x3"] == 3 * (per_step["conv3x3_forward"]
                                     + per_step["conv3x3_input_grad"]
                                     + per_step["conv3x3_recompute"])
    assert traced["dblock"] == 3 * (per_step["dblock"]
                                    + per_step["dblock_recompute"])
    assert per_step["conv3x3_forward"] + per_step["conv3x3_input_grad"] \
        + per_step["conv3x3_recompute"] > 0 and per_step["dblock"] > 0
    assert (per_step["conv3x3_recompute"] > 0) == remat


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda_device):
    """A function that reads a device value on the host cannot be
    captured: the capture raises, and nothing runs it eagerly instead."""
    from gansynth_tpu_torch.utils import graphs

    x = torch.ones(4, device=cuda_device)
    calls = []

    def host_read():
        calls.append(None)
        return x * float(x.sum())

    with pytest.raises(RuntimeError):
        graphs.Graph(host_read, cuda_device, warmup=1)
    assert len(calls) == 2   # the warm-up and the capture, no retry
    assert not torch.cuda.is_current_stream_capturing()
    assert float(torch.ones(2, device=cuda_device).sum()) == 2.0
