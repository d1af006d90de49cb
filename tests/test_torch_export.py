"""The port's portable serving artifact (``gansynth_tpu_torch/synth/export.py``)
on the CPU, at the tiny config of ``tests/torch_tiny_run.py`` (stage 2).

The cases of ``tests/test_export.py``, against the port's in-process
samplers and against the reference's ``make_seeded_sampler`` /
``make_latent_sampler`` on the same weights (the repo's synthesis bar: max
abs error < 5e-3, SNR > 40 dB), and the port's own: K1 (and K2) stay in the
exported graph, a JAX artifact is refused, the in-graph latents equal the
host's, and an export that is the first caller leaves the constant caches
holding real tensors.

The program runs the in-process sampler's own modules, so on the CPU its
waves equal the in-process sampler's bit for bit (measured: max abs
difference 0.0); the tests hold them to the reference's round-trip bar,
1e-3 relative L2.
"""

import dataclasses
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tiny_run as tiny
from gansynth_tpu.synth.sampler import make_latent_sampler as j_latent
from gansynth_tpu.synth.sampler import make_seeded_sampler as j_seeded
from gansynth_tpu_torch import cli
from gansynth_tpu_torch.kernels import synthesis as K1
from gansynth_tpu_torch.kernels.conv import conv3x3_plain, conv3x3_same
from gansynth_tpu_torch.ops import spectral
from gansynth_tpu_torch.synth import export as X
from gansynth_tpu_torch.synth.random import (
    random_bits,
    seed_to_key,
    seeded_latents,
    seeded_latents_torch,
)
from gansynth_tpu_torch.synth.sampler import (
    make_latent_sampler,
    make_seeded_sampler,
)
from torch_threads import two_torch_threads  # noqa: F401

STAGE = tiny.NPZ_STAGE      # 8 x 64 image, nearest-upsampled to 128 x 1024
ROUNDTRIP_BAR = 1e-3        # the reference's relative L2 bound in float32
SYNTH_OP = "gansynth_torch.synthesis_spectrum.default"


def _wave_bar(want, got):
    err = np.abs(want - got)
    assert err.max() < 5e-3, err.max()
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert snr > 40.0, snr


def _rel(want, got):
    return float(np.linalg.norm(want - got) / (np.linalg.norm(want) + 1e-30))


def _ops(graph_module):
    return [str(n.target) for n in graph_module.graph.nodes
            if n.op == "call_function"]


@pytest.fixture(scope="module")
def params():
    return tiny.tiny_params()


@pytest.fixture(scope="module")
def configs():
    return tiny.configs()


@pytest.fixture(scope="module")
def gen(params):
    return tiny.port_generator(params)


@pytest.fixture(scope="module")
def artifact(configs, gen, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gsx") / "sampler.gsx")
    return X.save_sampler_artifact(path, configs[1], gen, step=123,
                                   stage=STAGE)


@pytest.fixture(scope="module")
def loaded(artifact):
    return X.load_sampler_artifact(artifact, "cpu")


@pytest.fixture(scope="module")
def latent_artifact(configs, gen, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gsx_latent") / "sampler.gsx")
    return X.save_sampler_artifact(path, configs[1], gen, step=123,
                                   stage=STAGE, with_latent=True)


def test_roundtrip_matches_in_process_sampler(configs, gen, loaded):
    seeds, pitch = [0, 1, 2], [30, 60, 84]
    want = make_seeded_sampler(configs[1], gen, STAGE)(seeds, pitch).numpy()
    got = loaded(seeds, pitch)
    assert type(got) is torch.Tensor and got.shape == (3, 64000)
    got = got.numpy()
    rel = _rel(want, got)
    print(f"artifact vs in-process: relative L2 {rel:.3g}, max abs "
          f"{np.abs(want - got).max():.3g}")
    assert rel <= ROUNDTRIP_BAR
    np.testing.assert_array_equal(got, loaded(seeds, pitch).numpy())


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_symbolic_batch_matches_the_reference(configs, params, loaded, batch):
    """One artifact serves every batch, each within the synthesis bar of
    the reference's seeded sampler on the same weights and seeds."""
    rng = np.random.default_rng(batch)
    seeds = rng.integers(0, 2 ** 31, batch).astype(np.int32)
    pitch = rng.integers(24, 85, batch).astype(np.int32)
    want = np.asarray(j_seeded(configs[0], STAGE)(
        params, jnp.asarray(seeds), jnp.asarray(pitch)))
    got = loaded(seeds, pitch).numpy()
    assert got.shape == want.shape == (batch, 64000)
    _wave_bar(want, got)


def test_per_note_purity_across_cobatches(loaded):
    a = loaded([3, 7, 11], [60, 48, 72]).numpy()
    b = loaded([7, 5, 9], [48, 30, 84]).numpy()
    np.testing.assert_array_equal(a[1], b[0])
    solo = loaded([7], [48]).numpy()[0]
    assert _rel(a[1], solo) <= ROUNDTRIP_BAR


def test_metadata_and_config_roundtrip(configs, loaded):
    assert (loaded.step, loaded.stage) == (123, STAGE)
    assert loaded.sample_rate == 16000
    assert loaded.platforms == ("cpu", "cuda")
    assert loaded.device == torch.device("cpu")
    meta = loaded.meta
    assert meta["format"] == "gansynth-torch-exported-sampler"
    assert meta["batch"] == "symbolic"
    assert (meta["pitch_min"], meta["pitch_max"]) == (24, 84)
    assert [p["name"] for p in meta["programs"]] == ["seeded"]
    # The config rides unchanged: the program runs the synthesis kernel
    # the config names (no pinning, unlike the reference).
    assert loaded.config() == configs[1]
    assert loaded.config().audio.synthesis_kernel == "auto"
    assert not loaded.has_latent


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
def test_export_keeps_the_synthesis_kernel(configs, gen, kernel):
    """K1 is one node of the program whatever device the export ran on (it
    launches the kernel on a card and the plain version on the CPU);
    ``xla`` exports the plain path. The reference instead pins every
    export to its plain lowering (``test_export_pins_portable_...``)."""
    cfg = configs[1]
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, synthesis_kernel=kernel))
    ops = _ops(X.export_sampler(cfg, gen, STAGE).graph_module)
    assert ops.count(SYNTH_OP) == (0 if kernel == "xla" else 1)


def test_conv_kernel_stays_in_an_exported_graph():
    """K2's operator traces as one node, and runs its plain version on the
    CPU."""
    class Conv(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.randn(8, 16, 3, 3))

        def forward(self, x):
            return conv3x3_same(x, self.weight)

    mod = Conv()
    x = torch.randn(2, 4, 16, 16)
    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(mod, (x,), dynamic_shapes=({0: b},),
                             strict=False)
    assert "gansynth_torch.conv3x3.default" in _ops(ep.graph_module)
    y = torch.randn(3, 4, 16, 16)
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(y),
                                   conv3x3_plain(y, mod.weight),
                                   rtol=0, atol=0)


def test_generator_epilogue_stays_in_an_exported_graph(configs, gen):
    """Each generator block's two epilogues (K4) trace as one
    ``gansynth_torch::gen_epilogue`` node each; on the CPU the node runs
    the plain chain (the artifact's roundtrip above holds its values)."""
    ops = _ops(X.export_sampler(configs[1], gen, STAGE).graph_module)
    assert ops.count("gansynth_torch.gen_epilogue.default") == 2 * (STAGE + 1)


def test_static_batch_rejects_other_sizes(configs, gen, tmp_path):
    path = X.save_sampler_artifact(str(tmp_path / "static.gsx"), configs[1],
                                   gen, step=1, stage=STAGE, batch=2)
    loaded = X.load_sampler_artifact(path, "cpu")
    assert loaded.meta["batch"] == 2
    assert loaded([0, 1], [60, 60]).shape == (2, 64000)
    with pytest.raises(Exception):
        loaded([0, 1, 2], [60, 60, 60])


def test_mismatched_seed_pitch_shapes_raise(loaded):
    with pytest.raises(ValueError, match="must match"):
        loaded(np.arange(2, dtype=np.int32), np.full((3,), 60, np.int32))
    with pytest.raises(ValueError, match="rank-1"):
        loaded(np.zeros((2, 2), np.int32), np.zeros((2, 2), np.int32))


def _rewrite_header(src, dst, mutate):
    """Rewrite an artifact's JSON header through ``mutate(meta) -> meta``,
    keeping the program bytes as they are."""
    with open(src, "rb") as f:
        assert f.read(len(X.GSX_MAGIC)) == X.GSX_MAGIC
        (hlen,) = struct.unpack(">I", f.read(4))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        tail = f.read()
    header = json.dumps(mutate(meta), sort_keys=True).encode("utf-8")
    with open(dst, "wb") as f:
        f.write(X.GSX_MAGIC + struct.pack(">I", len(header)) + header + tail)
    return dst


def _cut(artifact, path, keep):
    with open(artifact, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(keep(blob))
    return path


@pytest.mark.parametrize("fault,match", [
    ("magic", "bad magic"),
    ("header", "truncated"),
    ("length", "exceeds file size"),
    ("program", "truncated"),
    ("version", "newer.*upgrade"),
    ("jax", "JAX package's artifact"),
    ("format", "unexpected format"),
])
def test_damaged_or_foreign_artifacts_are_refused(artifact, tmp_path, fault,
                                                  match):
    path = str(tmp_path / f"{fault}.gsx")
    m = len(X.GSX_MAGIC)
    if fault == "magic":
        with open(path, "wb") as f:
            f.write(b"not an artifact")
    elif fault == "header":
        _cut(artifact, path, lambda b: X.GSX_MAGIC + b[m:m + 2])
    elif fault == "length":
        _cut(artifact, path, lambda b: X.GSX_MAGIC
             + struct.pack(">I", 0xFFFFFFFF) + b[m + 4:])
    elif fault == "program":
        _cut(artifact, path, lambda b: b[:-64])
    else:
        change = {"version": {"version": 99},
                  "jax": {"format": "gansynth-tpu-exported-sampler",
                          "version": 2},
                  "format": {"format": "something-else"}}[fault]
        _rewrite_header(artifact, path, lambda meta: {**meta, **change})
    with pytest.raises(ValueError, match=match):
        X.load_sampler_artifact(path, "cpu")


def test_platforms_are_checked(configs, gen, artifact, tmp_path):
    with pytest.raises(ValueError, match="cpu"):
        X.save_sampler_artifact(str(tmp_path / "t.gsx"), configs[1], gen,
                                step=1, stage=STAGE, platforms=["tpu"])
    path = _rewrite_header(artifact, str(tmp_path / "cuda_only.gsx"),
                           lambda meta: {**meta, "platforms": ["cuda"]})
    with pytest.raises(ValueError, match="not for cpu"):
        X.load_sampler_artifact(path, "cpu")


def test_loading_needs_a_card_unless_asked_for_the_cpu(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        X.load_sampler_artifact(artifact)


def test_latent_program_matches_both_latent_samplers(configs, params, gen,
                                                     latent_artifact):
    loaded = X.load_sampler_artifact(latent_artifact, "cpu")
    assert loaded.has_latent
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 8)).astype(np.float32)
    labels = np.zeros((3, 61), np.float32)
    labels[np.arange(3), [0, 10, 20]] = 1.0
    labels[2, 21] = 0.5         # a soft label, as interpolate makes
    got = loaded.latent(z, labels).numpy()
    port, _ = make_latent_sampler(configs[1], gen, STAGE)(z, labels)
    assert _rel(port.numpy(), got) <= ROUNDTRIP_BAR
    want, _ = j_latent(configs[0], STAGE)(params, jnp.asarray(z),
                                          jnp.asarray(labels))
    _wave_bar(np.asarray(want), got)
    # the seeded program rides in the same file
    assert loaded([0, 1], [60, 60]).shape == (2, 64000)


def test_latent_shape_checks(loaded, latent_artifact):
    with pytest.raises(ValueError, match="no latent program"):
        loaded.latent(np.zeros((1, 8), np.float32),
                      np.zeros((1, 61), np.float32))
    both = X.load_sampler_artifact(latent_artifact, "cpu")
    with pytest.raises(ValueError, match="rank-2"):
        both.latent(np.zeros((8,), np.float32), np.zeros((61,), np.float32))
    with pytest.raises(ValueError, match="rank-2"):
        both.latent(np.zeros((2, 8), np.float32),
                    np.zeros((3, 61), np.float32))


def test_with_latent_size_budget(artifact, latent_artifact):
    """Each program carries its own weights and synthesis constants."""
    seeded = os.path.getsize(artifact)
    both = os.path.getsize(latent_artifact)
    assert 1.3 * seeded < both < 3.0 * seeded


@pytest.mark.parametrize("seeds", [
    [0, 1, -1, 2 ** 31 - 1, -2 ** 31],
    np.random.default_rng(7).integers(-2 ** 31, 2 ** 31, 64).tolist(),
])
def test_in_graph_latents_equal_the_host_draw(seeds):
    """The uniform bits equal the host's bit for bit, and so do the
    normals on the CPU (both round log1p from float64), eagerly and
    inside an exported program with a symbolic batch."""
    class Draw(torch.nn.Module):
        def forward(self, s):
            return seeded_latents_torch(s, 256)

    want = seeded_latents(seeds, 256)
    s = torch.tensor(seeds, dtype=torch.int64).to(torch.int32)
    got = seeded_latents_torch(s, 256).numpy()
    np.testing.assert_array_equal(got, want)
    b = torch.export.Dim("b", min=1)
    ex = torch.zeros(2, dtype=torch.int32)
    ep = torch.export.export(Draw(), (ex,), dynamic_shapes=({0: b},),
                             strict=False)
    np.testing.assert_array_equal(ep.module()(s).numpy(), want)
    # the uniform bits the normals come from, for the first seed
    assert seed_to_key(seeds[0]) == (0, seeds[0] & 0xFFFFFFFF)
    np.testing.assert_array_equal(
        random_bits(seed_to_key(seeds[0]), (256,)).view(np.int32),
        _torch_bits(s[:1]))


def test_normals_agree_across_libraries_for_every_uniform():
    """Every (-1, 1) uniform the draw can make (one in four of its 2^23
    mantissas), through numpy's and torch's normal transforms: equal to
    the bit, as they are only when neither rests on a float32 function
    that is not correctly rounded (numpy's ``log1p``, which changes with
    the host's vector units; torch's ``sqrt`` on the CPU)."""
    from gansynth_tpu_torch.synth.random import (
        _erfinv_f32,
        _erfinv_f32_torch,
        uniform_from_bits,
    )

    bits = (np.arange(0, 1 << 23, 4, dtype=np.uint32) << np.uint32(9))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_from_bits(bits, lo, np.float32(1.0))
    want = _erfinv_f32(u)
    got = _erfinv_f32_torch(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


def _torch_bits(seed):
    from gansynth_tpu_torch.synth.random import _threefry2x32_torch

    k1 = seed.to(torch.int64).reshape(-1, 1) & 0xFFFFFFFF
    lo = torch.arange(256, dtype=torch.int64)
    y0, y1 = _threefry2x32_torch(torch.zeros_like(k1), k1,
                                 torch.zeros_like(lo), lo)
    return (y0 ^ y1)[0].numpy().astype(np.uint32).view(np.int32)


def _clear_constant_caches():
    for cache in (spectral._device_constants, spectral._analysis_constants,
                  K1._device_taps):
        cache.cache_clear()


def test_export_first_leaves_real_constants(configs, gen):
    """An export that is the first caller of the constant caches must not
    leave traced tensors in them: the eager sampler afterwards returns a
    plain tensor, equal to its wave before any export."""
    sample = make_seeded_sampler(configs[1], gen, STAGE)
    _clear_constant_caches()
    before = sample([5, 6], [40, 70])
    _clear_constant_caches()
    X.export_sampler(configs[1], gen, STAGE)
    after = sample([5, 6], [40, 70])
    assert type(after) is torch.Tensor
    assert float(after.abs().max()) > 0        # float() of a traced one fails
    np.testing.assert_array_equal(after.numpy(), before.numpy())
    for consts in (spectral._device_constants(configs[1].audio,
                                              torch.device("cpu")),
                   K1._device_taps(configs[1].audio, torch.device("cpu"))[:3]):
        assert all(type(c) is torch.Tensor for c in consts)


def test_constants_made_in_inference_mode_serve_autograd(configs):
    """A sampler (inference mode) that fills the caches first must not
    leave inference tensors, which autograd refuses to save, to a caller
    that records gradients."""
    audio = configs[1].audio
    _clear_constant_caches()
    with torch.inference_mode():
        spectral.mel_pinv(audio, "cpu")
    x = torch.randn(2, 1024, requires_grad=True)
    (x @ spectral.mel_pinv(audio, "cpu")).sum().backward()
    assert x.grad.shape == (2, 1024)


def test_cli_export_model_check(params, tmp_path, capsys):
    """``export-model --with-latent --check`` on an archived run (ema.npz,
    no checkpoint) writes ``<model-dir>/sampler.gsx`` and holds its waves
    to the in-process sampler's; a platform other than cpu and cuda is a
    usage error."""
    run = tiny.make_run(str(tmp_path / "run"), params)
    rc = cli.main(["export-model", "--model-dir", run, "--with-latent",
                   "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    rel = float(out.split("relative L2 err vs in-process sampler: ")[1]
                .split()[0])
    print(f"export-model --check measured {rel:.3g} (bound 1e-3)")
    assert rel <= ROUNDTRIP_BAR
    loaded = X.load_sampler_artifact(os.path.join(run, "sampler.gsx"), "cpu")
    assert (loaded.step, loaded.stage) == (tiny.STEP, tiny.NPZ_STAGE)
    assert loaded.has_latent
    for platforms in ("cpu,tpu", "tpu", ","):
        assert cli.main(["export-model", "--model-dir", run, "--device",
                         "cpu", "--platforms", platforms]) == 2
