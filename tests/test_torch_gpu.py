"""Card-only tests of the port: each CUDA kernel against its plain version,
an exported sampler that launches K1 from its program, the CUDA
graphs of the serving rungs, the keyed samplers and the training
superstep (on one card, and in an NCCL group of one rank) against the
same work run eagerly, and the training step's mark kernels: their
totals, and the phases a profiler's trace of a graphed superstep shows
between them.

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
f32 and round once to bf16, whose ulp is 2**-8 of the value). K4 is held
to the chain it replaces in ulps of the result's type (see its test). K5's
forward is held to the chain to the bit, its contract and expand kernels
to their plain versions in ulps, and the critic's penalty gradient
through it to the critic's float64 one (``ROUTE_MARGIN``). K6's weight
gradients are held to the float64 sum of the same bf16 inputs, at most
``ROUTE_MARGIN`` times as far as cuDNN's bf16 ones.
"""

import dataclasses
import math
import time

import pytest
import torch

from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import launch_counts
from gansynth_tpu_torch.kernels import synthesis as K
from gansynth_tpu_torch.ops import spectral as tspec
from gansynth_tpu_torch.utils.config import AudioConfig
from gansynth_tpu_torch.utils.device import slope_in

CFG = AudioConfig()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from gansynth_tpu_torch.utils.device import set_precision

    set_precision()
    return torch.device("cuda")


def _since(before):
    """``launch_counts()`` less ``before``, an earlier ``launch_counts()``."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}


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
    before = launch_counts()
    re, im = K.synthesis_spectrum(x, CFG)
    torch.cuda.synchronize()
    assert _since(before)["synthesis_spectrum"] == 1
    pre, pim = K.synthesis_spectrum_plain(x, CFG)
    torch.testing.assert_close(re, pre, rtol=0, atol=2e-2)
    torch.testing.assert_close(im, pim, rtol=0, atol=2e-2)
    _wave_bar(tspec.istft_rect(pre, pim, CFG), tspec.istft_rect(re, im, CFG))


@pytest.mark.gpu
def test_image_to_wave_takes_the_kernel_on_cuda(cuda_device):
    x = _image(2, cuda_device, 7)
    before = launch_counts()
    got = tspec.image_to_wave(x, CFG)
    assert _since(before)["synthesis_spectrum"] == 1
    plain = tspec.image_to_wave(
        x, dataclasses.replace(CFG, synthesis_kernel="xla"))
    assert _since(before)["synthesis_spectrum"] == 1
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
    before = launch_counts()
    y = K2.conv3x3_same(x, wt)
    gx, gw = torch.autograd.grad((y * r).sum(), (x, wt))
    torch.cuda.synchronize()
    launched = _since(before)
    assert launched["conv3x3_forward"] == 1
    assert launched["conv3x3_input_grad"] == 1
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
    before = launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        K2.conv3x3_same(x, wt)
    assert launch_counts() == before


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
    both directions; C1 = 72 leaves the second 64-channel pass partial.
    The first order (grad mode off) runs from what the forward kept. In
    float32 it is held to autograd of the chain. In bf16 it differentiates
    the kernel's own forward, whose float32 z1 differs in sign from the
    chain's rounded one at ties (bounded in
    ``test_dblock_saving_forward_keeps_a0_and_mask``), where one element's
    gradient moves by (1 - slope) of itself; so both bf16 routes, the
    kernel's and autograd of the bf16 chain, are held to the chain's
    gradients in float64 (:func:`_no_further_from_truth`)."""
    b, h, w, c1 = shape
    args = _dblock_inputs(cuda_device, b, h, w, c1, dtype)
    for a in args:
        a.requires_grad_()
    r = _rand((b, h // 2, w // 2, c1), cuda_device, 20, dtype)
    before = launch_counts()
    y = K3.fused_dblock(*args, 0.2)
    g = torch.autograd.grad((y * r).sum(), args)
    torch.cuda.synchronize()
    assert _since(before)["dblock"] == 1
    y_p = K3.dblock_plain(*args, 0.2)
    g_p = torch.autograd.grad((y_p * r).sum(), args)
    _close(y, y_p, 1e-5 if dtype == torch.float32 else 3e-2)
    if dtype == torch.float32:
        # explicit adjoints against autograd of the chain: the same cuDNN
        # convs
        for a, b_ in zip(g, g_p):
            _close(a, b_, 1e-4)
    else:
        _no_further_from_truth(g, g_p, _float64_grads(args, r))


# K3's kernel route's bf16 gradients may lie at most ROUTE_MARGIN times
# as far from the float64 gradients as the plain bf16 route's, by
# relative L2 error. Both routes round g_z1 and g_z0 alike, which
# dominates the bias gradients' error, so their ratio lies near 1; the
# 10 % takes the ties where the two routes' masks differ, while a wrong
# mask or a0 moves an element by (1 - slope) of its gradient.
ROUTE_MARGIN = 1.1


def _float64_grads(args, g, slope=0.2):
    """The chain's gradients for the gradient ``g`` of y, in float64 at
    the values the bf16 routes compute with: x and g as they are, the
    weights and biases rounded to x's type, the slope in x's type. Nothing
    of the kernel under test."""
    dt = args[0].dtype
    xs = [a.detach().to(dt).double().requires_grad_() for a in args]
    y = K3.dblock_plain(*xs, slope_in(dt, slope))
    return torch.autograd.grad(y, xs, g.double())


def _rel_l2(got, want):
    return float((got.double() - want).norm() / want.norm())


def _no_further_from_truth(got, plain, truth):
    """Each of the kernel route's five gradients (dx, dk0, db0, dk1, db1)
    has a relative L2 error against the float64 gradients of at most
    ROUTE_MARGIN times the plain route's."""
    for i, (a, p, t) in enumerate(zip(got, plain, truth)):
        err, err_plain = _rel_l2(a, t), _rel_l2(p, t)
        assert err <= ROUTE_MARGIN * err_plain, (
            f"input {i}: relative L2 error {err:.4e} > {ROUTE_MARGIN} * "
            f"the plain route's {err_plain:.4e}")


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


# K3's backward from what its forward keeps: the flagship's shape and a
# ragged one (20 x 40 spills into a second bf16 tile in both directions,
# C1 = 72 leaves conv1's second pass partial).
K3_SAVE_SHAPES = [(8, 128, 1024, 128), (1, 20, 40, 72)]
_FWD_BAR = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
_GRAD_BAR = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
_TIES = {torch.float32: 1e-5, torch.bfloat16: 2e-3}   # bf16 reads 9e-4


def _kept(device, shape, dtype):
    """x, k0, b0, k1, b1, the saving forward's (y, a0, mask), and a pooled
    gradient g."""
    b, h, w, c1 = shape
    args = _dblock_inputs(device, b, h, w, c1, dtype)
    kept = K3._launch(*args, 0.2, True)
    g = _rand((b, h // 2, w // 2, c1), device, 21, dtype)
    return args, kept, g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SAVE_SHAPES)
def test_dblock_saving_forward_keeps_a0_and_mask(cuda_device, dtype, shape):
    """The saving instance's y is the plain instance's to the bit; its a0
    is the chain's at the forward's bar, and its z1 >= 0 bits the chain's
    except at ties: where they differ, the chain's |z1| lies within the
    forward's bar of z1's scale (the kernel tests its float32 sum plus
    b1, the chain its own sum in its type), on at most 1e-5 of the
    elements in float32, 2e-3 in bf16 (where the chain rounds the conv
    and the bias add, and a0 by one ulp here and there)."""
    args, (y, a0, mask), _ = _kept(cuda_device, shape, dtype)
    y_plain, none_a0, none_mask = K3._launch(*args, 0.2, False)
    torch.cuda.synchronize()
    assert none_a0 is None and none_mask is None
    assert torch.equal(y, y_plain)
    _, a0_p, _ = K3.dblock_saving_plain(*args, 0.2)
    _close(a0, a0_p, _FWD_BAR[dtype])
    c1 = shape[-1]
    assert mask.shape == (*shape[:3], K3.mask_bytes(c1))
    x, k0, b0, k1, b1 = args
    z1 = (torch.nn.functional.conv2d(a0_p.permute(0, 3, 1, 2), k1.to(dtype),
                                     padding=1)
          + b1.to(dtype)[:, None, None]).permute(0, 2, 3, 1).float()
    assert not K3.unpack_mask(mask, 8 * mask.shape[-1])[..., c1:].any()
    ties = K3.unpack_mask(mask, c1) != (z1 >= 0)
    assert int(ties.sum()) <= _TIES[dtype] * z1.numel()
    if bool(ties.any()):
        scale = max(1.0, float(z1.abs().max()))
        assert float(z1[ties].abs().max()) <= _FWD_BAR[dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SAVE_SHAPES)
def test_dblock_backward_kernels_equal_their_plain_formulas(cuda_device,
                                                            dtype, shape):
    """Given the kept a0 and mask, the spread and mask kernels give the
    plain formulas' g_z1 and g_z0 to the bit; their bias gradients
    (float32 sums in another order, rounded to the type) within 1 ulp
    and 1e-5 of the sum of |g_z|."""
    _, (_, a0, mask), g = _kept(cuda_device, shape, dtype)
    g_a0 = _rand(a0.shape, cuda_device, 22, dtype)
    for got, want in ((K3._spread(g, mask, 0.2, True),
                       K3.spread_plain(g, mask, 0.2)),
                      (K3._mask_grad(a0, g_a0, 0.2, True),
                       K3.mask_grad_plain(a0, g_a0, 0.2))):
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert got[1].dtype == torch.float32
        assert torch.equal(got[1].to(dtype).float(), got[1])
        _within_ulps(got[1].to(dtype), want[1].to(dtype), 1,
                     1e-5 * want[0].float().abs().sum((0, 1, 2)))
    # without the bias gradient: the same g_z, no partials
    g_z1, none = K3._spread(g, mask, 0.2, False)
    assert none is None and torch.equal(g_z1, K3.spread_plain(g, mask)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SAVE_SHAPES)
def test_dblock_kernel_backward_matches_the_plain_adjoints(cuda_device,
                                                           dtype, shape):
    """A first-order backward (grad mode off) takes the kernels, once; dx,
    dk0, db0, dk1 and db1 match ``dblock_backward_plain`` (the chain
    recomputed) at the K3 card tests' bar in float32; in bf16 each lies
    at most ROUTE_MARGIN times as far from the chain's float64 gradients
    as the plain route's, as ``test_dblock_matches_plain`` holds them."""
    b, h, w, c1 = shape
    args = _dblock_inputs(cuda_device, b, h, w, c1, dtype)
    for a in args:
        a.requires_grad_()
    g = _rand((b, h // 2, w // 2, c1), cuda_device, 21, dtype)
    before = launch_counts()
    got = torch.autograd.grad(K3.fused_dblock(*args, 0.2), args, g)
    torch.cuda.synchronize()
    launched = _since(before)
    assert launched["dblock_backward"] == 1
    assert launched["dblock_backward_plain"] == 0
    with torch.no_grad():
        want = K3.dblock_backward_plain(*[a.detach() for a in args], g)
    if dtype == torch.float32:
        for a, b_ in zip(got, want):
            _close(a, b_, _GRAD_BAR[torch.float32])
    else:
        _no_further_from_truth(got, want, _float64_grads(args, g))


@pytest.mark.gpu
def test_dblock_odd_width_takes_the_plain_backward(cuda_device):
    """A C1 that is no multiple of 8 passes K3's gate; on the card its
    forward is the kernel's and keeps nothing, and its first-order
    backward takes ``dblock_backward_plain``, counted as plain."""
    args = _dblock_inputs(cuda_device, 1, 20, 40, 100, torch.bfloat16)
    for a in args:
        a.requires_grad_()
    g = _rand((1, 10, 20, 100), cuda_device, 21, torch.bfloat16)
    before = launch_counts()
    got = torch.autograd.grad(K3.fused_dblock(*args, 0.2), args, g)
    torch.cuda.synchronize()
    launched = _since(before)
    assert launched["dblock"] == 1
    assert launched["dblock_backward"] == 0
    assert launched["dblock_backward_plain"] == 1
    with torch.no_grad():
        want = K3.dblock_backward_plain(*[a.detach() for a in args], g)
    for a, b_ in zip(got, want):
        _close(a, b_, _GRAD_BAR[torch.bfloat16])


@pytest.mark.gpu
def test_dblock_backward_graph_replay_equals_eager(deterministic_cudnn):
    """K3's kernel-path backward (its bias sums included) captured in a
    CUDA graph gives the eager run's bits at every replay, at the
    flagship's shape in bf16: no atomics in the kernels, cuDNN on its
    deterministic algorithms."""
    from gansynth_tpu_torch.utils import graphs

    args, (_, a0, mask), g = _kept(deterministic_cudnn, K3_SAVE_SHAPES[0],
                                   torch.bfloat16)

    def run():
        return K3.dblock_backward_saved(*args, a0, mask, g)

    want = run()
    graph = graphs.Graph(run, deterministic_cudnn)
    for _ in range(3):
        got = graph.replay()
        torch.cuda.synchronize()
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)


@pytest.mark.gpu
def test_a_step_takes_k3s_backward_by_route(cuda_device):
    """A 3-step cached superstep at the flagship's widths (stage 6, batch
    2, bf16): each step runs K3's forward 4 times (real, fake, the
    interpolates, the generator update's fake) and its backward 5 times,
    4 through the kernels and 1 (the penalty's ``create_graph`` call)
    through the plain adjoints, eagerly and in each replay of the step's
    graph, by the counters and by name in a profiler trace of the
    replays: 4 spreads, 4 mask kernels and 8 bias sums a step (every
    pass takes both biases' gradients)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.kernels import launch_counts
    from gansynth_tpu_torch.train.step import make_cached_superstep

    config, state, waves, pitches = _flagship_width_state(cuda_device,
                                                          False)
    alphas = [1.0] * 3
    keys = ("dblock", "dblock_backward", "dblock_backward_plain")
    want = dict(zip(keys, (4, 4, 1)))
    eager = make_cached_superstep(config, 6, 6, graphs=False)
    before = launch_counts()
    eager(copy.deepcopy(state), waves, pitches, alphas)
    torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    graphed = make_cached_superstep(config, 6, 6)
    graphed(state, waves, pitches, alphas)   # the capture
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(state, waves, pitches, alphas)
        torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for part, n in (("dblock_nhwc_bf16_wgmma", 4),
                    ("dblock_grad_spread_bf16", 4),
                    ("dblock_grad_mask_bf16", 4),
                    ("dblock_grad_bias_sum_bf16", 8)):
        assert sum(part in name for name in names) == 3 * n, part


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
    before = launch_counts()
    with torch.no_grad():
        got = g(torch.from_numpy(d["z"]).to(cuda_device),
                torch.from_numpy(d["labels"]).to(cuda_device),
                int(d["stage"]), 1.0)
    torch.cuda.synchronize()
    launched = _since(before)["conv3x3_forward"]
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
    before = launch_counts()
    got = on_card(seeds, pitch)
    torch.cuda.synchronize()
    # the rung's first call: a warm-up batch, then the captured graph's
    # replay (utils/graphs.py), one launch each
    assert _since(before)["synthesis_spectrum"] == 2
    want = make_seeded_sampler(config, gen, 2)(seeds, pitch)
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-3
    on_cpu = load_sampler_artifact(path, "cpu")
    cpu = on_cpu(seeds, pitch)
    assert cpu.device.type == "cpu"
    # two more from the in-process sampler's first call, none from the CPU
    assert _since(before)["synthesis_spectrum"] == 4
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
            before = launch_counts()
            got = sample(seeds, pitches)
            assert _since(before)["synthesis_spectrum"] == 1
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
    before = launch_counts()
    got = graphed(key, pitches)
    torch.cuda.synchronize()
    assert _since(before)["synthesis_spectrum"] == 1
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


@pytest.mark.gpu
def test_step_marks_count_on_the_device_and_in_a_graph(cuda_device):
    """The five mark kernels: the first start adds nothing, every later
    mark adds to its phase, end counts the step; the anchor adds nothing
    and the next start counts from it; captured in a CUDA graph they run
    at every replay."""
    from gansynth_tpu_torch.kernels import marks

    totals = marks.new_totals(cuda_device)
    spin = torch.ones((1024, 1024), device=cuda_device)
    for m in range(len(marks.MARKS)):
        spin = spin @ spin / 1024   # device time between two marks
        marks.step_mark(totals, m)
    got = totals.tolist()
    assert got[marks.STEPS] == 1 and got[marks.LAST] > 0
    assert got[marks.PHASES.index("between")] == 0
    assert all(got[i] > 0 for i in range(4))
    time.sleep(0.02)   # the card idles
    marks.step_mark(totals, marks.ANCHOR)
    anchored = totals.tolist()
    assert anchored[:marks.LAST] == got[:marks.LAST]
    assert anchored[marks.LAST] - got[marks.LAST] >= 20_000_000
    marks.step_mark(totals, 0)   # a start counts from the anchor
    got = totals.tolist()
    assert 0 < got[marks.PHASES.index("between")] < 2_000_000
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            for m in range(len(marks.MARKS)):
                marks.step_mark(totals, m)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert totals.tolist() == got   # a capture runs nothing
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    after = totals.tolist()
    assert after[marks.STEPS] == 4
    assert all(after[i] > got[i] for i in range(5))


@pytest.mark.gpu
def test_the_traced_phases_are_the_device_totals(cuda_device):
    """A graphed 3-step cached superstep at the flagship's widths, queued
    behind another as the training loop runs it: over the second, each
    phase's time between the mark kernels' starts in the profiler's trace
    matches the program's totals (critic and generator within 2 %, the
    rest within 20 us a step); K2's record by shape holds as many
    launches as the trace has K2 kernels, 3 steps' worth of the wrappers'
    counts. The totals are copied on the stream between the two
    supersteps, so the host waits for neither."""
    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.kernels import launch_counts, launch_shapes, marks
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.profiling import mark_spans, port_kernel

    config, state, waves, pitches = _flagship_width_state(cuda_device,
                                                          False)
    alphas = [1.0] * 3
    graphed = make_cached_superstep(config, 6, 6)
    graphed(state, waves, pitches, alphas)   # the capture
    torch.cuda.synchronize()
    totals = graphed.program.phases.totals
    before, after = (torch.empty(totals.shape, dtype=totals.dtype,
                                 pin_memory=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(state, waves, pitches, alphas)
        before.copy_(totals, non_blocking=True)
        shapes, counts = launch_shapes(), launch_counts()
        graphed(state, waves, pitches, alphas)
        after.copy_(totals, non_blocking=True)
        torch.cuda.synchronize()
    delta = (after - before).tolist()
    assert delta[marks.STEPS] == 3
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks_seen = [e for e in events if "step_mark_" in e.name]
    # the second superstep's marks and the first one's last end mark, in
    # the marks' order; taken from the trace's end, since a profiler
    # started in a process that has traced before can miss the first
    # superstep's first kernels
    assert len(marks_seen) <= 2 * 3 * 5
    assert [next(m for m in marks.MARKS if f"step_mark_{m}" in e.name)
            for e in marks_seen[-16:]] == ["end", *marks.MARKS * 3]
    # the second superstep's marks and the first one's last end mark
    traced = mark_spans(marks_seen[-16:])
    for phase, us in traced.items():
        device_us = delta[marks.PHASES.index(phase)] / 1e3
        if phase in ("critic", "generator"):
            assert us == pytest.approx(device_us, rel=0.02), phase
        else:
            assert abs(us - device_us) <= 3 * 20.0, phase
    recorded = {k: v - shapes.get(k, 0) for k, v in launch_shapes().items()
                if v != shapes.get(k, 0)}
    second = [e for e in events if e.time_range.start
              >= marks_seen[-15].time_range.start]
    k2 = sum(port_kernel(e.name) == "conv3x3" for e in second)
    assert sum(recorded.values()) == k2 > 0
    wrappers = sum(launch_counts()[k] - counts[k] for k in
                   ("conv3x3_forward", "conv3x3_input_grad",
                    "conv3x3_recompute"))
    assert wrappers == k2
    assert all(len(k) == 6 and k[0] in ("forward", "input_grad")
               for k in recorded)


@pytest.mark.gpu
def test_the_traced_between_holds_across_a_host_held_gap(cuda_device):
    """The host syncs, reads the totals and sleeps while the card idles,
    as between a loop's log read and its next superstep: each step's
    ``between`` from the totals matches the trace's gap from the end
    mark's start to the next start mark's within 5 us (an idle card keeps
    both clocks together: 0.8 us apart after 300 ms)."""
    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.kernels import marks

    between = marks.PHASES.index("between")
    totals = marks.new_totals(cuda_device)
    spin = torch.ones((1024, 1024), device=cuda_device)
    gaps = (0.0005, 0.007, 0.02)
    read = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for gap in (0.0, *gaps):
            read.append(totals.tolist()[between])   # syncs
            time.sleep(gap)
            for m in range(len(marks.MARKS)):
                marks.step_mark(totals, m)
                spin = spin @ spin / 1024
        torch.cuda.synchronize()
    read.append(totals.tolist()[between])
    cuda = torch.autograd.DeviceType.CUDA
    seen = sorted((e for e in prof.events() if e.device_type == cuda
                   and "step_mark_" in e.name),
                  key=lambda e: e.time_range.start)
    # the last len(gaps) starts and the ends before them (the first
    # step, which has no gap, may lose kernels as the profiler starts)
    starts = [e for e in seen if "step_mark_start" in e.name][-len(gaps):]
    ends = [e for e in seen if "step_mark_end" in e.name][-len(gaps) - 1:]
    assert len(starts) == len(ends) - 1 == len(gaps)
    for i, gap in enumerate(gaps, 1):
        device_us = (read[i + 1] - read[i]) / 1e3
        traced_us = (starts[i - 1].time_range.start
                     - ends[i - 1].time_range.start)
        assert device_us >= 1e6 * gap
        assert abs(traced_us - device_us) <= 5.0, (gap, traced_us,
                                                   device_us)


# K4 at the seven epilogue shapes of the stage-6 step at batch 8 (each
# block's two convs share one): [B, H, W, C].
K4_SHAPES = [(8, 2, 16, 256), (8, 4, 32, 256), (8, 8, 64, 256),
             (8, 16, 128, 256), (8, 32, 256, 256), (8, 64, 512, 128),
             (8, 128, 1024, 64)]
K4_ULPS = {torch.bfloat16: 1, torch.float32: 8}


def _ulp(x, dtype):
    """The spacing of ``dtype`` at |x| (x in float32)."""
    _, e = torch.frexp(x.float().abs())
    return torch.finfo(dtype).eps * torch.exp2((e - 1).float())


def _within_ulps(got, want, ulps, atol=0.0):
    """Elementwise within ``ulps`` units in the last place of the larger
    of the two, plus ``atol``."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    err = (got.float() - want.float()).abs()
    bad = err > ulps * _ulp(big, want.dtype) + atol
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()))


def _k4_inputs(shape, dtype, device):
    gen = torch.Generator(device=device).manual_seed(shape[1] * 31 + 7)
    z = (2 * torch.randn(shape, generator=gen, device=device)).to(dtype)
    bias = 0.5 * torch.randn(shape[-1], generator=gen, device=device)
    g = torch.randn(shape, generator=gen, device=device).to(dtype)
    return z, bias, g


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_gen_epilogue_matches_plain(cuda_device, dtype, shape):
    """K4 against the chain it replaces (autograd through the plain ops on
    the card): the output and the pixel norm's adjoint dx within 1 bf16
    ulp (8 in float32: the pixel norm's sums run in another order), dx
    also within 2**-16 of its row's largest value where the adjoint's
    two terms cancel. dz is dx where the LeakyReLU passes it and
    round(dx * slope) where it scales it, so there it may also differ
    by the slope times dx's ulp and one ulp of its own rounding. The
    bias gradient within 1 ulp and 1e-5 of its sum of |dz| (float32 sums
    over the rows in another order). The plain version of the kernel's
    backward is held to the kernel the same way."""
    from gansynth_tpu_torch.kernels import gen_epilogue as K4

    z, bias, g = _k4_inputs(shape, dtype, cuda_device)
    before = launch_counts()
    grads = []
    for fn in (K4.gen_epilogue, K4.gen_epilogue_plain):
        zr, br = z.clone().requires_grad_(), bias.clone().requires_grad_()
        y = fn(zr, br, 0.2, 1e-8)
        y.backward(g)
        grads.append((y.detach(), zr.grad, br.grad))
    torch.cuda.synchronize()
    assert {k: v for k, v in _since(before).items()
            if k.startswith("gen_epilogue_")} == {
        "gen_epilogue_forward": 1, "gen_epilogue_backward": 1,
        "gen_epilogue_recompute": 0}
    (y, dz, db), (yp, dzp, dbp) = grads
    ulps = K4_ULPS[dtype]
    _within_ulps(y, yp, ulps)
    slope = slope_in(dtype, 0.2)
    passed = (z + bias.to(dtype)) > 0
    dx = torch.where(passed, dzp.float(), dzp.float() / slope)
    cancel = 2.0 ** -16 * dx.abs().amax(-1, keepdim=True)
    scaled = slope * ulps * _ulp(dx, dtype) + _ulp(dzp, dtype)
    cancel = torch.where(passed, cancel, slope * cancel + scaled)
    _within_ulps(dz, dzp, ulps, cancel)
    assert db.dtype == dbp.dtype == torch.float32
    db_t, dbp_t = db.to(dtype), dbp.to(dtype)
    assert torch.equal(db_t.float(), db) and torch.equal(dbp_t.float(), dbp)
    _within_ulps(db_t, dbp_t, 1,
                 1e-5 * dzp.float().abs().sum(dim=(0, 1, 2)))
    dz_plain, db_plain = K4.gen_epilogue_backward_plain(z, bias, g)
    _within_ulps(dz, dz_plain, ulps, cancel)
    _within_ulps(db.to(dtype), db_plain.to(dtype), 1,
                 1e-5 * dzp.float().abs().sum(dim=(0, 1, 2)))


@pytest.mark.gpu
def test_gen_epilogue_graph_replay_equals_eager(cuda_device):
    """K4's forward and backward (bias gradient included) captured in a
    CUDA graph give an eager run's bits at every replay: the bias
    gradient's partial sums are added in a fixed order, without atomics.
    The capture's launches are taken back and each replay adds them."""
    from gansynth_tpu_torch.kernels import gen_epilogue as K4
    from gansynth_tpu_torch.kernels import gen_epilogue_shapes
    from gansynth_tpu_torch.utils import graphs

    shape = (8, 64, 512, 128)
    z, bias, g = _k4_inputs(shape, torch.bfloat16, cuda_device)

    def run():
        y = K4._forward_cuda(z, bias, 0.2, 1e-8)
        return (y, *K4._backward_cuda(z, bias, g, 0.2, 1e-8, True))

    want = run()
    graph = graphs.Graph(run, cuda_device)
    assert graph.launches == {("gen_epilogue", "forward", *shape): 1,
                              ("gen_epilogue", "backward", *shape): 1}
    shapes = gen_epilogue_shapes()
    for _ in range(3):
        got = graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert gen_epilogue_shapes()[("backward", *shape)] \
        == shapes[("backward", *shape)] + 3
    again = run()
    for a, b in zip(again, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_step_launches_k4_at_every_generator_epilogue(cuda_device):
    """A 3-step cached superstep at the flagship's widths (stage 6, batch
    2, bf16): every step launches K4's forward 28 times (14 in the
    critic update's no-grad G, 14 in the generator update) and its
    backward 14 times, eagerly and in each replay of the step's graph, by
    the wrappers' counts, by shape (4 forward and 2 backward at each of
    the seven block shapes) and by name in a profiler trace of the
    replays (each backward with its bias sum). K4 takes its tensors as
    they come and refuses one it would have to copy (``_check``), so the
    step also shows that no ``.contiguous()`` copy stands in front of it."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.kernels import gen_epilogue_shapes, launch_counts
    from gansynth_tpu_torch.train.step import make_cached_superstep

    config, state, waves, pitches = _flagship_width_state(cuda_device,
                                                          False)
    alphas = [1.0] * 3
    keys = ("gen_epilogue_forward", "gen_epilogue_backward",
            "gen_epilogue_recompute")
    want = dict(zip(keys, (28, 14, 0)))
    eager = make_cached_superstep(config, 6, 6, graphs=False)
    before, shapes = launch_counts(), gen_epilogue_shapes()
    eager(copy.deepcopy(state), waves, pitches, alphas)
    torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    per_shape = {k: (v - shapes.get(k, 0)) / 3
                 for k, v in gen_epilogue_shapes().items()
                 if v != shapes.get(k, 0)}
    blocks = [(2, 2 << i, 16 << i, config.model.stage_channels(i))
              for i in range(7)]
    assert per_shape == {**{("forward", *b): 4 for b in blocks},
                         **{("backward", *b): 2 for b in blocks}}
    graphed = make_cached_superstep(config, 6, 6)
    graphed(state, waves, pitches, alphas)   # the capture
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(state, waves, pitches, alphas)
        torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for part, n in (("gen_epilogue_fwd_bf16", 28), ("gen_epilogue_bwd_bf16", 14),
                    ("gen_epilogue_bias_sum_bf16", 14)):
        assert sum(part in name for name in names) == 3 * n, part


# K5 at the stage-6 step's two fromRGB shapes, (B, H, W, C_in, C_out):
# from_rgb[6] at the critic's input, the fade-in skip's from_rgb[5].
K5_SHAPES = [(8, 128, 1024, 2, 64), (8, 64, 512, 2, 128)]


def _k5_inputs(shape, dtype, device, seed=30):
    """x, w, b, a gradient g of y and a dx, as the critic gives them: the
    image in [-1, 1], the scaled weight and the bias rounded to the
    type."""
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.rand((b, h, w, cin), generator=gen, device=device)
         - 1).to(dtype)
    wt = torch.randn((cout, cin), generator=gen, device=device).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=gen, device=device)).to(dtype)
    g = torch.randn((b, h, w, cout), generator=gen, device=device).to(dtype)
    dx = torch.randn((b, h, w, cin), generator=gen, device=device).to(dtype)
    return x, wt, bias, g, dx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_from_rgb_forward_is_the_chain_bit_for_bit(cuda_device, dtype,
                                                   shape):
    """K5's forward, through the layer (``EqualizedConv.lrelu``) and
    alone, equals the chain's ops on the card bit for bit, one launch
    each."""
    from gansynth_tpu_torch.kernels import from_rgb as K5
    from gansynth_tpu_torch.models.layers import EqualizedConv, leaky_relu

    x, wt, bias, _, _ = _k5_inputs(shape, dtype, cuda_device)
    before = launch_counts()
    y = K5.from_rgb_lrelu(x, wt, bias, 0.2)
    torch.cuda.synchronize()
    assert _since(before)["from_rgb_forward"] == 1
    assert torch.equal(y, K5.from_rgb_plain(x, wt, bias, 0.2))
    name = str(dtype).split(".")[-1]
    conv = EqualizedConv(shape[3], shape[4], kernel_size=(1, 1),
                         compute_dtype=name).to(cuda_device)
    with torch.no_grad():
        conv.bias.copy_(bias.float())
    image = x.float() + 0.001   # float32, as the critic's interpolates
    before = launch_counts()
    y = conv.lrelu(image, 0.2)
    torch.cuda.synchronize()
    assert _since(before)["from_rgb_forward"] == 1
    assert torch.equal(y, leaky_relu(conv(image), 0.2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_from_rgb_contract_and_expand_match_plain(cuda_device, dtype,
                                                  shape):
    """contract's (A, B, C) and expand (its three terms, and dx alone)
    against their plain versions (``from_rgb_contract_plain``,
    ``from_rgb_expand_plain``: the same mask, float32 sums in another
    order) within 1 ulp of the type and 1e-5 of the sum of the terms'
    magnitudes (expand, where the mask scales its sum, also by the slope
    times the sum's ulp and one ulp of the product's rounding); without
    A, B or C the same others."""
    from gansynth_tpu_torch.kernels import from_rgb as K5

    x, wt, bias, g, dx = _k5_inputs(shape, dtype, cuda_device)
    cout, cin = wt.shape
    got = K5._contract(g, x, wt, x, wt, bias, 0.2, (True, True, True))
    want = K5.from_rgb_contract_plain(g, x, wt, x, wt, bias, 0.2)
    gz = K5._masked(g, x, wt, bias, 0.2).float().abs()
    slack = (gz @ wt.float().abs(),
             gz.reshape(-1, cout).T @ x.float().abs().reshape(-1, cin),
             gz.reshape(-1, cout).sum(0))
    for a, p, s in zip(got, want, slack):
        assert a.dtype == dtype and a.shape == p.shape
        _within_ulps(a, p, 1, 1e-5 * s)
    a, gw, gb = K5._contract(g, x, wt, x, wt, bias, 0.2, (False, True, True))
    assert a is None and torch.equal(gw, got[1]) and torch.equal(gb, got[2])
    a, gw, gb = K5._contract(g, None, wt, x, wt, bias, 0.2,
                             (True, False, False))
    assert gw is None and gb is None and torch.equal(a, got[0])
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    dw = torch.randn((cout, cin), generator=gen, device=cuda_device).to(dtype)
    db = torch.randn(cout, generator=gen, device=cuda_device).to(dtype)
    x1 = torch.randn(x.shape, generator=gen, device=cuda_device).to(dtype)
    passed = K5._preact(x, wt, bias) > 0
    for args in ((dx, dw, db, x1, wt), (dx, None, None, None, wt)):
        e = K5._expand(*args, x, wt, bias, 0.2)
        p = K5.from_rgb_expand_plain(*args, x, wt, bias, 0.2)
        terms = dx.float().abs() @ wt.float().abs().T
        if args[1] is not None:
            terms = terms + x1.float().abs() @ dw.float().abs().T \
                + db.float().abs()
        # t within 1 ulp; where the mask scales it, round(t * slope)
        # differs by the slope times t's ulp and one ulp of its own
        t = torch.where(passed, p.float(), p.float() / slope_in(dtype, 0.2))
        scaled = torch.where(passed, 0.0, 0.2 * _ulp(t, dtype)
                             + _ulp(p, dtype))
        _within_ulps(e, p, 1, 1e-5 * terms + scaled)


def _penalty_grads(critic, x, stage=6):
    """The gradient of WGAN-GP's penalty at x for each of the critic's
    parameters that it reaches, by name."""
    from gansynth_tpu_torch.train import losses

    x_hat = x.detach().requires_grad_()
    gx, = torch.autograd.grad(critic(x_hat, stage, 1.0)[0].sum(), x_hat,
                              create_graph=True)
    params = dict(critic.named_parameters())
    penalty = losses.penalty_from_grads(
        gx.to(torch.promote_types(gx.dtype, torch.float32)))
    grads = torch.autograd.grad(penalty, list(params.values()),
                                allow_unused=True)
    return {k: g for k, g in zip(params, grads) if g is not None}


def _float64_twin(critic, slope):
    """The critic in float64 at the same parameters: every layer's
    compute type float64, the plain lowerings in place of K2 and K3 (K5
    takes neither type nor them), the LeakyReLU's slope the bf16 one."""
    import copy

    twin = copy.deepcopy(critic).double()
    twin.config = dataclasses.replace(twin.config, leaky_relu_slope=slope)
    for m in twin.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
        if hasattr(m, "conv_kernel"):
            m.conv_kernel = "xla"
        if hasattr(m, "dblock_kernel"):
            m.dblock_kernel = "xla"
        if hasattr(m, "lrelu_slope"):
            m.lrelu_slope = slope
    return twin


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_from_rgb_penalty_gradients_meet_the_route_margin(cuda_device,
                                                          dtype, monkeypatch):
    """The flagship-width critic's full penalty gradient at stage 6 (batch
    2, K2 and K3 on) through K5, whose create_graph call and double
    backward run contract and expand, and through the chain, in the
    type: each parameter's relative L2 error against the critic's float64
    gradient is at most ROUTE_MARGIN times the chain route's, and where
    that gradient is 0 (the fade-in skip's fromRGB at alpha 1) both
    routes' are 0. The forwards are equal to the bit, so the routes
    differ only in the fromRGB backwards."""
    from gansynth_tpu_torch.kernels import from_rgb as K5
    from gansynth_tpu_torch.models.discriminator import Discriminator
    from gansynth_tpu_torch.utils.config import ModelConfig

    config = ModelConfig(compute_dtype=dtype, conv_kernel="pallas",
                         dblock_kernel="pallas")
    critic = Discriminator(config, generator=torch.Generator().manual_seed(
        33)).to(cuda_device)
    with torch.no_grad():
        for name, p in critic.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(name))))
    x = _image(2, cuda_device, 34)
    before = launch_counts()
    route = _penalty_grads(critic, x)
    launched = _since(before)
    assert (launched["from_rgb_forward"], launched["from_rgb_contract"],
            launched["from_rgb_expand"]) == (2, 6, 2)
    with monkeypatch.context() as m:
        m.setattr(K5, "_on_card", lambda t: False)
        before = launch_counts()
        chain = _penalty_grads(critic, x)
        assert _since(before)["from_rgb_forward"] == 0
    truth = _penalty_grads(
        _float64_twin(critic, slope_in(getattr(torch, dtype), 0.2)),
        x.double())
    assert route.keys() == chain.keys() == truth.keys()
    assert {"from_rgb.6.weight", "from_rgb.5.bias"} <= route.keys()
    for k, t in truth.items():
        if float(t.norm()) == 0:
            assert float(route[k].norm()) == float(chain[k].norm()) == 0, k
            continue
        err, err_chain = _rel_l2(route[k], t), _rel_l2(chain[k], t)
        assert err <= ROUTE_MARGIN * err_chain, (
            f"{k}: relative L2 error {err:.4e} > {ROUTE_MARGIN} * the "
            f"chain's {err_chain:.4e}")


@pytest.mark.gpu
def test_from_rgb_graph_replay_equals_eager(cuda_device):
    """K5's forward, contract (A, B and C, its partial sums added in a
    fixed order, without atomics) and expand captured in a CUDA graph give
    an eager run's bits at every replay; the capture's launches are taken
    back and each replay adds them."""
    from gansynth_tpu_torch.kernels import from_rgb as K5
    from gansynth_tpu_torch.utils import graphs

    shape = K5_SHAPES[0]
    x, wt, bias, g, dx = _k5_inputs(shape, torch.bfloat16, cuda_device)

    def run():
        y = K5._forward(x, wt, bias, 0.2)
        return (y, *K5._contract(g, x, wt, x, wt, bias, 0.2,
                                 (True, True, True)),
                K5._expand(dx, None, None, None, wt, x, wt, bias, 0.2))

    want = run()
    graph = graphs.Graph(run, cuda_device)
    key = (*shape[:3], shape[4])
    assert graph.launches == {("from_rgb", role, *key): 1
                              for role in ("forward", "contract", "expand")}
    before = launch_counts()
    for _ in range(3):
        got = graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _since(before)["from_rgb_contract"] == 3


@pytest.mark.gpu
def test_a_step_launches_k5_at_both_fromrgbs(cuda_device):
    """A 3-step cached superstep at the flagship's widths (stage 6, batch
    2, bf16): every fromRGB call of a step runs through K5, none through
    the chain: at each of the two shapes 4 forwards, 6 contracts and 1
    expand a step (8, 12 and 2), eagerly and in each replay of the step's
    graph, by the record and by name in a profiler trace of the replays
    (each contract with its partials' sum: 34 from_rgb_ kernels a step)."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.kernels import record
    from gansynth_tpu_torch.train.step import make_cached_superstep

    config, state, waves, pitches = _flagship_width_state(cuda_device,
                                                          False)
    alphas = [1.0] * 3
    keys = ("from_rgb_forward", "from_rgb_contract", "from_rgb_expand")
    want = dict(zip(keys, (8, 12, 2)))
    eager = make_cached_superstep(config, 6, 6, graphs=False)
    before, rec = launch_counts(), record()
    eager(copy.deepcopy(state), waves, pitches, alphas)
    torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    per_shape = {k[1:]: (v - rec.get(k, 0)) / 3
                 for k, v in record().items()
                 if k[0] == "from_rgb" and v != rec.get(k, 0)}
    assert per_shape == {(role, *shape): n
                         for shape in ((2, 128, 1024, 64), (2, 64, 512, 128))
                         for role, n in (("forward", 4), ("contract", 6),
                                         ("expand", 1))}
    graphed = make_cached_superstep(config, 6, 6)
    graphed(state, waves, pitches, alphas)   # the capture
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(state, waves, pitches, alphas)
        torch.cuda.synchronize()
    assert {k: (launch_counts()[k] - before[k]) / 3 for k in keys} == want
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for part, n in (("from_rgb_fwd_bf16", 8), ("from_rgb_contract_bf16", 12),
                    ("from_rgb_sum_bf16", 12), ("from_rgb_expand_bf16", 2)):
        assert sum(part in name for name in names) == 3 * n, part


def _k6_layers(d=64):
    """(C_in, C_out, L) of the critic's six layers at d, L the conv's output
    length (the generator's six are the same, mirrored)."""
    from gansynth_tpu_torch.models import wavegan as wg
    from gansynth_tpu_torch.utils.config import ModelConfig

    chans = wg.widths(ModelConfig(wavegan_dim=d))
    return [(chans[i], chans[i + 1], wg.SLICE_LEN // wg.STRIDE ** (i + 1))
            for i in range(wg.LAYERS)]


K6_LAYERS = _k6_layers()   # at the benchmark's d = 64


def _k6_inputs(batch, c_in, c_out, length, device, seed=40):
    """bf16 x [B, C_in, 1, 4L] and gy [B, C_out, 1, L], channels-last."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for shape in ((batch, c_in, 1, 4 * length),
                      (batch, c_out, 1, length)))


def _cudnn_wgrad(x, gy):
    """cuDNN's weight gradient of the SAME conv (``F.conv2d``'s backward)
    in x's type."""
    from gansynth_tpu_torch.models import wavegan as wg

    w = torch.zeros(gy.shape[1], x.shape[1], 25, dtype=x.dtype,
                    device=x.device, requires_grad=True)
    y = torch.nn.functional.conv2d(wg._pad_length(x, 10, 11),
                                   w.unsqueeze(2), stride=(1, 4))
    return torch.autograd.grad(y, w, gy)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [64, 3])
@pytest.mark.parametrize("layer", K6_LAYERS)
def test_conv1d_wgrad_meets_the_route_margin(cuda_device, layer, batch):
    """K6's bf16 weight gradient at each WaveGAN layer's shape, at the
    benchmark's batch and at 3: its relative L2 error against the float64
    sum of the same bf16 inputs is at most ROUTE_MARGIN times cuDNN's
    bf16 weight gradient's. Both sum in float32 and round once to bf16,
    which dominates either error."""
    from gansynth_tpu_torch.kernels import conv1d_wgrad as K6

    x, gy = _k6_inputs(batch, *layer, cuda_device)
    before = launch_counts()
    got = K6.conv1d_wgrad(x, gy, "conv")
    assert _since(before)["conv1d_wgrad_conv"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (layer[1], layer[0],
                                                         25)
    truth = K6.conv1d_wgrad_plain(x.double(), gy.double())
    err, err_cudnn = _rel_l2(got, truth), _rel_l2(_cudnn_wgrad(x, gy), truth)
    assert err <= ROUTE_MARGIN * err_cudnn, (
        f"relative L2 error {err:.4e} > {ROUTE_MARGIN} * cuDNN's "
        f"{err_cudnn:.4e}")


@pytest.mark.gpu
@pytest.mark.parametrize("layer", [K6_LAYERS[0], K6_LAYERS[3]])
def test_a_float32_weight_gradient_takes_cudnn(cuda_device, layer):
    """K6 has no float32 form: a float32 call on the card (``compute_dtype``
    float32) takes cuDNN's weight gradient, as every call did before K6,
    launches no K6, and errs as the built-in backward's does."""
    from gansynth_tpu_torch.kernels import conv1d_wgrad as K6

    x, gy = (t.float() for t in _k6_inputs(3, *layer, cuda_device))
    before = launch_counts()
    got = K6.conv1d_wgrad(x, gy, "conv")
    assert not any(_since(before)[k] for k in ("conv1d_wgrad_conv",
                                               "conv1d_wgrad_transpose"))
    assert got.dtype == torch.float32
    truth = K6.conv1d_wgrad_plain(x.double(), gy.double())
    err, err_builtin = _rel_l2(got, truth), _rel_l2(_cudnn_wgrad(x, gy),
                                                    truth)
    assert err <= ROUTE_MARGIN * err_builtin + 1e-6, (err, err_builtin)


@pytest.mark.gpu
def test_conv1d_wgrad_graph_replays_are_bit_equal(cuda_device):
    """K6 captured in a CUDA graph at three shapes (the wgmma kernel with
    split partials, the C_in = 1 kernel, the wgmma kernel unsplit) gives
    an eager call's bits at every replay: the partials are added in a
    fixed order, without atomics."""
    from gansynth_tpu_torch.kernels import conv1d_wgrad as K6
    from gansynth_tpu_torch.utils import graphs

    for layer in (K6_LAYERS[2], K6_LAYERS[0], K6_LAYERS[5]):
        x, gy = _k6_inputs(64, *layer, cuda_device, seed=41)
        eager = K6.conv1d_wgrad(x, gy, "conv")
        graph = graphs.Graph(lambda: K6.conv1d_wgrad(x, gy, "conv"),
                             cuda_device)
        for _ in range(2):
            assert torch.equal(graph.replay(), eager), layer


@pytest.mark.gpu
def test_a_wavegan_step_takes_its_weight_gradients_through_k6(cuda_device):
    """A graphed WaveGAN step at d = 8, batch 2, bf16: the launch record
    adds 90 ``conv`` and 36 ``transpose`` K6 calls a replay, and a
    profiler trace of the replay shows 252 ``conv1d_wgrad_`` kernels (a
    call and its splits' sum) and no cuDNN ``wgrad_alg1`` kernel."""
    from torch.profiler import ProfilerActivity, profile

    from gansynth_tpu_torch.models import wavegan as wg
    from gansynth_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
        train_key,
    )
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.config import Config

    cfg = Config().with_overrides({
        "model": {"architecture": "wavegan", "wavegan_dim": 8,
                  "latent_dim": 16, "compute_dtype": "bfloat16"},
        "train": {"critic_updates": 5, "batch_size": 2, "unroll": 1}})
    nets = [wg.WaveGANGenerator(cfg.model), wg.WaveGANDiscriminator(
        cfg.model), wg.WaveGANGenerator(cfg.model)]
    for i, net in enumerate(nets):
        wg.init_wavegan(net, (i, 3))
        net.to(cuda_device)
    g, d, ema = nets
    for p in ema.parameters():
        p.requires_grad_(False)
    state = TrainState(g=g, d=d, ema=ema,
                       g_opt=make_optimizer(cfg, g.parameters()),
                       d_opt=make_optimizer(cfg, d.parameters()),
                       rng=train_key(4))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    waves = 0.3 * torch.randn(8, 64000, generator=gen, device=cuda_device)
    pitches = torch.randint(24, 85, (8,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
    superstep = make_cached_superstep(cfg, 0, 8)
    state, _ = superstep(state, waves, pitches, [1.0])   # the capture
    torch.cuda.synchronize()
    keys = ("conv1d_wgrad_conv", "conv1d_wgrad_transpose")
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        superstep(state, waves, pitches, [1.0])
        torch.cuda.synchronize()
    assert {k: launch_counts()[k] - before[k] for k in keys} == dict(
        zip(keys, (90, 36)))
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("conv1d_wgrad_" in n for n in names) == 2 * 126
    assert not any("wgrad_alg1" in n for n in names)
