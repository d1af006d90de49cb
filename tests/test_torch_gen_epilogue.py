"""K4 (``kernels/gen_epilogue.py``) on the CPU: the operator, the plain
version of its backward, the autograd function's wiring (its kernel
entry points replaced by the plain versions), and the generator block
that calls it.

On a CPU tensor ``gen_epilogue`` is the chain it replaces,
``pixel_norm(leaky_relu(z + bias))``, so its value and its gradients with
respect to z and the bias equal the chain's to the bit, and so do a
``GeneratorBlock``'s output and parameter gradients. The plain version of
the CUDA backward (``gen_epilogue_backward_plain``, the kernel's
arithmetic: the pixel norm's adjoint per pixel in float32) is held to
autograd's gradients of the chain. The wrapper's checks of what the
kernels take, and its counts by role and shape, are pure Python and run
here too; the kernels themselves run only on a card
(``tests/test_torch_gpu.py``).
"""

import pytest
import torch

from gansynth_tpu_torch.kernels import gen_epilogue as K4
from gansynth_tpu_torch.kernels import (
    add,
    count,
    gen_epilogue_shapes,
    launch_counts,
    record,
    recomputing,
)
from gansynth_tpu_torch.models.generator import GeneratorBlock
from gansynth_tpu_torch.models.layers import leaky_relu, pixel_norm

SLOPE, EPS = 0.2, 1e-8
CASES = [(c, dt) for c in (64, 128, 256)
         for dt in (torch.float32, torch.bfloat16)]


def _chain(z, bias):
    """Today's chain, as ``GeneratorBlock`` ran it before K4."""
    return pixel_norm(leaky_relu(z + bias.to(z.dtype), SLOPE), EPS)


def _inputs(c, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed + c)
    z = (2.0 * torch.randn(2, 3, 8, c, generator=gen)).to(dtype)
    bias = 0.5 * torch.randn(c, generator=gen)
    g = torch.randn(2, 3, 8, c, generator=gen).to(dtype)
    return z, bias, g


def _grads(fn, z, bias, g):
    z = z.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    y = fn(z, bias)
    y.backward(g)
    return y.detach(), z.grad, bias.grad


@pytest.mark.parametrize("c,dtype", CASES)
def test_cpu_path_is_the_chain_to_the_bit(c, dtype):
    z, bias, g = _inputs(c, dtype)
    want = _grads(_chain, z, bias, g)
    got = _grads(lambda a, b: K4.gen_epilogue(a, b, SLOPE, EPS), z, bias, g)
    for x, w in zip(got, want):
        assert x.dtype == w.dtype and torch.equal(x, w)
    op = torch.ops.gansynth_torch.gen_epilogue(z, bias, SLOPE, EPS)
    assert torch.equal(op, want[0])


@pytest.fixture
def plain_kernels(monkeypatch):
    """The autograd function's kernel entry points replaced by the plain
    versions, so that its wiring runs on the CPU (the kernels themselves
    run only on a card)."""
    monkeypatch.setattr(
        K4, "_forward_cuda",
        lambda z, bias, slope, eps: K4.gen_epilogue_plain(z, bias, slope,
                                                          eps))

    def backward(z, bias, g, slope, eps, bias_grad):
        dz, db = K4.gen_epilogue_backward_plain(z, bias, g, slope, eps)
        return dz, db if bias_grad else None

    monkeypatch.setattr(K4, "_backward_cuda", backward)


@pytest.mark.parametrize("c,dtype", CASES)
def test_plain_backward_is_autograds_within_an_ulp(c, dtype, plain_kernels):
    """The kernel's arithmetic (``s g - a s^3 mean(g a)`` in float32,
    rounded once to z's type; the bias gradient summed in float32 and
    rounded to z's type) against autograd through the chain. The autograd
    function hands the backward what it returns, for z and the bias."""
    z, bias, g = _inputs(c, dtype, seed=1)
    _, dz_want, db_want = _grads(_chain, z, bias, g)
    dz, db = K4.gen_epilogue_backward_plain(z, bias, g, SLOPE, EPS)
    ulp = torch.finfo(dtype).eps
    torch.testing.assert_close(dz, dz_want, rtol=ulp, atol=1e-6)
    torch.testing.assert_close(db, db_want, rtol=ulp, atol=1e-6)
    y, dz_fn, db_fn = _grads(
        lambda a, b: K4._GenEpilogue.apply(a, b, SLOPE, EPS), z, bias, g)
    assert torch.equal(y, _chain(z, bias))
    assert torch.equal(dz_fn, dz) and torch.equal(db_fn, db)


def test_the_plain_version_is_the_models_chain():
    """``gen_epilogue_plain`` is written from torch ops (the kernels layer
    imports nothing of the models): it is ``models/layers.py``'s chain to
    the bit."""
    for c, dtype in CASES:
        z, bias, _ = _inputs(c, dtype, seed=2)
        assert torch.equal(K4.gen_epilogue_plain(z, bias, SLOPE, EPS),
                           _chain(z, bias))


def test_the_kernels_run_only_on_a_card():
    z, bias, g = _inputs(64, torch.float32)
    with pytest.raises(ValueError, match="card"):
        K4._forward_cuda(z, bias, SLOPE, EPS)
    with pytest.raises(ValueError, match="card"):
        K4._backward_cuda(z, bias, g, SLOPE, EPS, True)


def test_backward_is_once_differentiable(plain_kernels):
    z, bias, g = _inputs(64, torch.float32)
    z.requires_grad_()
    y = K4._GenEpilogue.apply(z, bias, SLOPE, EPS)
    (dz,) = torch.autograd.grad(y, z, g, create_graph=True)
    with pytest.raises(RuntimeError):
        dz.sum().backward()


@pytest.mark.parametrize("upsample", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_block_is_unchanged_on_the_cpu(upsample, dtype):
    """Output and every parameter gradient of a block equal the chain's
    run on the convs with their bias (``forward``), to the bit."""
    block = GeneratorBlock(64, 64, upsample=upsample, compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for conv in (block.conv0, block.conv1):
            conv.bias.normal_(0.0, 0.3)
    x = torch.randn(2, 4, 16, 64, generator=torch.Generator().manual_seed(4))

    def old(x):
        for conv in (block.conv0, block.conv1):
            x = pixel_norm(leaky_relu(conv(x), SLOPE), EPS)
        return x

    outs, grads = [], []
    for fn in (block, old):
        block.zero_grad()
        y = fn(x)
        y.float().square().sum().backward()
        outs.append(y.detach())
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


@pytest.mark.parametrize("shape,dtype,error", [
    ((2, 4, 4, 24), torch.bfloat16, ValueError),    # 3 vectors a row
    ((2, 4, 4, 4), torch.bfloat16, ValueError),     # under one vector
    ((2, 4, 4, 1024), torch.bfloat16, ValueError),  # 128 vectors a row
    ((2, 4, 4, 512), torch.float32, ValueError),
    ((2, 4, 4, 64), torch.float16, TypeError),
])
def test_the_kernels_refuse_what_they_do_not_take(shape, dtype, error):
    with pytest.raises(error):
        K4._check("the forward", torch.zeros(shape, dtype=dtype))


def test_the_kernels_take_their_widths_and_refuse_a_copy():
    for c, dtype in [(8, torch.bfloat16), (512, torch.bfloat16),
                     (4, torch.float32), (256, torch.float32)]:
        K4._check("the forward", torch.zeros(2, 3, 4, c, dtype=dtype))
    z = torch.zeros(2, 4, 64, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K4._check("the forward", z.permute(0, 1, 3, 2))
    with pytest.raises(TypeError):
        K4._check("the backward", torch.zeros(2, 3, 4, 64),
                  torch.zeros(2, 3, 4, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="do not fit"):
        K4.gen_epilogue(torch.zeros(2, 3, 4, 64), torch.zeros(32))


def test_launches_are_counted_by_role_and_shape():
    saved = record()
    add({k: -v for k, v in saved.items()})   # from an empty record
    try:
        shape = (8, 128, 1024, 64)
        count("gen_epilogue", "forward", *shape)
        count("gen_epilogue", "backward", *shape)
        with recomputing():
            count("gen_epilogue", "forward", *shape)
        assert {k: v for k, v in launch_counts().items()
                if k.startswith("gen_epilogue_")} == {
            "gen_epilogue_forward": 1, "gen_epilogue_backward": 1,
            "gen_epilogue_recompute": 1}
        want = {(role, *shape): 1
                for role in ("forward", "backward", "recompute")}
        assert gen_epilogue_shapes() == want
        # the CPU path launches nothing
        zc = torch.zeros(1, 2, 2, 64, requires_grad=True)
        K4.gen_epilogue(zc, torch.zeros(64)).sum().backward()
        assert gen_epilogue_shapes() == want
    finally:
        add({k: -v for k, v in record().items()})
        add(saved)
