"""K5: the critic's fromRGB, a 1x1 conv of fan-in at most 4 -> bias ->
LeakyReLU, its plain version, and a backward that is itself
differentiable.

``from_rgb_lrelu(x, w, b, slope)`` is ``leaky_relu(sum(x[..., c:c+1] *
w[:, c]) + b, slope)`` (``models/layers.py``: ``EqualizedConv.unbiased``'s
broadcast path, its bias and the LeakyReLU after it) for x [B, H, W, C_in]
NHWC, w [C_out, C_in] and b [C_out], all in the compute type T (float32
or bf16), with the chain's roundings: each product, each partial sum and
the bias add rounded to T, the slope in T (``utils.device.slope_in``). It
replaces no TPU kernel: XLA fuses the JAX package's broadcast
multiply-add (``gansynth_tpu/models/layers.py``), where PyTorch writes six
full tensors a forward and many more through the gradient penalty's
double backward.

For a CUDA tensor it launches the kernels of ``csrc/from_rgb.cu`` (built
by ``nvcc`` on first use; C_out a power of two from 8 to 256, C_in 1 to
4, :func:`from_rgb_eligible`). For a CPU tensor it is the plain chain
itself, with autograd's gradients. There is no fallback from one to the
other.

The derivatives. With z the pre-activation and m = (z > 0 ? 1 : slope)
its LeakyReLU's mask, whose own derivative is zero almost everywhere, the
backward of y for g is ``contract(g; x, w)``: ``(m g) w`` [B, H, W,
C_in], ``sum_pixels (m g) x`` [C_out, C_in] and ``sum_pixels m g``
[C_out], each computed only where a gradient is asked for. ``contract``
is linear in g, in X1 and in W1 (the operands in place of x and w), and
its derivative with respect to g is ``expand``: ``m (dX W1^T + X1 dW^T +
db)`` [B, H, W, C_out]; with respect to X1 and W1 it is ``contract(g; dA,
dB)``. ``expand``'s derivatives are ``contract(g; X1, W1)`` and
``contract(g; dX, dW)``. So the two autograd functions below are each the
other's derivative, and WGAN-GP's ``create_graph`` call and its double
backward both run through the kernels. The mask is recomputed from x, w
and b in the forward's arithmetic: nothing but the inputs is saved.

On a card ``kernels.count`` files each call under ``("from_rgb", role, B,
H, W, C_out)``, role ``"forward"``, ``"contract"`` or ``"expand"``.
:func:`from_rgb_contract_plain` and :func:`from_rgb_expand_plain` write
the kernels' arithmetic in torch (float32 sums, one rounding to T); the
autograd functions take them for tensors off a card, which is how the CPU
tests differentiate the route to any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import count
from gansynth_tpu_torch.kernels._build import (
    F32,
    I32,
    I64,
    PTR,
    launch,
    symbol,
)
from gansynth_tpu_torch.utils.device import slope_in

_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_C_IN = 4
C_OUT = (8, 16, 32, 64, 128, 256)   # the kernels' widths


def from_rgb_eligible(kernel_size, c_in: int, c_out: int,
                      dtype: torch.dtype) -> bool:
    """Whether K5 takes a conv: 1x1, a fan-in of 1 to 4 (the broadcast path
    of ``EqualizedConv.unbiased``), T float32 or bf16, and C_out a power of
    two from 8 to 256, as every stage width (``fmap_base >> stage``) is."""
    return (tuple(kernel_size) == (1, 1) and 1 <= c_in <= MAX_C_IN
            and c_out in C_OUT and dtype in _TYPES)


def _preact(x, w, b):
    """The chain's z: ``sum(x[..., c:c+1] * w[:, c]) + b``, rounded as it
    rounds."""
    return sum(x[..., c:c + 1] * w[:, c] for c in range(x.shape[-1])) + b


def from_rgb_plain(x, w, b, slope: float = 0.2) -> torch.Tensor:
    """The chain K5 replaces, op for op: ``leaky_relu(from_rgb(x))`` of
    ``models/layers.py`` with the scaled weight and the bias in x's
    type."""
    return F.leaky_relu(_preact(x, w, b), slope_in(x.dtype, slope))


def _masked(g, x, w, b, slope):
    """``m g`` in g's type: the LeakyReLU's backward at the chain's z."""
    return torch.where(_preact(x, w, b) > 0, g, g * slope_in(g.dtype, slope))


def _acc(t):
    """t in the sums' type: float32, or float64 for a float64 t."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def from_rgb_contract_plain(g, x1, w1, x, w, b, slope: float = 0.2,
                            want=(True, True, True)):
    """``(A, B, C)`` of ``contract(g; x1, w1)`` at the mask of (x, w, b):
    ``A = (m g) w1`` [B, H, W, C_in], ``B = sum_pixels (m g)^T x1`` [C_out,
    C_in], ``C = sum_pixels m g`` [C_out], each summed in float32 and
    rounded to g's type, None where ``want`` is False."""
    dt = g.dtype
    gz = _acc(_masked(g, x, w, b, slope))
    flat = gz.reshape(-1, gz.shape[-1])
    return (
        (gz @ _acc(w1)).to(dt) if want[0] else None,
        (flat.T @ _acc(x1).reshape(flat.shape[0], -1)).to(dt)
        if want[1] else None,
        flat.sum(0).to(dt) if want[2] else None,
    )


def from_rgb_expand_plain(dx, dw, db, x1, w1, x, w, b, slope: float = 0.2):
    """``expand(dx, dw, db; x1, w1)`` at the mask of (x, w, b): ``m (db +
    dx w1^T + x1 dw^T)`` [B, H, W, C_out], the sum in float32 rounded to
    x's type, then the mask applied in that type; a None term adds
    nothing."""
    dt = x.dtype
    t = torch.zeros(*x.shape[:-1], w.shape[0], dtype=_acc(x).dtype,
                    device=x.device)
    if db is not None:
        t = t + _acc(db)
    if dx is not None:
        t = t + _acc(dx) @ _acc(w1).T
    if dw is not None:
        t = t + _acc(x1) @ _acc(dw).T
    return _masked(t.to(dt), x, w, b, slope)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _blocks(rows: int, c_out: int, dtype: torch.dtype) -> int:
    """contract's blocks: its rows of float32 partial sums."""
    fn = symbol("from_rgb", "from_rgb_blocks", [I64, I32, I32])
    return fn(rows, c_out, torch.finfo(dtype).bits // 8)


def _ready(name, x, w, *tensors):
    """x itself, or a contiguous 16-byte aligned copy, once the types,
    devices and widths have been checked; the same for every tensor of
    ``tensors`` that is not None."""
    if x.dtype not in _TYPES:
        raise TypeError(f"from_rgb takes float32 or bfloat16, got {x.dtype}")
    c_out, c_in = w.shape
    if not from_rgb_eligible((1, 1), c_in, c_out, x.dtype):
        raise ValueError(f"from_rgb: {name} takes C_in 1 to {MAX_C_IN} and "
                         f"C_out in {C_OUT}, got {c_in} and {c_out}")
    out = []
    for t in (x, w, *tensors):
        if t is not None:
            if t.dtype != x.dtype or t.device != x.device:
                raise TypeError(f"from_rgb: {name} needs its tensors in "
                                "one type and on one device")
            if not t.is_contiguous() or t.data_ptr() % 16:
                t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return out


def _kernel(role: str, dtype: torch.dtype, tensors: int, sizes: int = 2):
    """A C entry: its tensors, the rows, ``sizes`` ints (cin and cout; for
    expand cin, k and cout), the slope and the stream."""
    return symbol("from_rgb", f"from_rgb_{role}_{_TYPES[dtype]}",
                  [PTR] * tensors + [I64] + [I32] * sizes + [F32, PTR])


def _launch_forward(x, w, b, slope):
    x, w, b = _ready("the forward", x, w, b)
    c_out, c_in = w.shape
    y = torch.empty((*x.shape[:-1], c_out), dtype=x.dtype, device=x.device)
    launch("from_rgb forward", _kernel("forward", x.dtype, 4), x.device, x,
           w, b, y, x.numel() // c_in, c_in, c_out, slope_in(x.dtype, slope))
    return y


def _launch_contract(g, x1, w1, x, w, b, slope, want):
    x, w, b, g, x1, w1 = _ready("contract", x, w, b, g, x1, w1)
    dt, (c_out, c_in) = x.dtype, w.shape
    rows = x.numel() // c_in
    a = torch.empty_like(x) if want[0] else None
    gw = torch.empty((c_out, c_in), dtype=dt, device=x.device) \
        if want[1] else None
    gb = torch.empty(c_out, dtype=dt, device=x.device) if want[2] else None
    partials = None
    if want[1] or want[2]:
        partials = torch.empty((max(_blocks(rows, c_out, dt), 1),
                                c_out * (c_in + 1)), dtype=torch.float32,
                               device=x.device)
    launch("from_rgb contract", _kernel("contract", dt, 10), x.device, g,
           x1, w1, x, w, b, a, partials, gw, gb, rows, c_in, c_out,
           slope_in(dt, slope))
    return a, gw, gb


def _launch_expand(dx, dw, db, x1, w1, x, w, b, slope):
    # one affine map of the pixel: u = [dx | x1], v = [w1 | dw], d = db
    terms = ([(dx, w1)] if dx is not None else []) \
        + ([(x1, dw)] if dw is not None else [])
    u = v = None
    if len(terms) == 1:
        u, v = terms[0]
    elif terms:
        u = torch.cat([dx, x1], -1)
        v = torch.cat([w1, dw], -1)
    x, w, b, u, v, d = _ready("expand", x, w, b, u, v, db)
    c_out, c_in = w.shape
    k = 0 if u is None else u.shape[-1]
    out = torch.empty((*x.shape[:-1], c_out), dtype=x.dtype,
                      device=x.device)
    launch("from_rgb expand", _kernel("expand", x.dtype, 7, 3), x.device, u,
           v, d, x, w, b, out, x.numel() // c_in, c_in, k, c_out,
           slope_in(x.dtype, slope))
    return out


def _shape(x, w):
    return (*x.shape[:3], w.shape[0])   # B, H, W, C_out


def _forward(x, w, b, slope):
    if not _on_card(x):
        return from_rgb_plain(x, w, b, slope)
    y = _launch_forward(x, w, b, slope)
    count("from_rgb", "forward", *_shape(x, w))
    return y


def _contract(g, x1, w1, x, w, b, slope, want):
    if not _on_card(x):
        return from_rgb_contract_plain(g, x1, w1, x, w, b, slope, want)
    out = _launch_contract(g, x1, w1, x, w, b, slope, want)
    count("from_rgb", "contract", *_shape(x, w))
    return out


def _expand(dx, dw, db, x1, w1, x, w, b, slope):
    if not _on_card(x):
        return from_rgb_expand_plain(dx, dw, db, x1, w1, x, w, b, slope)
    out = _launch_expand(dx, dw, db, x1, w1, x, w, b, slope)
    count("from_rgb", "expand", *_shape(x, w))
    return out


class _FromRGB(torch.autograd.Function):
    """y of (x, w, b); its backward is :class:`_Contract`."""

    @staticmethod
    def forward(ctx, x, w, b, slope):
        ctx.save_for_backward(x, w, b)
        ctx.slope = slope
        return _forward(x, w, b, slope)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        grads = _Contract.apply(g, x, w, x, w, b, ctx.slope,
                                tuple(ctx.needs_input_grad[:3]))
        return (*grads, None)


class _Contract(torch.autograd.Function):
    """``(A, B, C)`` of g, x1 and w1 at the mask of (x, w, b), which takes
    no gradient; its backward is :class:`_Expand` for g and itself for
    x1 and w1."""

    @staticmethod
    def forward(ctx, g, x1, w1, x, w, b, slope, want):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, x1, w1, x, w, b)
        ctx.slope = slope
        return _contract(g, x1, w1, x, w, b, slope, want)

    @staticmethod
    def backward(ctx, da, dB, dc):
        g, x1, w1, x, w, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dg = dx1 = dw1 = None
        if need[0] and (da is not None or dB is not None or dc is not None):
            dg = _Expand.apply(da, dB, dc, x1, w1, x, w, b, ctx.slope)
        want = (need[1] and dB is not None, need[2] and da is not None,
                False)
        if any(want):
            dx1, dw1, _ = _Contract.apply(g, da, dB, x, w, b, ctx.slope,
                                          want)
        return dg, dx1, dw1, None, None, None, None, None


class _Expand(torch.autograd.Function):
    """``m (db + dx w1^T + x1 dw^T)`` at the mask of (x, w, b), which takes
    no gradient; its backward is :class:`_Contract`."""

    @staticmethod
    def forward(ctx, dx, dw, db, x1, w1, x, w, b, slope):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dx, dw, db, x1, w1, x, w, b)
        ctx.slope = slope
        return _expand(dx, dw, db, x1, w1, x, w, b, slope)

    @staticmethod
    def backward(ctx, g):
        dx, dw, db, x1, w1, x, w, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = [None] * 9
        if g is None:
            return tuple(grads)
        if any(need[:3]):
            grads[:3] = _Contract.apply(g, x1, w1, x, w, b, ctx.slope,
                                        tuple(need[:3]))
        want = (need[3] and dw is not None, need[4] and dx is not None,
                False)
        if any(want):
            grads[3:5] = _Contract.apply(g, dx, dw, x, w, b, ctx.slope,
                                         want)[:2]
        return tuple(grads)


def from_rgb_lrelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   slope: float = 0.2) -> torch.Tensor:
    """``leaky_relu(sum(x[..., c:c+1] * w[:, c]) + b, slope)``.

    ``x`` [B, H, W, C_in] NHWC, ``w`` [C_out, C_in], ``b`` [C_out], all in
    one type (float32 or bf16). On a CPU tensor the plain chain, with
    autograd's gradients; on a CUDA tensor (C_out and C_in as
    :func:`from_rgb_eligible` takes them) the kernels, differentiable to
    any order through :class:`_Contract` and :class:`_Expand`, each call
    counted by ``kernels.count``.
    """
    if x.ndim != 4 or w.ndim != 2 or tuple(b.shape) != (w.shape[0],) \
            or x.shape[-1] != w.shape[1]:
        raise ValueError(f"from_rgb: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and b {tuple(b.shape)} do not fit")
    if not _on_card(x):
        return from_rgb_plain(x, w, b, slope)
    return _FromRGB.apply(x, w, b, slope)
