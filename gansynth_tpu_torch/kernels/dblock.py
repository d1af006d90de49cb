"""K3: the fused stage-6 critic block and its backward, and their plain
versions.

``fused_dblock`` replaces the TPU kernel
``gansynth_tpu/kernels/pallas_dblock.py:fused_dblock`` (``_dblock_pallas``):
conv3x3 SAME 64->64 + b0 -> lrelu -> conv3x3 SAME 64->C1 + b1 -> lrelu ->
2x2 mean pool, with the two intermediate activations kept on chip. For a
CUDA tensor it launches the CUDA kernel of ``csrc/dblock.cu`` (built by
``nvcc`` on first use): in bf16 both convs on Hopper's tensor cores
(``wgmma``, the input tile and the weights brought in by TMA), in f32 the
FMA units. For a CPU tensor it calls :func:`dblock_plain`, the reference's
``_literal_chain``. There is no fallback from one to the other.

Its first-order backward has two routes, chosen by what the call shows.
Where the backward will be differentiated again (grad mode on: WGAN-GP's
``autograd.grad(..., create_graph=True)``), or on the CPU,
:func:`dblock_backward_plain` recomputes the chain from the saved inputs,
as the reference does (``pallas_dblock.py:286-296``), and writes the
adjoints in differentiable torch ops (the lrelu masks, the transposed
convs, ``conv2d_weight``, the bias sums, the pool's spread); so does
every width that the kernels do not take (:func:`keeps_for_backward`).
On a card with grad mode off, the forward has kept a0 and the sign of z1
(the kernel's saving instance, when any input needs a gradient) and
:func:`dblock_backward_saved` runs from them: the kernels of
``csrc/dblock_grad.cu`` spread the pooled gradient through z1's mask and
apply a0's, with fixed-order bias sums, and the library's convs take
the input and weight adjoints; nothing is recomputed. On the card
``kernels.count`` counts the two routes apart (the roles ``"backward"``
and ``"backward_plain"``).
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

_SYMBOLS = {torch.float32: "dblock_nhwc_f32",
            torch.bfloat16: "dblock_nhwc_bf16"}
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
C_IN = 64   # the kernel's input and conv0 width (the stage-6 width)


def dblock_eligible(x_shape, c_out0: int, c_out1: int) -> bool:
    """The reference's routing gate (``pallas_dblock.py:302``)."""
    if len(x_shape) != 4:
        return False
    _, h, w, c_in = x_shape
    return c_in == C_IN and c_out0 == C_IN and h % 4 == 0 and w % 16 == 0 \
        and h >= 8


def _lrelu(v: torch.Tensor, slope: float) -> torch.Tensor:
    """The chain's ``where(v >= 0, v, slope * v)``, with the slope in v's
    type as JAX takes it."""
    return torch.where(v >= 0, v, slope_in(v.dtype, slope) * v)


def _pool(v: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool of an NCHW tensor (the chain's reshape-mean)."""
    b, c, h, w = v.shape
    return v.reshape(b, c, h // 2, 2, w // 2, 2).mean((3, 5))


def dblock_plain(x, k0, b0, k1, b1, slope: float = 0.2) -> torch.Tensor:
    """``_literal_chain`` in x's type: x [B, H, W, 64] NHWC; k0 [64, 64, 3,
    3] and k1 [C1, 64, 3, 3] OIHW with the eq-LR scale folded in; b0, b1.
    Returns [B, H/2, W/2, C1]."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    a0 = _lrelu(F.conv2d(xc, k0.to(dt), padding=1)
                + b0.to(dt)[:, None, None], slope)
    a1 = _lrelu(F.conv2d(a0, k1.to(dt), padding=1)
                + b1.to(dt)[:, None, None], slope)
    return _pool(a1).permute(0, 2, 3, 1).contiguous()


def mask_bytes(c1: int) -> int:
    """Bytes a pixel of the z1 mask: 8 for each 64-channel pass of conv1
    (``dblock_mask::pixel_bytes``)."""
    return 8 * -(-c1 // 64)


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """bool [B, H, W, C1] -> the kernel's mask, uint8 [B, H, W,
    mask_bytes(C1)], in the layout that ``csrc/dblock_mask.cuh`` defines
    for the kernels: each 64-channel pass of a pixel four little-endian
    16-bit halfwords, channel 8 j + 2 t + e of the pass (j < 8, t < 4,
    e < 2) bit 2 j + e of halfword t; channels past C1 0."""
    *lead, c1 = bits.shape
    passes = mask_bytes(c1) // 8
    pad = torch.zeros((*lead, 64 * passes - c1), dtype=torch.bool,
                      device=bits.device)
    # channel 64 p + 8 (4 jh + jl) + 2 t + e -> byte 8 p + 2 t + jh,
    # bit 2 jl + e
    b = torch.cat([bits, pad], -1).reshape(*lead, passes, 2, 4, 4, 2)
    n = len(lead)
    b = b.permute(*range(n + 1), n + 3, n + 1, n + 2, n + 4)
    weights = 2 ** torch.arange(8, device=bits.device, dtype=torch.int32)
    return (b.reshape(*lead, 8 * passes, 8).to(torch.int32)
            * weights).sum(-1).to(torch.uint8)


def unpack_mask(mask: torch.Tensor, c1: int) -> torch.Tensor:
    """The kernel's mask -> bool [B, H, W, C1] (:func:`pack_mask`)."""
    *lead, nbytes = mask.shape
    shifts = torch.arange(8, device=mask.device, dtype=torch.int32)
    b = ((mask.to(torch.int32)[..., None] >> shifts) & 1).bool()
    b = b.reshape(*lead, nbytes // 8, 4, 2, 4, 2)   # p, t, jh, jl, e
    n = len(lead)
    b = b.permute(*range(n + 1), n + 2, n + 3, n + 1, n + 4)
    return b.reshape(*lead, 8 * nbytes)[..., :c1]


def dblock_saving_plain(x, k0, b0, k1, b1, slope: float = 0.2):
    """The chain's ``(y, a0, mask)``: y as :func:`dblock_plain`, a0 [B, H,
    W, 64] in x's type and the bits of z1 >= 0 (:func:`pack_mask`), what
    the kernel's saving instance writes."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    a0 = _lrelu(F.conv2d(xc, k0.to(dt), padding=1)
                + b0.to(dt)[:, None, None], slope)
    z1 = F.conv2d(a0, k1.to(dt), padding=1) + b1.to(dt)[:, None, None]
    y = _pool(_lrelu(z1, slope)).permute(0, 2, 3, 1).contiguous()
    return (y, a0.permute(0, 2, 3, 1).contiguous(),
            pack_mask((z1 >= 0).permute(0, 2, 3, 1)))


def _bias_grad(gz: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The kernels' bias gradient: float32 sums rounded to dt, in float32."""
    return gz.float().sum((0, 1, 2)).to(dt).float()


def spread_plain(g, mask, slope: float = 0.2):
    """The spread kernel's ``(g_z1, db1)`` in plain ops: the pooled g [B,
    H/2, W/2, C1] over its 2x2 windows, g / 4 in g's type, scaled by the
    slope where the mask's z1 < 0; g_z1 [B, H, W, C1], db1 float32."""
    dt = g.dtype
    g_a1 = (g * 0.25).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    g_z1 = torch.where(unpack_mask(mask, g.shape[-1]), g_a1,
                       slope_in(dt, slope) * g_a1)
    return g_z1, _bias_grad(g_z1, dt)


def mask_grad_plain(a0, g_a0, slope: float = 0.2):
    """The mask kernel's ``(g_z0, db0)`` in plain ops: g_a0 [B, H, W, 64]
    scaled by the slope where a0 < 0; db0 float32."""
    dt = g_a0.dtype
    g_z0 = torch.where(a0 >= 0, g_a0, slope_in(dt, slope) * g_a0)
    return g_z0, _bias_grad(g_z0, dt)


def _kernel(dtype: torch.dtype):
    return symbol("dblock", _SYMBOLS[dtype],
                  [PTR] * 8 + [I32] * 4 + [F32, PTR])


def _launch(x, k0, b0, k1, b1, slope: float, save: bool):
    """The forward kernel: ``(y, a0, mask)``, a0 and mask None unless
    ``save``."""
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"fused_dblock takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_dblock needs a contiguous NHWC input")
    for p in (k0, b0, k1, b1):
        if p.device != x.device:
            raise TypeError("fused_dblock needs its weights on x's device")
    batch, height, width, _ = x.shape
    c1 = k1.shape[0]
    if save and not keeps_for_backward(c1):
        raise ValueError(f"fused_dblock's backward on a card takes C1 a "
                         f"multiple of 8, got {c1}")
    dt = x.dtype
    hwoi0 = k0.to(dt).permute(2, 3, 0, 1).contiguous()
    hwoi1 = k1.to(dt).permute(2, 3, 0, 1).contiguous()
    b0c, b1c = b0.to(dt).contiguous(), b1.to(dt).contiguous()
    y = torch.empty((batch, height // 2, width // 2, c1), dtype=dt,
                    device=x.device)
    a0 = mask = None
    if save:
        a0 = torch.empty_like(x)
        mask = torch.empty((batch, height, width, mask_bytes(c1)),
                           dtype=torch.uint8, device=x.device)
    launch("dblock kernel", _kernel(dt), x.device, x, hwoi0, b0c, hwoi1, b1c,
           y, a0, mask, batch, height, width, c1, float(slope))
    count("dblock", "forward", batch, height, width, c1)
    return y, a0, mask


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels can read it (contiguous, 16-byte
    aligned), else a contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bias_scratch(rows: int, c: int, bias: bool, device):
    """``(partials, dbias)`` for a backward kernel over ``rows`` rows of c
    channels, or ``(None, None)`` without a bias gradient."""
    if not bias:
        return None, None
    blocks = symbol("dblock_grad", "dblock_backward_blocks", [I64, I32])(
        rows, c)
    return (torch.empty((max(blocks, 1), c), dtype=torch.float32,
                        device=device),
            torch.empty(c, dtype=torch.float32, device=device))


def _spread(g, mask, slope: float, bias: bool):
    """The spread kernel: ``(g_z1, db1)`` as :func:`spread_plain`, db1
    None unless ``bias``."""
    g, dt = _aligned(g), g.dtype
    b, hp, wp, c = g.shape
    g_z1 = torch.empty((b, 2 * hp, 2 * wp, c), dtype=dt, device=g.device)
    partials, db1 = _bias_scratch(b * hp * wp, c, bias, g.device)
    fn = symbol("dblock_grad", f"dblock_backward_spread_{_TYPES[dt]}",
                [PTR] * 5 + [I64, I32, I32, I32, F32, PTR])
    launch("dblock backward (spread)", fn, g.device, g, mask, g_z1, partials,
           db1, b * hp * wp, wp, c, mask.shape[-1], slope_in(dt, slope))
    return g_z1, db1


def _mask_grad(a0, g_a0, slope: float, bias: bool):
    """The mask kernel: ``(g_z0, db0)`` as :func:`mask_grad_plain`, db0
    None unless ``bias``."""
    a0, g_a0, dt = _aligned(a0), _aligned(g_a0), g_a0.dtype
    c = g_a0.shape[-1]
    g_z0 = torch.empty_like(g_a0)
    partials, db0 = _bias_scratch(g_a0.numel() // c, c, bias, g_a0.device)
    fn = symbol("dblock_grad", f"dblock_backward_mask_{_TYPES[dt]}",
                [PTR] * 5 + [I64, I32, F32, PTR])
    launch("dblock backward (mask)", fn, g_a0.device, a0, g_a0, g_z0,
           partials, db0, g_a0.numel() // c, c, slope_in(dt, slope))
    return g_z0, db0


def dblock_backward_plain(x, k0, b0, k1, b1, g, slope: float = 0.2,
                          need=(True,) * 5):
    """The adjoints of :func:`dblock_plain` for the gradient ``g`` of y,
    the chain recomputed from the inputs and written in differentiable
    torch ops: ``(dx, dk0, db0, dk1, db1)``, None where ``need`` is False.
    Differentiable to any order (the penalty's double backward)."""
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    k0c, k1c = k0.to(dt), k1.to(dt)
    # Recompute the chain's pre-activations.
    z0 = F.conv2d(xc, k0c, padding=1) + b0.to(dt)[:, None, None]
    a0 = _lrelu(z0, slope)
    z1 = F.conv2d(a0, k1c, padding=1) + b1.to(dt)[:, None, None]
    # Adjoints: the pool spreads g / 4 over its window, each lrelu
    # scales by its mask, each conv's input adjoint is the transposed
    # conv and its weight adjoint conv2d_weight.
    g_a1 = (g.to(dt).permute(0, 3, 1, 2) * 0.25).repeat_interleave(
        2, dim=2).repeat_interleave(2, dim=3)
    s = slope_in(dt, slope)
    g_z1 = torch.where(z1 >= 0, g_a1, s * g_a1)
    g_a0 = F.conv_transpose2d(g_z1, k1c, padding=1)
    g_z0 = torch.where(z0 >= 0, g_a0, s * g_a0)
    grads = [None] * 5
    if need[0]:
        grads[0] = F.conv_transpose2d(g_z0, k0c, padding=1).permute(
            0, 2, 3, 1).to(x.dtype)
    if need[1]:
        grads[1] = torch.nn.grad.conv2d_weight(
            xc, k0.shape, g_z0, padding=1).to(k0.dtype)
    if need[2]:
        grads[2] = g_z0.sum((0, 2, 3)).to(b0.dtype)
    if need[3]:
        grads[3] = torch.nn.grad.conv2d_weight(
            a0, k1.shape, g_z1, padding=1).to(k1.dtype)
    if need[4]:
        grads[4] = g_z1.sum((0, 2, 3)).to(b1.dtype)
    return tuple(grads)


def dblock_backward_saved(x, k0, b0, k1, b1, a0, mask, g,
                          slope: float = 0.2, need=(True,) * 5):
    """The adjoints as :func:`dblock_backward_plain`, from the a0 and mask
    that the forward kept (NHWC, :func:`dblock_saving_plain`'s layout): the
    spread kernel for g_z1 and db1, the mask kernel for g_z0 and db0, the
    library's convs for dx, dk0 and dk1. Nothing is recomputed; first
    order only."""
    return _backward_from(x, k0, b0, k1, b1, a0, mask, g, slope, need,
                          _spread, _mask_grad)


def dblock_backward_saved_plain(x, k0, b0, k1, b1, a0, mask, g,
                                slope: float = 0.2, need=(True,) * 5):
    """:func:`dblock_backward_saved` with the plain versions of its two
    kernels (:func:`spread_plain`, :func:`mask_grad_plain`)."""
    return _backward_from(
        x, k0, b0, k1, b1, a0, mask, g, slope, need,
        lambda g_, m, s, bias: spread_plain(g_, m, s),
        lambda a, g_a0, s, bias: mask_grad_plain(a, g_a0, s))


def _backward_from(x, k0, b0, k1, b1, a0, mask, g, slope, need, spread,
                   mask_grad):
    dt = x.dtype
    k0c, k1c = k0.to(dt), k1.to(dt)
    g_z1, db1 = spread(g.to(dt), mask, slope, need[4])
    g_z1c = g_z1.permute(0, 3, 1, 2)   # NCHW view of NHWC memory
    grads = [None] * 5
    if need[3]:
        grads[3] = torch.nn.grad.conv2d_weight(
            a0.permute(0, 3, 1, 2), k1.shape, g_z1c, padding=1).to(k1.dtype)
    if need[4]:
        grads[4] = db1.to(b1.dtype)
    if not any(need[:3]):
        return tuple(grads)
    g_a0 = F.conv_transpose2d(g_z1c, k1c, padding=1)
    g_z0, db0 = mask_grad(a0, g_a0.permute(0, 2, 3, 1), slope, need[2])
    g_z0c = g_z0.permute(0, 3, 1, 2)
    if need[0]:
        grads[0] = F.conv_transpose2d(g_z0c, k0c, padding=1).permute(
            0, 2, 3, 1).to(x.dtype)
    if need[1]:
        grads[1] = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), k0.shape, g_z0c, padding=1).to(k0.dtype)
    if need[2]:
        grads[2] = db0.to(b0.dtype)
    return tuple(grads)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def keeps_for_backward(c1: int) -> bool:
    """Whether K3's forward on a card keeps a0 and z1's mask for the
    kernels' backward, given that an input needs a gradient: their 16-byte
    vectors take C1 a multiple of 8. Every other width takes
    :func:`dblock_backward_plain`."""
    return c1 % 8 == 0


class _FusedDBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k0, b0, k1, b1, slope):
        ctx.slope = slope
        if _on_card(x):
            # Keep a0 and z1's mask when the kernels' backward may follow.
            y, a0, mask = _launch(x, k0, b0, k1, b1, slope,
                                  any(ctx.needs_input_grad)
                                  and keeps_for_backward(k1.shape[0]))
            ctx.save_for_backward(x, k0, b0, k1, b1, a0, mask)
            return y
        if x.device.type != "cpu":
            raise ValueError(f"fused_dblock: unsupported device {x.device}")
        ctx.save_for_backward(x, k0, b0, k1, b1)
        return dblock_plain(x, k0, b0, k1, b1, slope)

    @staticmethod
    def backward(ctx, g):
        # Unpacked once: a rematerialised forward (ModelConfig.remat)
        # allows no second unpacking.
        saved = ctx.saved_tensors
        shape = (*saved[0].shape[:3], saved[3].shape[0])   # B, H, W, C1
        if (_on_card(saved[0]) and saved[5] is not None
                and not torch.is_grad_enabled()):
            # Grad mode is off, so nothing records these ops: the route is
            # once differentiable as it stands.
            count("dblock", "backward", *shape)
            grads = dblock_backward_saved(*saved, g, ctx.slope,
                                          ctx.needs_input_grad[:5])
        else:
            if _on_card(saved[0]):   # create_graph, or C1 the kernels lack
                count("dblock", "backward_plain", *shape)
            grads = dblock_backward_plain(*saved[:5], g, ctx.slope,
                                          ctx.needs_input_grad[:5])
        return (*grads, None)


def fused_dblock(x, k0, b0, k1, b1, slope: float = 0.2) -> torch.Tensor:
    """conv3x3 -> +b0 -> lrelu -> conv3x3 -> +b1 -> lrelu -> 2x2 mean pool.

    ``x`` [B, H, W, 64] NHWC contiguous (f32 or bf16); ``k0`` [64, 64, 3,
    3], ``k1`` [C1, 64, 3, 3] OIHW with the eq-LR scale folded in, ``b0``,
    ``b1`` (any float type; cast to x's type, as the chain does). Returns
    [B, H/2, W/2, C1] in x's type. Launches the CUDA kernel for a CUDA
    tensor (``kernels.count``: the role ``"forward"``, ``"recompute"`` in a
    rematerialised forward, ``ModelConfig.remat``); takes
    :func:`dblock_plain` for a CPU tensor. Differentiable to any order;
    on a card a first-order backward with grad mode off takes the
    kernels (the role ``"backward"``), one with grad mode on the plain
    adjoints (``"backward_plain"``), as does every backward where C1 is
    not a multiple of 8 (:func:`keeps_for_backward`).
    """
    if (x.ndim != 4 or x.shape[-1] != C_IN or tuple(k0.shape) !=
            (C_IN, C_IN, 3, 3) or tuple(k1.shape[1:]) != (C_IN, 3, 3)
            or x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"fused_dblock: x {tuple(x.shape)}, k0 "
                         f"{tuple(k0.shape)}, k1 {tuple(k1.shape)} do not fit")
    return _FusedDBlock.apply(x, k0, b0, k1, b1, slope)
