"""K2, the port's 3x3 conv (``kernels/conv.py``), against the reference's
``conv3x3_same`` run in interpret mode, and its routing in the models.

On the CPU the port's wrapper takes its plain version (``F.conv2d``)
through the same autograd Function that launches the kernel on the card,
so these tests hold the Function's backward (dx through another
``conv3x3_same`` call with the flipped, io-transposed kernel; dw through
``conv2d_weight``) to the reference's custom VJP. Tolerances are those of
``tests/test_pallas_conv.py``: values 1e-4; first order 1e-4 (dx) and
1e-3 (dw); the gradient-penalty second order 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gansynth_tpu.kernels.pallas_conv as pc
from gansynth_tpu.models import Generator as JGenerator
from gansynth_tpu.models.layers import EqualizedConv as JConv
from gansynth_tpu.utils.config import ModelConfig as JModel
from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.models import layers as tl
from gansynth_tpu_torch.models.generator import Generator as TGenerator
from gansynth_tpu_torch.utils.checkpoint import from_jax_params
from gansynth_tpu_torch.utils.config import ModelConfig as TModel

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ref(x, k_hwio):
    return pc.conv3x3_same(jnp.asarray(x), jnp.asarray(k_hwio), True)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _oihw(k_hwio):
    return np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 128, 32, 16),
                                            (1, 16, 128, 64, 64),
                                            (2, 4, 256, 64, 128)])
def test_forward_matches_reference(b, h, w, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = _np(rng, b, h, w, cin)
    k = _np(rng, 3, 3, cin, cout, scale=1 / np.sqrt(9 * cin))
    got = K2.conv3x3_same(_t(x), _t(_oihw(k))).numpy()
    np.testing.assert_allclose(got, np.asarray(_ref(x, k)), atol=1e-4,
                               rtol=1e-4)


def test_first_order_matches_reference():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 8, 128, 32)
    k = _np(rng, 3, 3, 32, 32, scale=1 / np.sqrt(9 * 32))
    co = _np(rng, 2, 8, 128, 32)
    gx_j, gk_j = jax.grad(
        lambda x, k: jnp.sum(pc.conv3x3_same(x, k, True) * co),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = _t(x, True), _t(_oihw(k), True)
    gx_t, gk_t = torch.autograd.grad(
        (K2.conv3x3_same(xt, kt) * _t(co)).sum(), (xt, kt))
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk_t.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gk_j), atol=1e-3, rtol=1e-4)


def test_second_order_gp_matches_reference():
    """d/dk of || d/dx sum(conv(x, k)) ||^2, the WGAN-GP pattern."""
    rng = np.random.default_rng(2)
    x = _np(rng, 1, 8, 128, 32)
    k = _np(rng, 3, 3, 32, 32, scale=1 / np.sqrt(9 * 32))

    def inner(k_):
        g = jax.grad(lambda xx: jnp.sum(pc.conv3x3_same(xx, k_, True)))(
            jnp.asarray(x))
        return jnp.sum(jnp.square(g))

    want = np.asarray(jax.grad(inner)(jnp.asarray(k)))
    xt, kt = _t(x, True), _t(_oihw(k), True)
    gx, = torch.autograd.grad(K2.conv3x3_same(xt, kt).sum(), xt,
                              create_graph=True)
    got, = torch.autograd.grad((gx ** 2).sum(), kt)
    np.testing.assert_allclose(got.numpy().transpose(2, 3, 1, 0), want,
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("x_shape,k_shape", [
    ((8, 64, 512, 128), (3, 3, 128, 128)),
    ((8, 32, 256, 256), (3, 3, 256, 256)),
    ((8, 128, 1024, 64), (3, 3, 64, 64)),
    ((8, 128, 1024, 2), (3, 3, 2, 64)),
    ((8, 128, 1024, 64), (1, 1, 64, 64)),
    ((8, 2, 16, 256), (3, 3, 256, 256)),
    ((8, 1, 128, 128), (3, 3, 128, 128)),
    ((8, 4, 120, 128), (3, 3, 128, 128)),
    ((8, 4, 128, 640), (3, 3, 640, 128)),
])
def test_gate_is_the_reference_gate(x_shape, k_shape):
    assert K2.conv3x3_eligible(x_shape, k_shape) == pc.conv3x3_eligible(
        x_shape, k_shape)


class _Count:
    """Wraps the port's conv3x3_same as the models see it and counts calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tl.conv3x3_same

        def counted(x, w):
            self.calls.append(tuple(x.shape))
            return real(x, w)

        monkeypatch.setattr(tl, "conv3x3_same", counted)


@pytest.fixture
def interpret(monkeypatch):
    """The reference's layers resolve conv3x3_same at call time; route it
    through interpret mode (as tests/test_pallas_conv.py does)."""
    real = pc.conv3x3_same
    monkeypatch.setattr(pc, "conv3x3_same",
                        lambda x, k, interpret=False: real(x, k, True))


def test_equalized_conv_routes_eligible_shapes(monkeypatch, interpret):
    count = _Count(monkeypatch)
    rng = np.random.default_rng(3)
    x = _np(rng, 2, 8, 128, 128)
    jm = JConv(features=32, conv_kernel="pallas")
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    tm = tl.EqualizedConv(128, 32, conv_kernel="pallas")
    tm.load_state_dict(from_jax_params(params))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
        tl.EqualizedConv(64, 32, conv_kernel="pallas")(
            torch.zeros(2, 8, 128, 64))          # C_in 64: not eligible
        tl.EqualizedConv(128, 32)(_t(x))         # conv_kernel "xla"
    assert count.calls == [(2, 8, 128, 128)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_generator_takes_k2_where_the_reference_does(monkeypatch, interpret):
    """Stage 3 of a 128-wide, 4-stage generator: conv1 of block 3 (16 x
    128, 128 channels) is the one eligible conv; both packages route it to
    their kernel and agree."""
    small = dict(latent_dim=8, fmap_base=1024, fmap_max=128, fmap_min=8,
                 num_pitches=5, pitch_max=28, num_stages=4,
                 conv_kernel="pallas")
    count = _Count(monkeypatch)
    rng = np.random.default_rng(4)
    z = _np(rng, 2, 8)
    labels = np.eye(5, dtype=np.float32)[[0, 4]]
    jg = JGenerator(JModel(**small))
    params = jg.init(jax.random.key(1), jnp.asarray(z), jnp.asarray(labels),
                     0, jnp.float32(1.0))
    tg = TGenerator(TModel(**small))
    tg.load_state_dict(from_jax_params(params))
    want = np.asarray(jg.apply(params, jnp.asarray(z), jnp.asarray(labels),
                               3, jnp.float32(1.0)))
    with torch.no_grad():
        got = tg(_t(z), _t(labels), 3, 1.0).numpy()
    assert count.calls == [(2, 16, 128, 128)]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_wrapper_checks_shapes_and_counts_only_launches():
    before = dict(K2.conv3x3_same.launches)
    K2.conv3x3_same(torch.zeros(1, 4, 4, 8), torch.zeros(3, 8, 3, 3))
    assert K2.conv3x3_same.launches == before   # the CPU takes the plain path
    with pytest.raises(ValueError, match="do not fit"):
        K2.conv3x3_same(torch.zeros(1, 4, 4, 8), torch.zeros(3, 4, 3, 3))
