"""WaveGAN at 65536 samples and its WGAN-GP step, plain torch in float32:
the reference that the port's WaveGAN (``models/wavegan.py``, the
``train/step.py`` step) is held to, on the CPU in the tests and on the
card in the benchmark. Written from Donahue, McAuley and Puckette,
"Adversarial Audio Synthesis" (ICLR 2019, arXiv:1802.04208) and the
public ``chrisdonahue/wavegan`` (``wavegan.py``: ``WaveGANGenerator``,
``WaveGANDiscriminator``, ``apply_phaseshuffle``; ``train_wavegan.py``)
at ``slice_len=65536``. It imports no JAX and nothing of ``gansynth_tpu``
or ``gansynth_tpu_torch``; the threefry it draws its noise with is
``portbench/reference/threefry.py``. A copy of it is
``tests/wavegan_reference.py``, equal in text.

Shapes are [length, channels] for one note, d = ``wavegan_dim`` (64),
kernel k = 25, stride s = 4. Every conv has a bias; no batch norm.

Generator:
- ``z_project``: dense (100 + 61) -> 16 * 32d, reshaped (length-major)
  to [16, 32d]; ReLU.
- ``upconv_0..4``: transposed conv1d k25 s4, 32d -> 16d -> 8d -> 4d ->
  2d -> d, to [64, 16d] ... [16384, d]; ReLU.
- ``upconv_5``: transposed conv1d k25 s4, d -> 1, to [65536, 1]; tanh.

Critic:
- ``downconv_0..3``: conv1d k25 s4 "SAME", 1 -> d -> 2d -> 4d -> 8d, to
  [16384, d] ... [256, 8d]; LeakyReLU 0.2, then phase shuffle 2.
- ``downconv_4``, ``downconv_5``: conv1d k25 s4 "SAME", 8d -> 16d -> 32d,
  to [64, 16d], [16, 32d]; LeakyReLU 0.2.
- flatten (length-major) 16 * 32d -> dense 1 (``critic_head``) and dense
  61 (``pitch_head``, the pitch logits).

- "SAME" conv: the input of length 4L padded (k - s) // 2 = 10 on the
  left and 11 on the right, then the strided conv: L outputs.
- Transposed conv: the gradient of that conv: the full output of length
  4L + 21 (s (L - 1) + k) cropped to [10, 10 + 4L).
- Phase shuffle (``apply_phaseshuffle``): a shift s uniform in -2..2,
  one a critic call and shuffled layer for the whole batch; reflect-pad
  by max(s, 0) on the left and max(-s, 0) on the right, crop back to the
  length from max(-s, 0).

Training (``train_wavegan.py`` and the paper): WGAN-GP with lambda 10;
5 critic updates a generator update, each with its own real batch,
latents, interpolation weights and shifts; Adam lr 1e-4, betas (0.5,
0.9) for both networks; batch 64; z uniform on [-1, 1)^100. A critic
update: critic on the real batch, on G(z_d) (no gradient to G) and on
the interpolates ``real + u (fake - real)``, u uniform per example;
``d_loss = E[D(fake)] - E[D(real)] + 10 E[(|grad D(x_hat)| - 1)^2] +
aux_pitch_weight (CE(real logits) + CE(fake logits))``, the norm over
the whole wave, ``sqrt(sum g^2 + 1e-12)``. The generator update: ``-E[D(
G(z_g))] + aux_pitch_weight CE``. Adam is optax's (one count a network,
bias corrections taken in float32). Then the EMA ``e <- 0.999 e + 0.001
g``.

Departures from the public code, each a setting of the configuration:
- pitch conditioning as GANSynth's: a 61-way one-hot concatenated to z,
  and an AC-GAN pitch head on the critic, ``aux_pitch_weight`` 10, the
  fake logits' CE included (the public WaveGAN is unconditional);
- the EMA of G (0.999) is kept;
- drift weight 0 (the term is written, at weight 0);
- the program computes in bf16 (this reference in float32);
- notes of 64000 samples zero-padded at the end to 65536.

The noise contract (the program's, ``models/wavegan.py:wavegan_noise``):
for step t, ``keys = split(fold_in(key, t), 3 n + 2)``; critic update j
draws z_d from ``keys[3 j]`` (uniform [-1, 1) from 32 random bits), u
from ``keys[3 j + 1]`` and the shifts [3, 4] of its real, fake and
interpolates calls from ``keys[3 j + 2]`` (``bits mod 5 - 2``); the
generator update z_g from ``keys[3 n]`` and its call's 4 shifts from
``keys[3 n + 1]``. Critic update j reads the ``shuffle`` stream's batch
at position ``t n + j`` (per-epoch permutations keyed by
``fold_in(fold_in(key, 0x5E0F), epoch)``); the generator update takes
the last batch's labels.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import threefry as tf

Params = Dict[str, torch.Tensor]
LAYERS, SHUFFLED = 6, 4
KERNEL, STRIDE, SLICE_LEN, RADIUS = 25, 4, 65536, 2
BASE = SLICE_LEN // STRIDE ** LAYERS


def _same(x):
    return x


def widths(model: Mapping) -> List[int]:
    return [1] + [model["wavegan_dim"] << i for i in range(LAYERS)]


def param_shapes(model: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """Kernels in TF's layouts: conv1d [k, in, out], the transposed convs
    [k, out, in], dense [in, out]; the biases have the outputs' size."""
    c, k = widths(model), KERNEL
    flat = BASE * c[-1]
    g = [("z_project", (model["latent_dim"] + model["num_pitches"], flat))]
    g += [(f"upconv_{i}", (k, c[LAYERS - 1 - i], c[LAYERS - i]))
          for i in range(LAYERS)]
    d = [(f"downconv_{i}", (k, c[i], c[i + 1])) for i in range(LAYERS)]
    d += [("critic_head", (flat, 1)),
          ("pitch_head", (flat, model["num_pitches"]))]
    return g + d


def draw_params(model: Mapping, seed: int, device) -> Tuple[Params, Params]:
    """``(G, D)`` for ``seed``, keyed ``"<layer>/kernel"`` and ``"<layer>/
    bias"``: kernels Glorot-uniform (TF's default, limit ``sqrt(6 /
    (fan_in + fan_out))``), biases N(0, 0.02^2), drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x3A7E6A)
    nets: Tuple[Params, Params] = ({}, {})
    for name, shape in param_shapes(model):
        net = nets[0] if name.startswith(("z_", "up")) else nets[1]
        taps = shape[0] if len(shape) == 3 else 1
        limit = math.sqrt(6.0 / (taps * (shape[-1] + shape[-2])))
        net[name + "/kernel"] = (torch.rand(shape, generator=gen,
                                            device=device) * 2 - 1) * limit
        net[name + "/bias"] = 0.02 * torch.randn(
            shape[-1] if not name.startswith("up") else shape[1],
            generator=gen, device=device)
    return nets


def conv(x, p: Params, name: str, stride: int = STRIDE, q=_same):
    """TF's "SAME" conv1d of ``x`` [B, C, 4L] -> [B, C', L]."""
    k = p[name + "/kernel"]
    total = k.shape[0] - stride
    x = F.pad(q(x), (total // 2, total - total // 2))
    return F.conv1d(x, q(k).permute(2, 1, 0), stride=stride) + \
        p[name + "/bias"][:, None]


def conv_transpose(x, p: Params, name: str, stride: int = STRIDE,
                   q=_same):
    """The gradient of :func:`conv` as a layer: [B, C, L] -> [B, C',
    4L], the full output cropped."""
    k = p[name + "/kernel"]
    total = k.shape[0] - stride
    full = F.conv_transpose1d(q(x), q(k).permute(2, 1, 0), stride=stride)
    length = stride * x.shape[-1]
    return full[..., total // 2:total // 2 + length] + \
        p[name + "/bias"][:, None]


def dense(x, p: Params, name: str, q=_same):
    return q(x) @ q(p[name + "/kernel"]) + p[name + "/bias"]


def phase_shuffle(x, shift: int):
    """``apply_phaseshuffle`` with its shift given: [B, C, L]."""
    length = x.shape[-1]
    left, right = max(shift, 0), max(-shift, 0)
    x = F.pad(x, (left, right), mode="reflect")
    return x[..., right:right + length]


def generator(p: Params, z, labels, model: Mapping, q=_same):
    x = F.relu(dense(torch.cat([z, labels], -1), p, "z_project", q))
    h = x.view(x.shape[0], BASE, -1).transpose(1, 2)
    for i in range(LAYERS):
        h = conv_transpose(h, p, f"upconv_{i}", q=q)
        h = F.relu(h) if i < LAYERS - 1 else torch.tanh(h)
    return h[:, 0]


def critic(p: Params, wave, shifts, model: Mapping, q=_same):
    """``(scores [B], pitch logits [B, P])``; ``shifts`` the call's 4
    Python ints."""
    h = wave[:, None]
    for i in range(LAYERS):
        h = F.leaky_relu(conv(h, p, f"downconv_{i}", q=q),
                         model["leaky_relu_slope"])
        if i < SHUFFLED:
            h = phase_shuffle(h, int(shifts[i]))
    flat = h.transpose(1, 2).reshape(h.shape[0], -1)
    return dense(flat, p, "critic_head", q)[:, 0], dense(flat, p,
                                                         "pitch_head", q)


def train_key(seed: int):
    """The state's key of a run seeded ``seed``: the third of
    ``split(key(seed), 3)``."""
    return tf.split(tf.seed_to_key(seed), 3)[2]


def step_noise(key, step: int, batch: int, latent: int, updates: int):
    keys = tf.split(tf.fold_in(key, step), 3 * updates + 2)

    def latents(k):
        return tf.uniform_from_bits(tf.random_bits(k, (batch, latent)),
                                    np.float32(-1.0), np.float32(1.0))

    def shifts(k, shape):
        bits = tf.random_bits(k, shape)
        return (bits % np.uint32(2 * RADIUS + 1)).astype(np.int64) - RADIUS

    return ([latents(keys[3 * j]) for j in range(updates)],
            [tf.uniform(keys[3 * j + 1], (batch,)) for j in range(updates)],
            [shifts(keys[3 * j + 2], (3, SHUFFLED)) for j in range(updates)],
            latents(keys[3 * updates]),
            shifts(keys[3 * updates + 1], (SHUFFLED,)))


def batch_indices(key, position: int, batch: int, n: int) -> np.ndarray:
    """The ``shuffle`` stream's batch at ``position``: epoch permutations
    of [0, n) read at example offset ``position * batch``."""
    base = tf.fold_in(key, 0x5E0F)
    pos = position * batch + np.arange(batch)
    out = np.empty(batch, np.int64)
    for e in np.unique(pos // n):
        perm = tf.permutation(tf.fold_in(base, int(e)), n)
        sel = pos // n == e
        out[sel] = perm[pos[sel] % n]
    return out


def _ce(logits, labels):
    return -torch.mean(torch.sum(labels * torch.log_softmax(logits, -1), -1))


def onehot(pitch, model: Mapping):
    idx = torch.clamp(pitch.long() - model["pitch_min"], 0,
                      model["num_pitches"] - 1)
    return F.one_hot(idx, model["num_pitches"]).float()


class Adam:
    """optax's adam: one count, bias corrections in float32."""

    def __init__(self, params: Params, train: Mapping):
        self.b1, self.b2 = train["adam_beta1"], train["adam_beta2"]
        self.eps, self.lr = train["adam_eps"], train["learning_rate"]
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> None:
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** self.count)
        bc2 = float(1 - np.float32(self.b2) ** self.count)
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            p -= self.lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)


def _grads(loss, params: Params) -> Params:
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g.detach()
            for (k, p), g in zip(params.items(), got)}


@contextlib.contextmanager
def _no_tf32():
    """Float32 matmuls and convs on a card without TF32, as long as the
    reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_steps(cfg: Mapping, g_params: Params, d_params: Params, waves,
              pitches, key, step0: int, steps: int, q=_same,
              half: bool = False) -> Dict[str, object]:
    """``steps`` steps from ``step0``: per step ``d_loss`` (the mean over
    its critic updates) and ``g_loss``; the first step's gradients per
    leaf, the critic's of its first critic update (``grads_d``) and the
    generator's (``grads_g``); each network's parameters after the last
    step (``g``, ``d``, ``ema``). ``waves`` [N, T] and ``pitches`` [N] are
    the cached notes on the device the step runs on. ``q`` rounds every
    conv's and dense layer's operands (a lower precision for the
    control); ``half`` leaves out the second half of every batch (a
    planted fault)."""
    model, t = cfg["model"], cfg["train"]
    n, batch = t["critic_updates"], t["batch_size"]
    dev = waves.device
    g = {k: v.detach().clone().float().requires_grad_() for k, v in
         g_params.items()}
    d = {k: v.detach().clone().float().requires_grad_() for k, v in
         d_params.items()}
    ema = {k: v.detach().clone().float() for k, v in g_params.items()}
    opt_g, opt_d = Adam(g, t), Adam(d, t)
    keep = batch // 2 if half else batch
    out: Dict[str, object] = {"d_loss": [], "g_loss": []}
    with _no_tf32():
        for i in range(steps):
            step = step0 + i
            z_d, u, sh_d, z_g, sh_g = step_noise(
                key, step, batch, model["latent_dim"], n)
            d_losses = []
            for j in range(n):
                idx = torch.from_numpy(batch_indices(
                    key, step * n + j, batch, waves.shape[0])).to(dev)
                wave = waves[idx][:keep]
                real = F.pad(wave, (0, SLICE_LEN - wave.shape[-1]))
                labels = onehot(pitches[idx][:keep], model)
                zj = torch.from_numpy(z_d[j][:keep]).to(dev)
                uj = torch.from_numpy(u[j][:keep]).to(dev)[:, None]
                with torch.no_grad():
                    fake = generator(g, zj, labels, model, q)
                c_real, l_real = critic(d, real, sh_d[j][0], model, q)
                c_fake, l_fake = critic(d, fake, sh_d[j][1], model, q)
                x_hat = (real + uj * (fake - real)).detach().requires_grad_()
                gx, = torch.autograd.grad(
                    critic(d, x_hat, sh_d[j][2], model, q)[0].sum(), x_hat,
                    create_graph=True)
                norms = torch.sqrt(torch.sum(gx * gx, dim=1) + 1e-12)
                gp = torch.mean((norms - 1.0) ** 2)
                d_loss = (torch.mean(c_fake) - torch.mean(c_real)
                          + t["gp_weight"] * gp
                          + t["drift_weight"] * torch.mean(c_real ** 2)
                          + t["aux_pitch_weight"] * (_ce(l_real, labels)
                                                     + _ce(l_fake, labels)))
                grads_d = _grads(d_loss, d)
                opt_d.update(d, grads_d)
                d_losses.append(d_loss.item())
                if i == 0 and j == 0:
                    out["grads_d"] = grads_d
                del gx, c_real, c_fake, l_real, l_fake
            zg = torch.from_numpy(z_g[:keep]).to(dev)
            fake = generator(g, zg, labels, model, q)
            c_fake, l_fake = critic(d, fake, sh_g, model, q)
            g_loss = -torch.mean(c_fake) + t["aux_pitch_weight"] * _ce(
                l_fake, labels)
            grads_g = _grads(g_loss, g)
            opt_g.update(g, grads_g)
            with torch.no_grad():
                decay = t["ema_decay"]
                for k in ema:
                    ema[k] = ema[k] * decay + g[k] * (1.0 - decay)
            out["d_loss"].append(float(np.mean(d_losses)))
            out["g_loss"].append(g_loss.item())
            if i == 0:
                out["grads_g"] = grads_g
            del grads_d, grads_g, c_fake, l_fake
    out.update(g={k: v.detach() for k, v in g.items()},
               d={k: v.detach() for k, v in d.items()}, ema=ema)
    return out


def changes(after: Params, before: Params) -> Dict[str, torch.Tensor]:
    """Each leaf's change, on the host."""
    return {k: (after[k].float() - before[k].to(after[k].device).float())
            .cpu() for k in after}
