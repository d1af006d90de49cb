"""Driver ``train_wavegan``: WaveGAN's cached superstep as ``cli train
--device-cache`` runs it (``train/loop.py``): each step one CUDA graph
replay of ``critic_updates`` critic updates, the generator update and
the EMA, in supersteps of ``unroll`` steps.

Set-up builds one training state from the seed: G and D drawn by the
reference's ``draw_params`` (the EMA a copy of G), fresh Adams, the key
of ``train_key(seed mod 2^32)``, step 0. It fills the device cache with
``cached_notes`` notes (``inputs.make_notes``, 64000 samples, which the
step pads to 65536), makes ``make_cached_superstep`` and drives the
state through the first ``check_steps`` steps with the window's own
call (one step a call, the step's graph captured at the first), keeping
each step's losses, the first step's gradients and the parameters'
change after the last. The critic's gradients are those of the step's
first critic update, taken before any Adam update moves the critic
(:class:`FirstGrads`: hooks on its parameters copy them inside the
step's graph); the later updates' gradients, and Adam's first moment,
which mixes all five with beta1 = 0.5, follow trajectories that the
first updates' sign-like Adam steps have already parted, and read as far
from the reference at bf16 as at float8. The generator's are its
update's, as the step leaves them in ``.grad``. The window then runs
supersteps back to back, one staged ahead of the one the device runs,
until ``--seconds`` are covered; ``train_step_ms`` is its wall time over
its steps. The program's step phases (``StepPhases``) are read after
set-up's last synchronise, anchored just before the window and read
again after its last synchronise: ``facts["phases"]`` holds the
window's critic-phase device ns and critic updates. A traced run then
traces the device's run of one more superstep, queued behind another
as in the window, and waits 50 ms after the device is done before it
stops the profiler, so that no kernel of the superstep's tail is lost
to the profiler's clock conversion (PERF.md). After the window the state
is freed and the reference runs the same first steps from the same
inputs.

Compared (each by its limit in the workload file; ``train_cached``'s
``compare``): ``grad_heads``, the critic's first gradients at its two
heads against the reference's; ``change_median``, the median moved leaf's gap
of the parameters' change over G, D and the EMA.
"""

from __future__ import annotations

import copy
import math
import time
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from portbench import device as devmod, harness, inputs
from portbench.reference import wavegan as ref

HERE = Path(__file__).resolve().parents[1]
PAUSE_S = 0.05
# the flagship cell's comparison, which this cell shares
_cached = harness.load_module(HERE / "drivers" / "train_cached.py")
compare, worst_leaves = _cached.compare, _cached.worst_leaves


def ref_name(port: str) -> str:
    """``downconv_0.weight`` -> ``downconv_0/kernel``."""
    layer, leaf = port.rsplit(".", 1)
    return f"{layer}/{'kernel' if leaf == 'weight' else leaf}"


def ref_layout(t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the reference's (TF's) layout: axes reversed."""
    return t.permute(*range(t.ndim - 1, -1, -1))


def seed32(seed: int) -> int:
    return int(seed) % (1 << 32)


def port_config(cfg: Mapping):
    from gansynth_tpu_torch.utils.config import Config

    return Config().with_overrides({k: cfg[k] for k in
                                    ("audio", "model", "train")})


def plain_groups(cfg: Mapping):
    """The reference's ``model`` and ``train`` settings, the port's
    defaults under the configuration's."""
    import dataclasses

    config = port_config(cfg)
    return {"model": dataclasses.asdict(config.model),
            "train": dataclasses.asdict(config.train)}


def draw(ctx):
    """``(G, D)`` for the run's seed, on its device, keyed as the
    reference keys them."""
    return ref.draw_params(plain_groups(ctx.config)["model"], ctx.seed,
                           torch.device(ctx.device))


def notes(ctx):
    t = ctx.workload["traffic"]
    return inputs.make_notes(t["cached_notes"], ctx.seed,
                             ctx.config["audio"], *t["pitch_range"],
                             torch.device(ctx.device))


class Program:
    """The state, the superstep and the cache of one run."""

    def __init__(self, ctx, config=None):
        from gansynth_tpu_torch.models.wavegan import (
            WaveGANDiscriminator,
            WaveGANGenerator,
        )
        from gansynth_tpu_torch.train.state import (TrainState,
                                                    make_optimizer,
                                                    train_key)
        from gansynth_tpu_torch.train.step import make_cached_superstep
        from gansynth_tpu_torch.utils.checkpoint import from_jax_params
        from gansynth_tpu_torch.utils.device import set_precision

        config = config or port_config(ctx.config)
        set_precision()   # as cli train does
        dev = torch.device(ctx.device)
        g0, d0 = draw(ctx)
        nets = []
        for cls, params in ((WaveGANGenerator, g0),
                            (WaveGANDiscriminator, d0)):
            net = cls(config.model)
            net.load_state_dict(from_jax_params(
                {inputs.flax_key(k): v.cpu().numpy()
                 for k, v in params.items()}))
            nets.append(net.to(dev).train())
        g, d = nets
        ema = copy.deepcopy(g).eval()
        for p in ema.parameters():
            p.requires_grad_(False)
        del g0, d0
        self.waves, self.pitches = notes(ctx)
        self.state = TrainState(
            g=g, d=d, ema=ema, g_opt=make_optimizer(config, g.parameters()),
            d_opt=make_optimizer(config, d.parameters()),
            rng=train_key(seed32(ctx.seed)), step=0)
        self.superstep = make_cached_superstep(
            config, 0, ctx.workload["traffic"]["cached_notes"])
        self.unroll = int(config.train.unroll)
        self.first_grads = FirstGrads(d, config.train.critic_updates)

    @property
    def phases(self):
        return self.superstep.program.phases

    def nets(self):
        s = self.state
        return {"g": s.g, "d": s.d, "ema": s.ema}

    def call(self, k: int):
        self.state, metrics = self.superstep(
            self.state, self.waves, self.pitches, np.ones(k, np.float32))
        return metrics

    def first_steps(self, steps: int) -> Dict:
        """The readings of the first ``steps`` steps, one a call."""
        before = {net: {n: p.detach().cpu().clone()
                        for n, p in m.named_parameters()}
                  for net, m in self.nets().items()}
        out = {"d_loss": [], "g_loss": []}
        for i in range(steps):
            m = self.call(1)
            out["d_loss"].append(float(m["d_loss"]))
            out["g_loss"].append(float(m["g_loss"]))
            if i == 0:   # copies: the next steps write these buffers
                out["grad_d"] = {ref_name(n): ref_layout(b.cpu().clone())
                                 for n, b in self.first_grads.bufs.items()}
                out["grad_g"] = {
                    ref_name(n): ref_layout(torch.zeros_like(p).cpu()
                                            if p.grad is None
                                            else p.grad.float().cpu().clone())
                    for n, p in self.state.g.named_parameters()}
        for net, mod in self.nets().items():
            out["change_" + net] = {
                ref_name(n): ref_layout(p.detach().cpu() - before[net][n])
                for n, p in mod.named_parameters()}
        return out


class FirstGrads:
    """The critic's gradients of each step's first critic update, in
    buffers of their own (``bufs``, by parameter name). Autograd calls a
    parameter's hook once a critic update (the penalty's input gradient
    does not reach the parameters), and each hook copies every
    ``updates``-th gradient, the first of each step. The hooks run while
    the step's CUDA graph is captured, so the copies are captured with the
    backward and every replay refreshes the buffers: 288 MB a step at d =
    64, a copy of ~0.1 ms beside a step of ~1 s."""

    def __init__(self, module, updates: int):
        self.bufs = {}
        for name, p in module.named_parameters():
            self.bufs[name] = torch.zeros_like(p)
            p.register_hook(self._hook(self.bufs[name], updates))

    @staticmethod
    def _hook(buf, updates: int):
        calls = [0]

        def hook(grad):
            if calls[0] % updates == 0:
                buf.copy_(grad)
            calls[0] += 1

        return hook


def reference_readings(ctx, steps: int, q=ref._same,
                       half: bool = False) -> Dict:
    """The same readings from the plain reference, float32 with TF32 off
    (or under the control's ``q``), from inputs made anew."""
    g0, d0 = draw(ctx)
    waves, pitches = notes(ctx)
    res = ref.run_steps(plain_groups(ctx.config), g0, d0, waves, pitches,
                        ref.train_key(seed32(ctx.seed)), 0, steps, q=q,
                        half=half)
    host = lambda t: {k: v.detach().cpu() for k, v in t.items()}
    out = {"d_loss": res["d_loss"], "g_loss": res["g_loss"],
           "grad_g": host(res["grads_g"]), "grad_d": host(res["grads_d"]),
           "change_g": ref.changes(res["g"], g0),
           "change_d": ref.changes(res["d"], d0),
           "change_ema": ref.changes(res["ema"], g0)}
    del res, g0, d0, waves, pitches
    devmod.free(ctx.device)
    return out


def phase_delta(now: Mapping, before: Mapping) -> Dict:
    """The window's critic-phase ns and critic updates (an empty dict
    from a program that does not count critic updates)."""
    if "critic_updates" not in now:
        return {}
    return {k: now[k] - before[k] for k in ("critic_ns", "critic_updates",
                                            "steps")}


def steady_trace(prog: Program, device, tr) -> Dict:
    """The reduced trace of one superstep as the window runs it: queued
    behind the one before, traced from its first operation to its last
    on the device (``device_bounds``), with :data:`PAUSE_S` on the host
    between the device's last operation and the profiler's stop."""
    prog.call(prog.unroll)
    tr.start()
    prog.call(prog.unroll)
    devmod.sync(device)
    time.sleep(PAUSE_S)
    tr.stop()
    return tr.reduce(device_bounds=True)


def run(ctx) -> Dict:
    from portbench.tracing import Trace, warm_up

    t = ctx.workload["traffic"]
    config = port_config(ctx.config)   # fails fast on a port without it
    if ctx.trace:
        warm_up()
    prog = Program(ctx, config)
    readings = prog.first_steps(t["check_steps"])
    unroll = prog.unroll
    devmod.sync(ctx.device)
    setup_end = time.time()
    before = prog.phases.read()
    prog.phases.anchor()
    means, events = [], []
    t0 = time.perf_counter()
    while True:
        means.append(prog.call(unroll))
        events.append(devmod.Marker(ctx.device))
        if len(events) > 1:
            events[-2].wait()
            elapsed = time.perf_counter() - t0
            done = len(events) - 1
            if elapsed * (done + 1) / done >= ctx.seconds:
                break
    devmod.sync(ctx.device)
    window = time.perf_counter() - t0
    phases = phase_delta(prog.phases.read(), before)
    steps = len(events) * unroll
    failed = unroll * sum(not (math.isfinite(float(m["d_loss"]))
                               and math.isfinite(float(m["g_loss"])))
                          for m in means)
    out = {"setup_end": setup_end,
           "end_to_end": {"train_step_ms": 1e3 * window / steps},
           "attempted": steps, "failed": failed}
    if ctx.trace:
        out["trace"] = steady_trace(prog, ctx.device, Trace())
        out["facts"] = {**out["trace"], "steps": unroll, "phases": phases,
                        "model": plain_groups(ctx.config)["model"],
                        "batch": config.train.batch_size,
                        "critic_updates": config.train.critic_updates}
    out["device"] = devmod.info(ctx.device)
    del prog, means, events
    devmod.free(ctx.device)
    t_ref = time.perf_counter()
    reference = reference_readings(ctx, t["check_steps"])
    numbers = compare(readings, reference)
    limits = ctx.workload.get("limits", {})
    out["checks"] = {k: numbers.get(k, math.inf) for k in limits}
    out["notes"] = {"steps_in_window": steps, "window_s": window,
                    "reference_s": time.perf_counter() - t_ref,
                    "phases": phases,
                    "d_loss": readings["d_loss"],
                    "d_loss_reference": reference["d_loss"],
                    "g_loss": readings["g_loss"],
                    "g_loss_reference": reference["g_loss"],
                    "numbers": numbers,
                    "worst_leaves": worst_leaves(readings, reference)}
    return out
