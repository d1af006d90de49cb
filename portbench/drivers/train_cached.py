"""Driver ``train_cached``: the cached superstep of ``cli train
--device-cache``, as ``train/loop.py`` calls it.

Set-up builds one training state (the generator and its EMA from the
configuration's weights, the critic from the seed, fresh Adams, the key
of ``train_key(seed mod 2^32)``, the weights' step), fills the device
cache with the benchmark's ``cached_notes`` notes and makes
``make_cached_superstep`` for ``stage``. It drives that state through
the first ``check_steps`` steps with the window's own call (one step a
call, the step's CUDA graph captured at the first), keeping each step's
losses, the first gradients as Adam holds them (its first moment, with
``adam_beta1`` 0) and the parameters' change after the last. The window
then runs supersteps of ``unroll`` steps back to back, one staged ahead
of the one the device runs, until ``--seconds`` are covered;
``train_step_ms`` is its wall time over its steps. A traced run goes on
back to back after the window and traces the device's run of one more
superstep, queued behind another as in the window (:func:`steady_trace`;
the profiler's first start, which stalls the host for seconds, is made
in set-up). After the window the state is
freed and the reference runs the same first steps from the same inputs.

Compared (each by its limit in the workload file; :func:`compare`):
``grad_heads``, the critic's first gradients at its output heads
against the reference's; ``change_median``, the median leaf's gap of the
parameters' change after the first steps. The step's losses, the worst
leaf's change and the other gradient readings are reported in ``notes``
(PERF.md says why they are not compared).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Mapping

import numpy as np
import torch

from portbench import device as devmod, inputs
from portbench.reference import nets, train as ref


def ref_name(port: str) -> str:
    """The port's parameter name -> the published layout's
    (``blocks.6.conv0.weight`` -> ``block_6/conv0/kernel``)."""
    parts, out = port.split("."), []
    while parts:
        p = parts.pop(0)
        if p in ("blocks", "to_rgb", "from_rgb") and parts and \
                parts[0].isdigit():
            p = {"blocks": "block"}.get(p, p) + "_" + parts.pop(0)
        out.append("kernel" if p == "weight" and not parts else p)
    return "/".join(out)


def ref_layout(t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the published layout: OIHW -> HWIO, [out, in] ->
    [in, out]."""
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    return t.t() if t.ndim == 2 else t


def seed32(seed: int) -> int:
    return int(seed) % (1 << 32)


def port_config(cfg: Mapping):
    from gansynth_tpu_torch.utils.config import Config

    return Config().with_overrides({k: cfg[k] for k in
                                    ("audio", "model", "train")})


class Program:
    """The state, the superstep and the cache of one run."""

    def __init__(self, ctx):
        from gansynth_tpu_torch.models.discriminator import Discriminator
        from gansynth_tpu_torch.models.generator import Generator
        from gansynth_tpu_torch.train.state import (TrainState,
                                                    make_optimizer,
                                                    train_key)
        from gansynth_tpu_torch.train.step import make_cached_superstep
        from gansynth_tpu_torch.utils.checkpoint import from_jax_params

        cfg, t = ctx.config, ctx.workload["traffic"]
        self.t = t
        dev = torch.device(ctx.device)
        config = port_config(cfg)
        params, self.step0, _ = inputs.load_npz(cfg["weights"])
        rel = config.train.pitch_consistency_release_step
        if rel is not None and self.step0 >= rel:
            config = config.released()
        g_state = from_jax_params(params)
        g, ema = Generator(config.model), Generator(config.model)
        g.load_state_dict(g_state)
        ema.load_state_dict(g_state)
        g, ema = g.to(dev).train(), ema.to(dev).eval()
        for p in ema.parameters():
            p.requires_grad_(False)
        d_params = inputs.critic_params(cfg["model"], ctx.seed, dev)
        d = Discriminator(config.model)
        d.load_state_dict(from_jax_params(
            {inputs.flax_key(k): v.cpu().numpy() for k, v in
             d_params.items()}))
        d = d.to(dev).train()
        del d_params
        self.waves, self.pitches = inputs.make_notes(
            t["cached_notes"], ctx.seed, cfg["audio"], *t["pitch_range"],
            dev)
        self.state = TrainState(
            g=g, d=d, ema=ema, g_opt=make_optimizer(config, g.parameters()),
            d_opt=make_optimizer(config, d.parameters()),
            rng=train_key(seed32(ctx.seed)), step=self.step0)
        self.superstep = make_cached_superstep(config, t["stage"],
                                               t["cached_notes"])
        self.unroll = int(config.train.unroll)

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
            if i == 0:
                for net, opt, mod in (("g", self.state.g_opt, self.state.g),
                                      ("d", self.state.d_opt, self.state.d)):
                    # Adam's first moment after one step is (1 - b1) times
                    # the gradient; a step that left the state as it was
                    # holds none.
                    b1 = opt.param_groups[0]["b1"]
                    out["grad_" + net] = {
                        ref_name(n): ref_layout(opt.state[p].get(
                            "mu", torch.zeros_like(p)).detach().cpu()
                            / (1.0 - b1)) for n, p in mod.named_parameters()}
        for net, mod in self.nets().items():
            out["change_" + net] = {
                ref_name(n): ref_layout(p.detach().cpu() - before[net][n])
                for n, p in mod.named_parameters()}
        return out


def reference_readings(ctx, step0: int, steps: int, q=nets._same,
                       half: bool = False) -> Dict:
    """The same readings from the plain reference, float32 with TF32 off
    (or under the control's ``q``), from inputs made anew."""
    cfg, t = ctx.config, ctx.workload["traffic"]
    dev = torch.device(ctx.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, _, _ = inputs.load_npz(cfg["weights"])
    g0 = {nets.npz_key(k): torch.from_numpy(v).to(dev)
          for k, v in params.items()}
    d0 = inputs.critic_params(cfg["model"], ctx.seed, dev)
    waves, pitches = inputs.make_notes(t["cached_notes"], ctx.seed,
                                       cfg["audio"], *t["pitch_range"], dev)
    res = ref.run_steps(cfg, g0, d0, waves, pitches,
                        ref.train_key(seed32(ctx.seed)), step0, t["stage"],
                        steps, q=q, half=half)
    host = lambda t: {k: v.detach().cpu() for k, v in t.items()}
    out = {"d_loss": res["d_loss"], "g_loss": res["g_loss"],
           "grad_g": host(res["grads_g"]), "grad_d": host(res["grads_d"]),
           "change_g": ref.changes(res["g"], g0),
           "change_d": ref.changes(res["d"], d0),
           "change_ema": ref.changes(res["ema"], g0)}
    del res, g0, d0, waves, pitches
    devmod.free(dev)
    return out


def leaf_gaps(prog: Mapping, reference: Mapping, keep=None,
              diff: bool = False) -> Dict[str, float]:
    """Per leaf (tensors keyed by leaf), ``|norm_program -
    norm_reference|`` or, with ``diff``, ``norm(program - reference)``,
    over ``max(norm_reference, the median leaf's norm)``."""
    norms = {k: float(v.norm()) for k, v in reference.items()}
    med = float(np.median(list(norms.values())))
    out = {}
    for k, r in reference.items():
        if keep is not None and k not in keep:
            continue
        p = prog.get(k)
        if p is None or p.shape != r.shape or not torch.isfinite(p).all():
            out[k] = math.inf
            continue
        gap = float((p - r).norm()) if diff else abs(float(p.norm())
                                                      - norms[k])
        out[k] = gap / max(norms[k], med, 1e-30)
    return out


def gaps(prog: Mapping, reference: Mapping,
         diff: bool = False) -> Dict[str, Dict[str, float]]:
    """Every leaf's gradient and change gap (``"g/<leaf>"``...), the
    change leaving out leaves whose reference gradient is under a
    thousandth of its network's median leaf."""
    grad, change = {}, {}
    for net in ("g", "d"):
        for k, v in leaf_gaps(prog["grad_" + net], reference["grad_" + net],
                              diff=diff).items():
            grad[f"{net}/{k}"] = v
    for net, src in (("g", "g"), ("d", "d"), ("ema", "g")):
        for k, v in leaf_gaps(prog["change_" + net],
                              reference["change_" + net],
                              moved(reference, src), diff).items():
            change[f"{net}/{k}"] = v
    return {"grad": grad, "change": change}


def moved(reference: Mapping, net: str):
    """The leaves of ``net`` whose reference gradient is at least a
    thousandth of the network's median leaf's: the others move under
    Adam by round-off alone. A leaf with no gradient at all is not used
    (a stage's unused blocks; the rule alone would keep them where they
    are more than half the leaves)."""
    norms = {k: float(v.norm()) for k, v in reference["grad_" + net].items()}
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v > 0 and v >= 1e-3 * med}


def compare(prog: Mapping, reference: Mapping) -> Dict[str, float]:
    """The numbers of a program's (or a stand-in's) readings against the
    reference's. Compared (PERF.md gives the readings and why these):
    ``grad_heads``, the critic's first gradients at its two output heads,
    the larger of ``norm(program - reference) / max(norm_reference,
    median leaf)`` over the score and pitch heads' kernels;
    ``change_median``, the median leaf's gap of the change norms after
    the first steps, over the moved leaves of the three networks.
    Reported beside them: ``loss`` (largest relative gap of a step's
    ``d_loss`` or ``g_loss``), ``grad`` and ``grad_median`` (the
    gradients' gaps of norms, worst and median leaf), ``grad_d`` and
    ``grad_g`` (each network's median moved leaf of the gradients'
    differences) and ``change`` (the worst leaf's gap of the change)."""
    loss = 0.0
    for key in ("d_loss", "g_loss"):
        if len(prog[key]) != len(reference[key]):
            loss = math.inf
            continue
        for p, r in zip(prog[key], reference[key]):
            loss = max(loss, abs(p - r) / max(abs(r), 1.0)
                       if math.isfinite(p) else math.inf)
    norms = gaps(prog, reference)
    diffs = gaps(prog, reference, diff=True)["grad"]
    out = {"loss": loss, "grad_heads": max(diffs["d/critic_head/kernel"],
                                           diffs["d/pitch_head/kernel"])}
    for net in ("d", "g"):
        keep = moved(reference, net)
        out["grad_" + net] = float(np.median(
            [v for k, v in diffs.items() if k.split("/", 1)[0] == net
             and k.split("/", 1)[1] in keep]))
    out["grad"] = max(norms["grad"].values())
    out["grad_median"] = float(np.median(list(norms["grad"].values())))
    out["change"] = max(norms["change"].values())
    out["change_median"] = float(np.median(list(norms["change"].values())))
    return out


def worst_leaves(prog: Mapping, reference: Mapping, n: int = 4) -> Dict:
    """The ``n`` worst leaves of each gap, with both norms."""
    out = {}
    for diff in (False, True):
        for kind, table in gaps(prog, reference, diff).items():
            rows = []
            for key, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]:
                net, leaf = key.split("/", 1)
                src = ("grad_" if kind == "grad" else "change_") + net
                rows.append([key, v, float(prog[src][leaf].norm()),
                             float(reference[src][leaf].norm())])
            out[kind + ("_diff" if diff else "")] = rows
    return out


def steady_trace(prog: Program, device, tr) -> Dict:
    """The reduced trace of one superstep as the window runs it: queued
    behind the one before and staged while that one runs. The profiler
    starts after the superstep before is launched and records only what
    is launched from then on, so the traced window is this superstep's
    run on the device, from its first operation to its last
    (``device_bounds``). Staging the next superstep, which the window
    does meanwhile, only overlaps the host's last launches and is left
    out."""
    prog.call(prog.unroll)
    tr.start()
    prog.call(prog.unroll)
    devmod.sync(device)
    tr.stop()
    return tr.reduce(device_bounds=True)


def run(ctx) -> Dict:
    from portbench.tracing import Trace, warm_up

    t = ctx.workload["traffic"]
    if ctx.trace:
        warm_up()
    prog = Program(ctx)
    readings = prog.first_steps(t["check_steps"])
    unroll = prog.unroll
    devmod.sync(ctx.device)
    setup_end = time.time()
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
    steps = len(events) * unroll
    failed = unroll * sum(not (math.isfinite(float(m["d_loss"]))
                               and math.isfinite(float(m["g_loss"])))
                          for m in means)
    out = {"setup_end": setup_end,
           "end_to_end": {"train_step_ms": 1e3 * window / steps},
           "attempted": steps, "failed": failed}
    if ctx.trace:
        out["trace"] = steady_trace(prog, ctx.device, Trace())
        out["facts"] = {**out["trace"], "steps": unroll,
                        "model": ctx.config["model"], "stage": t["stage"],
                        "batch": ctx.config["train"]["stage_batch_sizes"][
                            t["stage"]]}
    out["device"] = devmod.info(ctx.device)
    step0 = prog.step0
    del prog, means, events
    devmod.free(ctx.device)
    t_ref = time.perf_counter()
    reference = reference_readings(ctx, step0, t["check_steps"])
    numbers = compare(readings, reference)
    limits = ctx.workload.get("limits", {})
    out["checks"] = {k: numbers.get(k, math.inf) for k in limits}
    out["notes"] = {"steps_in_window": steps, "window_s": window,
                    "reference_s": time.perf_counter() - t_ref,
                    "d_loss": readings["d_loss"],
                    "d_loss_reference": reference["d_loss"],
                    "g_loss": readings["g_loss"],
                    "g_loss_reference": reference["g_loss"],
                    "numbers": numbers,
                    "worst_leaves": worst_leaves(readings, reference)}
    return out
