"""Driver ``http_serve``: the HTTP synthesis service of ``cli serve``,
in the run's own process, under load from a child process.

Set-up restores the configuration's generator, builds
``SynthesisService`` with the configuration's ``service`` settings (it
captures one CUDA graph a rung), serves it with ``make_server`` on
127.0.0.1 at a free port, sends one warm request a rung over HTTP and
starts the load generator (``loadgen.py``, one asyncio thread in a child
process) with the cell's schedule (``traffic.py``). The window runs
``--seconds`` from the first request due. A traced run drives a window
of ``trace_seconds`` instead, inside a profile started and stopped while
the service is idle (a start or stop under load stalls the service for
seconds), and reads ``/healthz`` at the window's start and end.

End to end: ``serve_notes_per_s``, notes whose WAV the client received
inside the window over the window; ``serve_p95_ms``, the 95th percentile
(nearest rank) of every request sent in the window, from when it was
due (open loop) or sent (closed) to its last byte, a failed request
(refused, timed out, broken) counting as missing every limit.

Compared, on a sample of the answered requests drawn from the seed
over the whole window (the longest among them; ``traffic.py``'s
``keep``): each served
note against the reference's PCM for the same seed and pitch, by
``wave`` (relative L2 distance of the samples) and ``spectrum``
(relative L2 distance of the magnitude spectrograms); the numbers are
the 75th percentiles over the sampled notes (``numbers``; PERF.md says
why not the largest).
"""

from __future__ import annotations

import json
import math
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import device as devmod, inputs, traffic
from portbench.reference import nets, serve as ref

HERE = Path(__file__).resolve().parents[1]


def port_config(cfg):
    from gansynth_tpu_torch.utils.config import Config

    return Config().with_overrides({k: cfg[k] for k in
                                    ("audio", "model", "train")})


def start_service(cfg, device):
    """``(service, server, thread, stage)``: the configuration's service,
    served on 127.0.0.1 at a free port."""
    from gansynth_tpu_torch.models.generator import Generator
    from gansynth_tpu_torch.serve import SynthesisService, make_server
    from gansynth_tpu_torch.utils.checkpoint import from_jax_params

    config = port_config(cfg)
    params, _, stage = inputs.load_npz(cfg["weights"])
    g = Generator(config.model)
    g.load_state_dict(from_jax_params(params))
    g = g.to(torch.device(device)).eval()
    s = cfg["service"]
    service = SynthesisService(config, g, stage=stage,
                               max_batch=s["max_batch"],
                               max_queue_notes=s["max_queue_notes"],
                               request_timeout_s=s["request_timeout_s"])
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    return service, server, thread, stage


def stop_service(service, server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(30)
    service.close()


def warm_http(port: int, rungs) -> None:
    for b in rungs:
        body = json.dumps({"pitches": [60] * min(b, 4),
                           "seed": 7 + b}).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize", data=body), timeout=60
        ).read()


def drive(port: int, sched: Dict, t: Dict, seconds: float, healthz: bool,
          trace=None) -> Dict:
    """Runs the load generator over one window and returns its records
    with the window's start ``t0``. With a ``trace``
    (``tracing.Trace``) the profiler starts before the window, while
    the service is idle, and stops after the last answer; the window's
    span marks ``[t0, t0 + seconds]``."""
    with tempfile.TemporaryFile() as err:
        child = subprocess.Popen(
            [sys.executable, str(HERE / "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
        try:
            spec = {"host": "127.0.0.1", "port": port, "seconds": seconds,
                    "timeout_s": t["client_timeout_s"], "healthz": healthz,
                    "schedule": sched}
            child.stdin.write(json.dumps(spec).encode() + b"\n")
            child.stdin.flush()
            if child.stdout.readline().strip() != b"ready":
                raise RuntimeError("the load generator did not start")
            if trace is not None:
                trace.start(span=False)
            t0 = time.time() + 0.05
            child.stdin.write(f"{t0!r}\n".encode())
            child.stdin.close()
            child.stdin = None   # communicate() must not flush it
            if trace is not None:
                time.sleep(max(0.0, t0 - time.time()))
                trace.enter_window()
                time.sleep(max(0.0, t0 + seconds - time.time()))
                trace.exit_window()
            out, _ = child.communicate(timeout=seconds + 180)
            if trace is not None:
                trace.stop()
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if child.returncode:
            err.seek(0)
            raise RuntimeError("the load generator failed: "
                               + err.read().decode()[-2000:])
    res = pickle.loads(out)
    res["t0"] = t0
    return res


def request_of(sched: Dict, client: int, index: int) -> Dict:
    if sched["mode"] == "closed":
        reqs = sched["clients"][client]
        return reqs[index % len(reqs)]
    return sched["requests"][index]


def summarize(res: Dict, seconds: float, miss_ms: float) -> Dict:
    """End-to-end numbers of one window's records."""
    t0, t_end = res["t0"], res["t0"] + seconds
    recs = res["records"]
    lat = sorted((r[5] - r[3]) * 1e3 if r[6] == 200 else math.inf
                 for r in recs)
    failed = sum(r[6] != 200 for r in recs)
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else math.inf
    notes = sum(r[2] for r in recs if r[6] == 200 and r[5] <= t_end)
    late = sorted(r[4] - r[3] for r in recs)
    return {"serve_p95_ms": p95 if math.isfinite(p95) else miss_ms,
            "serve_notes_per_s": notes / seconds,
            "attempted": len(recs), "failed": failed,
            "p50_ms": lat[len(lat) // 2] if lat else math.inf,
            "generator_late_p95_ms": 1e3 * late[
                max(0, math.ceil(0.95 * len(late)) - 1)] if late else 0.0,
            "generator_late_max_ms": 1e3 * late[-1] if late else 0.0}


def sample(res: Dict, sched: Dict, seed: int, count: int) -> List:
    """Up to ``count`` kept answers drawn from the seed, the longest
    first: ``[(request, body)]``."""
    items = sorted(res["kept"].items())
    if not items:
        return []
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 0x5A3F1E])
    reqs = [request_of(sched, c, i) for (c, i), _ in items]
    sizes = np.array([len(r["pitches"]) for r in reqs])
    order = [int(i) for i in rng.permutation(len(items))]
    longest = [i for i in order if sizes[i] == sizes.max()][:1]
    rest = [i for i in order if i not in longest]
    pick = (longest + rest)[:count]
    return [(reqs[i], items[i][1]) for i in pick]


def note_gaps(cfg: Dict, picked: List, stage: int, device,
              q=nets._same, bodies=None) -> Dict[str, List[float]]:
    """Per sampled note, the ``wave`` and ``spectrum`` gap of the served
    PCM (or, with ``bodies``, of those PCM arrays in its place) from the
    reference's; a body that is not the request's WAV reads infinity for
    each of its notes."""
    out = {"wave": [], "spectrum": []}
    if not picked:
        return out
    params, _, _ = inputs.load_npz(cfg["weights"])
    p = {nets.npz_key(k): torch.from_numpy(v).to(device)
         for k, v in params.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds, pitches = [], []
    for req, _ in picked:
        seeds += ref.note_seeds(req["seed"], len(req["pitches"]))
        pitches += req["pitches"]
    waves = ref.render(cfg, p, seeds, pitches, stage, device, q=q)
    length = cfg["audio"]["audio_length"]
    off = 0
    for j, (req, body) in enumerate(picked):
        n = len(req["pitches"])
        expect = ref.pcm(waves[off:off + n])
        off += n
        if bodies is not None:
            served = bodies[j]
        else:
            try:
                served = ref.parse_wav(body, cfg["audio"]["sample_rate"])
            except Exception:
                served = np.zeros(0, np.int16)
        for g in ref.note_gaps(served, expect, n, length):
            for k in out:
                out[k].append(g[k])
    del p
    devmod.free(device)
    return out


def numbers(per_note: Dict[str, List[float]]) -> Dict[str, float]:
    """The candidate numbers of a sample's per-note gaps: the 75th
    percentile (``wave``, ``spectrum``), the median and the largest."""
    out = {}
    for k, v in per_note.items():
        v = np.asarray(v, np.float64)
        if not v.size or not np.isfinite(v).all():
            bad = math.inf if v.size == 0 or not np.isfinite(v).all() else 0
            out.update({k: bad, k + "_median": bad, k + "_max": bad})
            continue
        out.update({k: float(np.quantile(v, 0.75)),
                    k + "_median": float(np.median(v)),
                    k + "_max": float(v.max())})
    return out


def run(ctx) -> Dict:
    from portbench.tracing import Trace, warm_up

    cfg, t = ctx.config, ctx.workload["traffic"]
    if ctx.trace:
        warm_up()
    service, server, thread, stage = start_service(cfg, ctx.device)
    port = server.server_address[1]
    warm_http(port, service.batch_ladder)
    seconds = t["trace_seconds"] if ctx.trace else ctx.seconds
    sched = traffic.schedule(t, ctx.seed, seconds)
    tr = Trace() if ctx.trace else None
    try:
        res = drive(port, sched, t, seconds, ctx.trace, tr)
        dev_info = devmod.info(ctx.device)
    finally:
        stop_service(service, server, thread)
    del service, server
    devmod.free(ctx.device)
    summ = summarize(res, seconds, 1e3 * t["client_timeout_s"])
    out = {"setup_end": res["t0"],
           "end_to_end": {k: summ[k] for k in ("serve_p95_ms",
                                               "serve_notes_per_s")},
           "attempted": summ["attempted"], "failed": summ["failed"],
           "device": dev_info,
           "notes": {k: summ[k] for k in ("p50_ms", "generator_late_p95_ms",
                                          "generator_late_max_ms")}}
    if ctx.trace:
        out["trace"] = tr.reduce()
        h0, h1, h_t = res["healthz"]
        t0, t1 = res["t0"], res["t0"] + seconds
        recs = res["records"]
        out["facts"] = {
            **out["trace"], "model": cfg["model"], "stage": stage,
            "notes": sum(r[2] for r in recs if r[6] == 200
                         and t0 <= r[5] <= t1),
            "batches": (h1["device_batches"] - h0["device_batches"]
                        if h0 and h1 else None),
            "batch_notes": sum(r[2] for r in recs if r[6] == 200
                               and r[5] <= h_t)}
    t_ref = time.perf_counter()
    picked = sample(res, sched, ctx.seed, t["reference_sample"])
    nums = numbers(note_gaps(cfg, picked, stage, ctx.device))
    out["checks"] = {k: nums.get(k, math.inf)
                     for k in ctx.workload.get("limits", {})}
    out["notes"].update(reference_s=time.perf_counter() - t_ref,
                        reference_requests=len(picked),
                        reference_notes=sum(len(r["pitches"])
                                            for r, _ in picked),
                        numbers=nums)
    return out
