"""The one traffic generator: a workload file's ``traffic`` parameters and
a seed -> the requests a run sends.

Every seed gets the same work in another order, so that the seed does not
change what a run measures:

- Notes a request: ``notes_weights`` ({"notes": weight}) is laid out
  exactly in blocks of ``block`` requests (largest remainders), each
  block shuffled by the seed.
- ``"closed"``: ``clients`` clients, each with its own sequence of
  ``requests_per_client_s`` x seconds requests (a client that reaches its
  end starts it again), no think time: a client sends its next request
  when the last one is answered.
- ``"open"``: ``rate_notes_per_s`` notes a second on average, as Poisson
  arrivals with bursts: the window is cut into quiet gaps and bursts of
  ``burst.length_s`` at ``burst.factor`` times the mean rate, as many
  bursts as ``burst.gap_mean_s + burst.length_s`` fit; the gaps are the
  exponential law's quantiles (mean ``gap_mean_s``), shuffled by the
  seed and scaled to fill the window, and the quiet rate makes the mean
  hold over the window. Each segment holds its expected number of
  arrivals at uniform random times.
- Pitches are uniform over ``pitch_range``; a request's seed is uniform
  over 31 bits.
- ``keep``: which answers the client keeps for the reference (drawn from
  the seed, the longest requests among them): ``per_client`` among all
  that a client receives in the window (closed: each client gets a seed
  for ``loadgen.Sample``, since how many it receives is known only at
  the end), or ``count`` requests due in the first nine tenths of the
  window (open).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np


def _sizes(weights: Mapping[str, float], block: int, count: int,
           rng: np.random.Generator) -> np.ndarray:
    notes = sorted(int(k) for k in weights)
    w = np.array([weights[str(n)] for n in notes], np.float64)
    exact = w / w.sum() * block
    per = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - per), kind="stable")[:block - per.sum()]:
        per[i] += 1
    pattern = np.repeat(notes, per)
    blocks = -(-count // block)
    return np.concatenate([rng.permutation(pattern)
                           for _ in range(blocks)])[:count]


def _requests(traffic: Mapping, count: int,
              rng: np.random.Generator) -> List[Dict]:
    lo, hi = traffic["pitch_range"]
    sizes = _sizes(traffic["notes_weights"], traffic["block"], count, rng)
    out = []
    for n in sizes:
        out.append({"pitches": rng.integers(lo, hi + 1, int(n)).tolist(),
                    "seed": int(rng.integers(0, 1 << 31))})
    return out


def _keep(rng: np.random.Generator, sizes: np.ndarray, k: int) -> List[int]:
    """``k`` positions of ``sizes``: half the longest requests, the rest
    any."""
    if k <= 0 or not len(sizes):
        return []
    longest = np.flatnonzero(sizes == sizes.max())
    first = rng.choice(longest, min(len(longest), -(-k // 2)), replace=False)
    rest = np.setdiff1d(np.arange(len(sizes)), first)
    more = rng.choice(rest, min(len(rest), k - len(first)), replace=False)
    return sorted(int(i) for i in np.concatenate([first, more]))


def schedule(traffic: Mapping, seed: int, seconds: float) -> Dict:
    """The run's requests: ``{"mode", "clients": [[request, ...], ...],
    "keep": {"per_client", "seeds": [one a client]}}`` (closed) or
    ``{"mode", "requests": [request with "due" (s from the window's
    start), ...]}`` (open), where a kept request has ``"keep": true``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 0x7AFF1C])
    mode = traffic["mode"]
    keep = traffic.get("keep", {})
    if mode == "closed":
        per = max(1, int(math.ceil(traffic["requests_per_client_s"]
                                   * seconds)))
        clients = [_requests(traffic, per, rng)
                   for _ in range(traffic["clients"])]
        seeds = [int(s) for s in rng.integers(0, 1 << 62, len(clients))]
        return {"mode": mode, "clients": clients,
                "keep": {"per_client": keep.get("per_client", 0),
                         "seeds": seeds}}
    if mode != "open":
        raise ValueError(f"unknown traffic mode {mode!r}")
    b = traffic["burst"]
    weights = traffic["notes_weights"]
    mean_notes = sum(int(k) * v for k, v in weights.items()) / sum(
        weights.values())
    rate = traffic["rate_notes_per_s"] / mean_notes   # requests a second
    m = max(1, int(round(seconds / (b["gap_mean_s"] + b["length_s"]))))
    length = min(b["length_s"], 0.5 * seconds / m)
    q = (np.arange(m) + 0.5) / m
    gaps = rng.permutation(-b["gap_mean_s"] * np.log1p(-q))
    gaps *= (seconds - m * length) / gaps.sum()
    quiet = rate * (seconds - b["factor"] * m * length) / (seconds
                                                          - m * length)
    if quiet < 0:
        raise ValueError("bursts carry more than the mean rate")
    times, t = [], 0.0
    for gap in gaps:
        for start, dur, r in ((t, gap, quiet), (t + gap, length,
                                                b["factor"] * rate)):
            times.append(np.sort(start + dur * rng.random(
                int(round(r * dur)))))
        t += gap + length
    due = np.concatenate(times)
    reqs = _requests(traffic, len(due), rng)
    early = np.flatnonzero(due < 0.9 * seconds)
    sizes = np.array([len(reqs[i]["pitches"]) for i in early])
    for i in _keep(rng, sizes, keep.get("count", 0)):
        reqs[int(early[i])]["keep"] = True
    for r, d in zip(reqs, due):
        r["due"] = float(d)
    return {"mode": mode, "requests": reqs}
