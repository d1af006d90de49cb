"""Synthesis server: HTTP in, WAV out (``gansynth_tpu/serve.py``).

- ``POST /synthesize`` with JSON ``{"pitches": [60, 72], "seed": 0}`` ->
  ``audio/wav`` body (notes concatenated), or with ``"format": "json"`` ->
  base64 WAV and metadata.
- ``GET /healthz`` -> liveness, model info and the coalescing counters.

The sampler is warmed at startup for a ladder of batch sizes (1, 4, ...,
max_batch). Concurrent requests coalesce: a daemon batcher thread drains
whatever requests wait while the device is busy, packs their notes into
the smallest rung that fits and runs one generator + synthesis batch for
all of them. Note i of a request with seed s takes the latent of seed
``(s * 1000003 + i) & 0x7FFFFFFF``, so its audio does not depend on what
it was batched with (up to the last float bits between rungs).

A full queue answers 429, a request not served in time 504 (and is
abandoned, never served late).

The service runs either a restored generator through the in-process
seeded sampler or a loaded ``.gsx`` artifact (``synth/export.py``,
``cli serve --from-exported``), with no generator in the service.
"""

from __future__ import annotations

import base64
import collections
import io
import json
import threading
import time
import wave as wavmod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from gansynth_tpu_torch.utils.config import Config


class ServiceOverloadedError(RuntimeError):
    """Queue is at capacity — the client should back off (HTTP 429)."""


class RequestTimeoutError(RuntimeError):
    """The request did not complete in time (HTTP 504). The request is
    abandoned, never served late."""


class _Request:
    __slots__ = ("seeds", "pitches", "done", "result", "error", "abandoned")

    def __init__(self, seeds, pitches):
        self.seeds = seeds
        self.pitches = pitches
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False


def batch_ladder(max_batch: int) -> Tuple[int, ...]:
    """The batch rungs the service pads to: 1, 4, 16, ... below
    ``max_batch``, then ``max_batch``."""
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 4
    return tuple(ladder) + (max_batch,)


class SynthesisService:
    """The warmed seeded sampler and the coalescing batcher.

    ``generator`` is the port's ``Generator`` with its weights, on the
    device the service runs on; or ``generator`` is None and ``exported``
    a loaded artifact (``synth.export.ExportedSampler``) with a symbolic
    batch, whose program every rung calls. Call :meth:`close` to stop the
    batcher.
    """

    def __init__(
        self,
        config: Config,
        generator: Optional[torch.nn.Module],
        *,
        stage: Optional[int] = None,
        max_batch: int = 16,
        max_queue_notes: int = 256,
        request_timeout_s: float = 30.0,
        exported=None,
    ):
        from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

        self.config = config
        self.max_queue_notes = max_queue_notes
        self.request_timeout_s = request_timeout_s
        self.exported = exported is not None
        if exported is not None:
            if exported.meta.get("batch") != "symbolic":
                raise ValueError(
                    "serving needs a symbolic-batch artifact (export "
                    "without --batch); this one is pinned to batch "
                    f"{exported.meta.get('batch')}")
            self.device = exported.device
            self._sample = exported
        else:
            self.device = next(generator.parameters()).device
            self._sample = make_seeded_sampler(config, generator, stage=stage)
        self.max_batch = max_batch
        self.batch_ladder = batch_ladder(max_batch)
        self.requests_served = 0
        self.coalesced_batches = 0
        self.device_batches = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self._queued_notes = 0      # notes waiting in _queue
        self._in_flight_notes = 0   # notes inside the current device call

        self.warm_latency_s = {}
        for b in self.batch_ladder:
            self._run_device([0] * b, [60] * b)     # first call: builds, tunes
            t0 = time.perf_counter()
            self._run_device([0] * b, [60] * b)     # warm (host end to end)
            self.warm_latency_s[b] = round(time.perf_counter() - t0, 4)

        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True,
                                         name="synthesis-batcher")
        self._batcher.start()

    def _run_device(self, seeds, pitches) -> np.ndarray:
        # .cpu() waits for the device: honest request latency.
        return self._sample(seeds, pitches).cpu().numpy()

    def rung_for(self, n: int) -> int:
        """Smallest warmed batch that fits an n-note request."""
        for b in self.batch_ladder:
            if n <= b:
                return b
        raise ValueError(f"at most {self.max_batch} pitches per request")

    def _batch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                batch = []
                n = 0
                # Coalesce whatever is already waiting, up to the largest
                # rung. Requests never split across batches; abandoned
                # (timed-out) requests are dropped here, not served.
                while self._queue and (
                    not batch
                    or n + len(self._queue[0].pitches) <= self.max_batch
                ):
                    req = self._queue.popleft()
                    self._queued_notes -= len(req.pitches)
                    if req.abandoned:
                        continue
                    n += len(req.pitches)
                    batch.append(req)
                if not batch:
                    continue
                self._in_flight_notes = n
            try:
                rung = self.rung_for(n)
                seeds = [s for r in batch for s in r.seeds]
                pitches = [p for r in batch for p in r.pitches]
                pad = rung - n
                waves = self._run_device(
                    seeds + [0] * pad,
                    pitches + [self.config.model.pitch_min] * pad,
                )
                off = 0
                for r in batch:
                    r.result = waves[off:off + len(r.pitches)]
                    off += len(r.pitches)
                with self._cond:
                    self.requests_served += len(batch)
                    self.device_batches += 1
                    if len(batch) > 1:
                        self.coalesced_batches += 1
            except Exception as e:  # raised again on the request's thread
                for r in batch:
                    r.error = e
            finally:
                with self._cond:
                    self._in_flight_notes = 0
            for r in batch:
                r.done.set()

    def synthesize(
        self, pitches, seed: int = 0, timeout_s: Optional[float] = None
    ) -> np.ndarray:
        """[len(pitches), 64000] float32.

        Raises :class:`ServiceOverloadedError` when the queue is full and
        :class:`RequestTimeoutError` when the request is not served within
        ``timeout_s`` (default: the service's ``request_timeout_s``).
        """
        if not pitches:
            raise ValueError("pitches must be non-empty")
        if len(pitches) > self.max_batch:
            raise ValueError(f"at most {self.max_batch} pitches per request")
        lo, hi = self.config.model.pitch_min, self.config.model.pitch_max
        for p in pitches:
            if not lo <= int(p) <= hi:
                raise ValueError(f"pitch {p} outside [{lo}, {hi}]")
        seeds = [
            (int(seed) * 1000003 + i) & 0x7FFFFFFF
            for i in range(len(pitches))
        ]
        req = _Request(seeds, [int(p) for p in pitches])
        with self._cond:
            if self._closed:
                raise RuntimeError("the synthesis service is closed")
            if self._queued_notes + len(pitches) > self.max_queue_notes:
                self.requests_rejected += 1
                raise ServiceOverloadedError(
                    f"queue full ({self._queued_notes} notes waiting, "
                    f"limit {self.max_queue_notes}); retry later"
                )
            self._queue.append(req)
            self._queued_notes += len(pitches)
            self._cond.notify()
        timeout = self.request_timeout_s if timeout_s is None else timeout_s
        if not req.done.wait(timeout):
            with self._cond:
                req.abandoned = True
                self.requests_timed_out += 1
            raise RequestTimeoutError(
                f"request not served within {timeout:.1f}s "
                "(device stalled or overloaded)"
            )
        if req.error is not None:
            raise req.error
        return req.result

    def health(self) -> dict:
        """The ``/healthz`` body."""
        with self._cond:
            return {
                "status": "ok",
                "device": str(self.device),
                "max_batch": self.max_batch,
                "batch_ladder": list(self.batch_ladder),
                "warm_latency_s": {
                    str(k): v for k, v in self.warm_latency_s.items()
                },
                "requests_served": self.requests_served,
                "device_batches": self.device_batches,
                "coalesced_batches": self.coalesced_batches,
                "requests_rejected": self.requests_rejected,
                "requests_timed_out": self.requests_timed_out,
                "queued_notes": self._queued_notes,
                "in_flight_notes": self._in_flight_notes,
                "max_queue_notes": self.max_queue_notes,
                "request_timeout_s": self.request_timeout_s,
                "num_pitches": self.config.model.num_pitches,
                "sample_rate": self.config.audio.sample_rate,
                "exported_artifact": self.exported,
                # A note's audio is a function of (weights, seed, pitch) per
                # batch rung; two rungs may differ in the last float bits.
                "determinism": "per-rung",
            }

    def wav_bytes(self, waves: np.ndarray) -> bytes:
        buf = io.BytesIO()
        pcm = (np.clip(waves.reshape(-1), -1, 1) * 32767).astype(np.int16)
        with wavmod.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.config.audio.sample_rate)
            f.writeframes(pcm.tobytes())
        return buf.getvalue()

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the batcher thread (after the batch it is running)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._batcher.join(timeout_s)


def make_server(service: SynthesisService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not run) the HTTP server; ``.server_address`` has the port.
    Its handler threads are daemon threads."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, service.health())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                pitches = [int(p) for p in req.get("pitches", [])]
                seed = int(req.get("seed", 0))
                waves = service.synthesize(pitches, seed)
                wav = service.wav_bytes(waves)
                if req.get("format") == "json":
                    self._json(200, {
                        "num_notes": len(pitches),
                        "sample_rate": service.config.audio.sample_rate,
                        "wav_base64": base64.b64encode(wav).decode(),
                    })
                else:
                    self._reply(200, wav, "audio/wav")
            except ServiceOverloadedError as e:
                self._json(429, {"error": str(e)})
            except RequestTimeoutError as e:
                self._json(504, {"error": str(e)})
            except json.JSONDecodeError:
                # Before ValueError: JSONDecodeError subclasses it.
                self._json(400, {"error": "invalid JSON body"})
            except ValueError as e:
                self._json(400, {"error": str(e)})

    # Threaded: handlers block on the coalescing queue, so concurrency at
    # the HTTP layer is what lets batches form under load.
    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def serve_forever(service: SynthesisService, host: str, port: int) -> None:
    """Run the server in this thread until interrupted, then shut down."""
    server = make_server(service, host, port)
    print(f"serving on http://{server.server_address[0]}:"
          f"{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
