"""Training watchdog: stall detection and restart from the latest
checkpoint (a copy of ``gansynth_tpu/train/supervisor.py``, whose child is
the port's ``train``).

The failure it guards against is a wedged device call: the training
process stops completing steps but never exits, and the loop cannot save
itself from inside (its thread is blocked in the device call). Recovery is
process-level, which the resume contract is built for: checkpoints restore
the state, stage, alpha and data position, so a kill and restart replays
the lost tail and continues.

:class:`Supervisor` runs ``python -m gansynth_tpu_torch.cli train ...`` as
a child process and watches the run's ``metrics.jsonl`` as a heartbeat
(the loop appends to it at every ``log_every`` crossing after reading a
scalar from the device, so growth proves steps are finishing).
Checkpoint-directory activity counts too: a save can take seconds, and
the final save happens after the last metrics line. When every heartbeat
goes stale for ``max(min_stall_s, stall_factor x median recent
interval)`` the child is killed and restarted, up to ``max_restarts``
times. Before the first heartbeat (start-up, kernel builds) the larger
``startup_grace_s`` applies.

Graceful preemption: SIGTERM to the supervisor (or
:meth:`Supervisor.request_stop`) writes the one-shot ``STOP`` file the
loop polls, waits up to ``stop_grace_s`` for the child to checkpoint and
exit 0, and never restarts past a stop request (a child too wedged to
honour it is killed).

Fault injection for tests: ``GANSYNTH_TRAIN_STALL="<step>:<flagfile>"``
makes the training loop hang once it reaches ``<step>`` unless
``<flagfile>`` exists (it is created on the way into the hang), so a
supervised restart proceeds past it, like a transient wedge.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence


class Supervisor:
    """Watchdog wrapper around the ``train`` CLI subcommand."""

    def __init__(
        self,
        train_argv: Sequence[str],
        model_dir: str,
        *,
        min_stall_s: float = 300.0,
        stall_factor: float = 8.0,
        startup_grace_s: float = 1800.0,
        max_restarts: int = 3,
        poll_s: float = 0.5,
        stop_grace_s: float = 600.0,
        log: Callable[[str], None] = print,
        child_env: Optional[dict] = None,
    ):
        self.train_argv = list(train_argv)
        self.model_dir = model_dir
        self.min_stall_s = float(min_stall_s)
        self.stall_factor = float(stall_factor)
        self.startup_grace_s = float(startup_grace_s)
        self.max_restarts = int(max_restarts)
        self.poll_s = float(poll_s)
        self.stop_grace_s = float(stop_grace_s)
        self.log = log
        self.child_env = child_env
        self.restarts = 0
        self.stalls_detected = 0
        self.stop_requested = False
        self._stop_deadline = float("inf")

    # -- child lifecycle ---------------------------------------------------

    def _spawn(self) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "gansynth_tpu_torch.cli", "train",
               *self.train_argv]
        env = dict(os.environ if self.child_env is None else self.child_env)
        return subprocess.Popen(cmd, env=env)

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        """Terminate, escalate to SIGKILL — by HANDLE only (never by
        process-name pattern: a wedged dispatch ignores SIGTERM)."""
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)

    # -- graceful stop -------------------------------------------------------

    def request_stop(self) -> None:
        """Forward a graceful stop to the child: write the one-shot STOP
        file the training loop polls (see train/loop.py) and stop
        restarting. The child checkpoints at its next superstep boundary
        and exits 0; if it fails to within ``stop_grace_s`` (e.g. it is
        the very wedge the watchdog exists for), it is killed — restart
        never follows a stop request either way. Installed as the SIGTERM
        handler by :meth:`run`, so ``kill <supervisor pid>`` is the
        preemption-safe way to reclaim the device mid-run."""
        if self.stop_requested:
            return  # idempotent: repeated signals do not reset the grace
        self.stop_requested = True
        self._stop_deadline = time.monotonic() + self.stop_grace_s
        path = os.path.join(self.model_dir, "STOP")
        try:
            os.makedirs(self.model_dir, exist_ok=True)
            with open(path, "w") as f:
                f.write("requested via supervisor SIGTERM\n")
        except OSError as e:
            self.log(f"supervisor: could not write STOP file: {e}")
        self.log(
            "supervisor: stop requested — wrote STOP; waiting up to "
            f"{self.stop_grace_s:.0f}s for the child to checkpoint and exit"
        )

    # -- heartbeat ---------------------------------------------------------

    def _stall_limit(self, saw_heartbeat: bool, intervals) -> float:
        if not saw_heartbeat:
            return self.startup_grace_s
        if intervals:
            return max(
                self.min_stall_s,
                self.stall_factor * statistics.median(intervals[-20:]),
            )
        return max(self.min_stall_s, self.startup_grace_s)

    def _signal(self):
        """Liveness snapshot: metrics.jsonl size + checkpoint-dir state
        (top-level entry names/mtimes: the checkpointer commits a save by
        renaming a temporary directory into place, which changes both).
        Any change = beat."""
        metrics = os.path.join(self.model_dir, "metrics.jsonl")
        size = os.path.getsize(metrics) if os.path.exists(metrics) else 0
        ckpts = os.path.join(self.model_dir, "checkpoints")
        entries = ()
        if os.path.isdir(ckpts):
            try:
                entries = tuple(sorted(
                    (e.name, e.stat().st_mtime_ns)
                    for e in os.scandir(ckpts)
                ))
            except OSError:
                pass  # a rename raced the scan; next poll resolves it
        return size, entries

    def _watch(self, proc: subprocess.Popen) -> str:
        """Block until the child exits ('exit') or stalls ('stall' — the
        child has been killed). Heartbeat = metrics.jsonl growth or
        checkpoint-directory activity (see _signal)."""
        last_sig = self._signal()
        last_beat = time.monotonic()
        saw_heartbeat = False
        intervals = []
        while True:
            if proc.poll() is not None:
                return "exit"
            if self.stop_requested and time.monotonic() > self._stop_deadline:
                self.log(
                    "supervisor: child did not honor STOP within "
                    f"{self.stop_grace_s:.0f}s (wedged?); killing it"
                )
                self._kill(proc)
                return "stopkill"
            sig = self._signal()
            now = time.monotonic()
            if sig != last_sig:
                if saw_heartbeat:
                    intervals.append(now - last_beat)
                last_sig, last_beat = sig, now
                saw_heartbeat = True
            elif now - last_beat > self._stall_limit(
                saw_heartbeat, intervals
            ):
                self.stalls_detected += 1
                self.log(
                    f"supervisor: heartbeat stale for "
                    f"{now - last_beat:.1f}s "
                    f"(limit {self._stall_limit(saw_heartbeat, intervals):.1f}s"
                    f"); killing the wedged run"
                )
                self._kill(proc)
                return "stall"
            time.sleep(self.poll_s)

    # -- main --------------------------------------------------------------

    def run(self) -> int:
        """Supervise until the training child exits 0 (returns 0), the
        restart budget is exhausted (returns the child's last nonzero
        code, or 1 after a final stall), or a graceful stop is requested
        (SIGTERM or :meth:`request_stop` — returns the child's exit code;
        never restarts past a stop request)."""
        import signal
        import threading

        prev_handler = None
        in_main = threading.current_thread() is threading.main_thread()
        if in_main:
            # `kill <supervisor pid>` == graceful preemption. Handlers are
            # main-thread-only; embedded (threaded) supervisors use
            # request_stop() directly.
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.request_stop()
            )
        try:
            return self._run()
        finally:
            if in_main:
                signal.signal(signal.SIGTERM, prev_handler)

    def _run(self) -> int:
        while True:
            proc = self._spawn()
            outcome = self._watch(proc)
            if outcome == "exit" and proc.returncode == 0:
                return 0
            if self.stop_requested:
                # A stop request ends supervision regardless of how the
                # child went down: honored-then-exited-nonzero keeps the
                # child's code; killed-past-grace reports failure.
                why = (
                    "was killed past the stop grace"
                    if outcome == "stopkill"
                    else f"exited {proc.returncode} after the stop request"
                )
                self.log(f"supervisor: child {why}; not restarting")
                return 1 if outcome == "stopkill" else (proc.returncode or 1)
            why = (
                "stalled"
                if outcome == "stall"
                else f"exited {proc.returncode}"
            )
            if self.restarts >= self.max_restarts:
                self.log(
                    f"supervisor: child {why}; restart budget "
                    f"({self.max_restarts}) exhausted — giving up"
                )
                return proc.returncode or 1
            self.restarts += 1
            self.log(
                f"supervisor: child {why}; restarting from the latest "
                f"checkpoint ({self.restarts}/{self.max_restarts})"
            )


def model_dir_from_argv(argv: Sequence[str]) -> str:
    """Extract ``--model-dir`` from a forwarded train argv."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--model-dir" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--model-dir="):
            return a.split("=", 1)[1]
    raise ValueError("supervised train args must include --model-dir")
