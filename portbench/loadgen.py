"""The load generator, a child process of a serving run: one thread, one
asyncio loop, one TCP connection a request (the service answers
HTTP/1.0 and closes it). Its Python shares nothing with the server's.

Reads one JSON object on standard input: ``host``, ``port``,
``seconds``, ``timeout_s``, ``healthz`` (read ``/healthz`` at the
window's start and end) and the ``schedule`` of ``portbench.traffic``.
Prints ``ready``, reads the window's start (``time.time()``) on the next
line, runs the window, and writes its records as a pickle to standard
output: per request ``(client, index, notes, due, sent, done, status,
bytes)``, where ``due`` is when an open-loop request was due (else when
it was sent) and ``status`` is 0 for a broken exchange, and the bodies
of the kept requests: those the schedule marks (open loop) or each
closed-loop client's :class:`Sample`. No request is sent after the
window closes; those in flight are waited for.
"""

import asyncio
import json
import pickle
import random
import sys
import time


class Sample:
    """The answers a closed-loop client keeps: ``k`` drawn from ``seed``
    uniformly among all it receives (Algorithm R), half of them among
    its longest requests and half among the others (all ``k`` among the
    longest where every request has one length)."""

    def __init__(self, k: int, seed: int, sizes):
        self.rng = random.Random(seed)
        self.longest = max(sizes)
        half = -(-k // 2) if min(sizes) < self.longest else k
        self.size = {True: half, False: k - half}
        self.seen = {True: 0, False: 0}
        self.slots = {True: [], False: []}

    def offer(self, key, notes: int):
        """``(kept, evicted)``: whether the answer ``key`` is kept, and
        the key it pushes out of the sample (or None)."""
        cls = notes == self.longest
        seen, slots, size = self.seen[cls], self.slots[cls], self.size[cls]
        self.seen[cls] += 1
        if len(slots) < size:
            slots.append(key)
            return True, None
        j = self.rng.randrange(seen + 1)
        if j >= size:
            return False, None
        evicted, slots[j] = slots[j], key
        return True, evicted


async def _exchange(host, port, head: bytes, body: bytes, timeout):
    """``(status, body)`` of one request on its own connection."""
    async def go():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(head + body)
            await writer.drain()
            header = await reader.readuntil(b"\r\n\r\n")
            lines = header.decode("latin-1").split("\r\n")
            status = int(lines[0].split()[1])
            length = next(int(v) for k, _, v in
                          (line.partition(":") for line in lines[1:])
                          if k.strip().lower() == "content-length")
            return status, await reader.readexactly(length)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass

    try:
        return await asyncio.wait_for(go(), timeout)
    except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
            ValueError, StopIteration):
        return 0, b""


def _post_head(host, port, length: int) -> bytes:
    return (f"POST /synthesize HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {length}\r\nConnection: close\r\n\r\n"
            ).encode()


async def _healthz(host, port):
    head = f"GET /healthz HTTP/1.1\r\nHost: {host}:{port}\r\n" \
           "Connection: close\r\n\r\n"
    status, body = await _exchange(host, port, head.encode(), b"", 30)
    return json.loads(body) if status == 200 else None


async def _run(spec, t0):
    host, port, timeout = spec["host"], spec["port"], spec["timeout_s"]
    sched, t_end = spec["schedule"], t0 + spec["seconds"]
    # a broken exchange is a record (status 0), not a log line
    asyncio.get_running_loop().set_exception_handler(lambda loop, c: None)
    records, kept = [], {}

    async def send(client, index, req, due, sample=None):
        body = json.dumps({"pitches": req["pitches"],
                           "seed": req["seed"]}).encode()
        sent = time.time()
        status, data = await _exchange(host, port,
                                       _post_head(host, port, len(body)),
                                       body, timeout)
        records.append((client, index, len(req["pitches"]),
                        sent if due is None else due, sent, time.time(),
                        status, len(data)))
        if status != 200:
            return
        if sample is not None:
            keep, evicted = sample.offer((client, index), len(req["pitches"]))
            kept.pop(evicted, None)
        else:
            keep = req.get("keep")
        if keep:
            kept[(client, index)] = data

    async def client(c, reqs):
        k = sched["keep"]
        sample = Sample(k["per_client"], k["seeds"][c],
                        [len(r["pitches"]) for r in reqs])
        i = 0
        while time.time() < t_end:
            await send(c, i, reqs[i % len(reqs)], None, sample)
            i += 1

    await asyncio.sleep(max(0.0, t0 - time.time()))
    health = [await _healthz(host, port)] if spec["healthz"] else []
    if sched["mode"] == "closed":
        tasks = [asyncio.create_task(client(c, reqs))
                 for c, reqs in enumerate(sched["clients"])]
    else:
        tasks = []
        for i, req in enumerate(sched["requests"]):
            due = t0 + req["due"]
            if due >= t_end:
                break
            await asyncio.sleep(max(0.0, due - time.time()))
            tasks.append(asyncio.create_task(send(0, i, req, due)))
    if spec["healthz"]:
        await asyncio.sleep(max(0.0, t_end - time.time()))
        health += [await _healthz(host, port), time.time()]
    await asyncio.gather(*tasks)
    return {"records": records, "kept": kept, "healthz": health}


def main():
    spec = json.loads(sys.stdin.readline())
    sys.stdout.write("ready\n")
    sys.stdout.flush()
    t0 = float(sys.stdin.readline())
    out = asyncio.run(_run(spec, t0))
    sys.stdout.buffer.write(pickle.dumps(out))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
