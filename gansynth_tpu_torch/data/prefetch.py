"""Double-buffered infeed of a data-parallel rank
(``gansynth_tpu/data/nsynth.py:prefetch_to_mesh``).

The reference keeps ``depth`` batches already placed with the mesh's
batch sharding while the step consumes the head of the queue. Here each
rank keeps ``depth`` batches of its rows already on its card: a batch of
the global size is cut to the rank's rows (``--data-parallel``, every
rank reads the global stream), a batch of the local size is taken as it
is (``--multihost``, each process decodes its own slice). On a card the
rows are copied from pinned memory on a side stream, so the copy of batch
i + 1 overlaps the step on batch i; the consumer's stream waits for the
copy before it reads the batch.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from gansynth_tpu_torch.parallel.sharding import rank_rows


def prefetch_to_mesh(it: Iterable[Tuple[np.ndarray, np.ndarray]], mesh,
                     global_batch: int, *, depth: int = 2
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(wave [b, T] float32, pitch [b] int32)`` on ``mesh.device``,
    this rank's ``b`` rows of each batch of ``it``, ``depth`` batches
    ahead."""
    device = mesh.device
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def rows(array, dtype):
        array = rank_rows(mesh, np.asarray(array, dtype), global_batch)
        return torch.from_numpy(np.ascontiguousarray(array))

    def put(wave, pitch):
        wave, pitch = rows(wave, np.float32), rows(pitch, np.int32)
        if side is None:
            return wave.to(device), pitch.to(device), None
        with torch.cuda.stream(side):
            out = (wave.pin_memory().to(device, non_blocking=True),
                   pitch.pin_memory().to(device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        return (*out, done)

    queue = collections.deque()
    it = iter(it)
    for wave, pitch in itertools.islice(it, depth):
        queue.append(put(wave, pitch))
    while queue:
        wave, pitch, done = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(*nxt))
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            # the batch is read on the consumer's stream: keep its memory
            # from the side stream's allocator until that stream is done
            wave.record_stream(stream)
            pitch.record_stream(stream)
        yield wave, pitch
