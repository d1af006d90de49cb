"""The port's data-parallel step under CUDA graphs, on the CPU
(``gansynth_tpu_torch/train/step.py``, ``parallel/sharding.py``).

Two gloo ranks (``torch_dp_worker.run_graphs``, which imports no JAX) run
the mesh's supersteps at stage 1 with ``unroll=3``, two supersteps each,
with the capture simulated as ``torch_graph_sim.py`` does it and dry (a
capture runs nothing, as on a card, so each replay reads what the step
reads from its staged row, and a value frozen on the host at the capture
would show at the next step):

- the cached superstep under both cache layouts and both ``--mbstd``
  modes, the plain superstep, and the step at ``unroll=1`` fed by
  ``prefetch_to_mesh`` (two steps): the graphed run equals the eager run
  to the bit in every metric and every state tensor (the networks and
  both Adams' moments), with one capture each, in the ``"thread_local"``
  mode;
- the sharded layout fetches the batches of steps 0 to 5, each from its
  own staged indices (the warm-up's is step 0's);
- the sharded fetch runs the same ops at the same shapes whether the
  batch sits on one owner or spreads over both, and returns the batch's
  rows;
- one rank's state tensors move between supersteps: both ranks capture
  again, and the run still equals the eager one;
- a capture that fails on rank 1 alone raises on both ranks.

The eager and the graphed runs are the same code; the data-parallel step
is held to the reference's mesh by ``test_torch_parallel.py``.
"""

import socket

import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker as worker

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.filterwarnings("ignore::UserWarning")]

WORLD = 2
EQUAL_RUNS = ("cached_replicate", "cached_shard", "cached_per_replica",
              "superstep", "step", "recapture")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_graphs"))
    context = mp.start_processes(worker.run_graphs, nprocs=WORLD,
                                 start_method="spawn", join=False,
                                 args=(WORLD, _free_port(), out))
    try:
        while not context.join(timeout=240):
            pass
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(f"{out}/rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("run", EQUAL_RUNS)
def test_graphed_mesh_superstep_equals_eager(ranks, run):
    for r, got in enumerate(ranks):
        eager, graph = got[run]["eager"], got[run]["graph"]
        assert graph["metrics"] == eager["metrics"], (r, run)
        assert len(graph["state"]) == len(eager["state"])
        for i, (a, b) in enumerate(zip(graph["state"], eager["state"])):
            assert torch.equal(a, b), (r, run, i)
    assert [got[run]["captures"] for got in ranks] == \
        [2 if run == "recapture" else 1] * WORLD
    # the ranks hold one state
    for a, b in zip(ranks[0][run]["graph"]["state"],
                    ranks[1][run]["graph"]["state"]):
        assert torch.equal(a, b)


def test_mesh_step_captures_thread_local(ranks):
    assert [got["modes"] for got in ranks] == [["thread_local"]] * WORLD


def test_sharded_superstep_fetches_each_steps_batch(ranks):
    for got in ranks:
        batches = got["shard_batches"]
        # the warm-up step reads step 0's row, then six replays
        assert batches["fetched"] == batches["want"][:1] + batches["want"]
        assert len({tuple(b) for b in batches["want"]}) > 1


def test_sharded_fetch_has_fixed_shapes(ranks):
    for got in ranks:
        one, spread = got["fetch"]["one_owner"], got["fetch"]["spread"]
        assert one["equal"] and spread["equal"]
        assert one["shapes"] == spread["shapes"]
        assert any("allreduce" in op for op, _ in one["shapes"])


def test_one_ranks_capture_failure_raises_on_every_rank(ranks):
    assert ranks[1]["failure"] == "capture failed on rank 1"
    assert "failed on another rank" in ranks[0]["failure"]
