"""One rank of the port's data-parallel CPU tests (``test_torch_parallel.py``,
``test_torch_dp_graphs.py``).

Imports torch, numpy and the port, never JAX: the test spawns W of these
(``torch.multiprocessing``, start method ``spawn``) into one gloo group.
:func:`run_graphs` is the rank of ``test_torch_dp_graphs.py``: the mesh's
supersteps under simulated CUDA graphs (``torch_graph_sim.py``) against
the same supersteps run eagerly.
Each rank reads the inputs the test wrote (the reference's initial
weights, the batch, the reference's noise of the first three steps and
its real images), runs
every scenario, and saves what it ends with to ``<out>/rank<r>.pt``.

The reference's real images are handed over, as in
``torch_step_parity.py`` (the two frontends differ in the phase of
near-silent bins): the step's frontend is replaced by a lookup of each
wave row in the dataset the test wrote.
"""

import os
import sys

import numpy as np
import torch

STAGE = 1
TINY = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=16, fmap_min=8),
        "train": dict(batch_size=8, fade_steps=4, stable_steps=4)}


def config(**model):
    from gansynth_tpu_torch.utils.config import Config

    return Config().with_overrides(
        {"model": {**TINY["model"], **model}, "train": TINY["train"]})


def _state(cfg, inputs):
    """The port's state holding the reference's initial weights."""
    from gansynth_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, seed=0, device="cpu")
    for net in ("g", "d", "ema"):
        src = "d" if net == "d" else "g"
        getattr(state, net).load_state_dict(
            {k[2:]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith(src + "/")})
    return state


def _result(state, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "step": int(state.step),
            **{net: {k: v.detach().clone()
                     for k, v in getattr(state, net).state_dict().items()}
               for net in ("g", "d", "ema")}}


def run(rank: int, world: int, port: int, inputs_path: str, out: str):
    # TensorFlow, when installed, takes seconds to import under
    # torch.utils.tensorboard: rank 0's loop runs without it, as on the
    # card's machine.
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    from gansynth_tpu_torch.parallel import sharding
    from gansynth_tpu_torch.train import step as tstep
    from gansynth_tpu_torch.train.loop import train

    sharding.initialize_multihost(torch.device("cpu"),
                                  f"tcp://127.0.0.1:{port}", rank, world)
    inputs = np.load(inputs_path)
    table = {w.tobytes(): img for w, img in zip(inputs["data_waves"],
                                                inputs["data_images"])}
    frontend = tstep.real_image_for_stage
    tstep.real_image_for_stage = lambda wave, stage, cfg: torch.from_numpy(
        np.stack([table[w.tobytes()] for w in wave.numpy()]))
    # the reference's noise of steps 0, 1 and 2 (global batch)
    tstep.step_noise = lambda rng, step, batch, latent: {
        k: inputs[f"{k}{step}"] for k in ("z_d", "u", "z_g")}
    mesh = sharding.make_mesh()
    waves, pitch = inputs["waves"], inputs["pitch"]
    noise = {k: torch.from_numpy(inputs[f"{k}0"]) for k in ("z_d", "u",
                                                            "z_g")}
    results = {}

    def one_step(name, cfg, mesh_):
        state = sharding.replicate_on_mesh(mesh_, _state(cfg, inputs))
        w, p = sharding.shard_train_inputs(mesh_, waves, pitch)
        state, m = tstep.make_train_step(cfg, STAGE, mesh_)(
            state, w, p, 0.7, **noise)
        results[name] = _result(state, m)

    one_step("step", config(), mesh)
    one_step("per_replica", config(mbstd_replicas=world), mesh)
    if world == 4:
        one_step("multislice", config(), sharding.make_multislice_mesh(2))

    # The supersteps, and on rank 0 the same supersteps in this process
    # alone (no mesh) on the global batches.
    cfg = config()
    chunk_w, chunk_p = inputs["chunk_waves"], inputs["chunk_pitches"]
    for name, mesh_ in (("superstep", mesh), ("one_superstep", None)):
        if mesh_ is None and rank:
            continue
        rows = slice(None) if mesh_ is None else mesh.rows(chunk_w.shape[1])
        state = _state(cfg, inputs)
        state, m = tstep.make_superstep(cfg, STAGE, mesh_)(
            state, torch.from_numpy(chunk_w[:, rows]),
            torch.from_numpy(chunk_p[:, rows]), inputs["alphas"])
        results[name] = _result(state, m)

    all_w, all_p = inputs["data_waves"], inputs["data_pitches"]
    for layout in ("replicate", "shard"):
        cfg = config().with_overrides(
            {"train": {"device_cache_layout": layout}})
        part = mesh.rows(len(all_w)) if layout == "shard" else slice(None)
        state = _state(cfg, inputs)
        state, m = tstep.make_cached_superstep(cfg, STAGE, len(all_w), mesh)(
            state, torch.from_numpy(all_w[part]),
            torch.from_numpy(all_p[part]), inputs["alphas"])
        results[f"cached_{layout}"] = _result(state, m)
    if rank == 0:
        state = _state(cfg, inputs)
        state, m = tstep.make_cached_superstep(cfg, STAGE, len(all_w))(
            state, torch.from_numpy(all_w), torch.from_numpy(all_p),
            inputs["alphas"])
        results["one_cached"] = _result(state, m)

    # STOP present in rank 1's run directory only (another host's disk):
    # every rank stops at the first log crossing.
    tstep.real_image_for_stage = frontend
    workdir = os.path.join(out, f"stop_rank{rank}")
    os.makedirs(workdir, exist_ok=True)
    if rank == 1:
        open(os.path.join(workdir, "STOP"), "w").close()
    cfg = config().with_overrides({"train": {"log_every": 2,
                                             "checkpoint_every": 100}})
    state = train(cfg, None, num_steps=6, workdir=workdir, mesh=mesh,
                  device_dataset=(all_w, all_p))
    results["stop"] = {"step": int(state.step),
                       "stop_left": os.path.exists(
                           os.path.join(workdir, "STOP")),
                       "checkpoints": sorted(os.listdir(
                           os.path.join(workdir, "checkpoints")))}
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# --- the mesh under CUDA graphs simulated on the CPU --------------------
# (test_torch_dp_graphs.py): stage 1, unroll 3, two supersteps of 3 steps.
GRAPH_NOTES = 16
GRAPH_ALPHAS = ([0.25, 0.5, 0.75], [1.0, 1.0, 1.0])


def _state_arrays(state):
    """Every tensor a step updates (the networks and both Adams'
    moments), in a fixed order."""
    from gansynth_tpu_torch.train.step import _state_tensors

    return [t.detach().clone() for t in _state_tensors(state)]


def _supersteps(make, state, data, on_step=None):
    """Both supersteps of ``make()``'s superstep from ``state``: the
    metrics of each and the state's tensors after them. ``on_step(i,
    state)`` runs before superstep i."""
    fn, metrics = make(), []
    for i, alphas in enumerate(GRAPH_ALPHAS):
        if on_step is not None:
            on_step(i, state)
        state, m = fn(state, *data(i), alphas)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": _state_arrays(state)}


class _Shapes:
    """Every op's output shapes under a dispatch mode, in order."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                seen.append((str(func), [tuple(t.shape) for t in
                                         tree_flatten(out)[0]
                                         if torch.is_tensor(t)]))
                return out

        self.mode = Mode()


def run_graphs(rank: int, world: int, port: int, out: str):
    sys.modules["tensorflow"] = None
    torch.set_num_threads(1)
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.parallel import sharding
    from gansynth_tpu_torch.train import step as tstep
    from gansynth_tpu_torch.train.state import create_train_state
    import torch_graph_sim

    sharding.initialize_multihost(torch.device("cpu"),
                                  f"tcp://127.0.0.1:{port}", rank, world)
    sim = torch_graph_sim.install(setattr)
    sim["dry"] = True   # a capture runs nothing, as on a card
    mesh = sharding.make_mesh()
    waves, pitches = note_batch(GRAPH_NOTES)   # 16 distinct pitches
    all_w = torch.from_numpy(waves)
    all_p = torch.from_numpy(pitches.astype(np.int32))
    results = {}

    def fresh(cfg):
        return create_train_state(cfg, seed=0, device="cpu")

    def cfg_for(layout="replicate", **model):
        return config(**model).with_overrides(
            {"train": {"device_cache_layout": layout, "unroll": 3}})

    def cached(cfg, graphs_on, state=None, on_step=None):
        shard = cfg.train.device_cache_layout == "shard"
        part = mesh.rows(GRAPH_NOTES) if shard else slice(None)
        data = (all_w[part].clone(), all_p[part].clone())
        return _supersteps(
            lambda: tstep.make_cached_superstep(cfg, STAGE, GRAPH_NOTES,
                                                mesh, graphs=graphs_on),
            fresh(cfg) if state is None else state, lambda i: data, on_step)

    # graphed against eager: both layouts, both mbstd modes, the plain
    # superstep
    for name, cfg in (("cached_replicate", cfg_for()),
                      ("cached_shard", cfg_for("shard")),
                      ("cached_per_replica", cfg_for(mbstd_replicas=world))):
        before = sim["captures"]
        results[name] = {"eager": cached(cfg, False),
                         "graph": cached(cfg, True)}
        results[name]["captures"] = sim["captures"] - before

    cfg = cfg_for()
    rows = mesh.rows(8)
    # superstep i's step k takes examples (3 i + k + j) % 16, j < 8
    idx = [(np.arange(8)[None] + 3 * i + np.arange(3)[:, None]) % GRAPH_NOTES
           for i in range(2)]
    chunks = [(all_w[torch.from_numpy(x)][:, rows].contiguous(),
               all_p[torch.from_numpy(x)][:, rows].contiguous()) for x in idx]
    before = sim["captures"]
    results["superstep"] = {}
    for kind, on in (("eager", False), ("graph", True)):
        results["superstep"][kind] = _supersteps(
            lambda on=on: tstep.make_superstep(cfg, STAGE, mesh, graphs=on),
            fresh(cfg), lambda i: chunks[i])
    results["superstep"]["captures"] = sim["captures"] - before

    # the step at unroll 1, fed by prefetch_to_mesh as the loop feeds it
    from gansynth_tpu_torch.data.prefetch import prefetch_to_mesh

    batches = [(all_w[x[0]].numpy(), all_p[x[0]].numpy()) for x in idx]
    before = sim["captures"]
    results["step"] = {}
    for kind, on in (("eager", False), ("graph", True)):
        fn, state, metrics = tstep.make_train_step(cfg, STAGE, mesh,
                                                   graphs=on), fresh(cfg), []
        for i, (w, p) in enumerate(prefetch_to_mesh(iter(batches), mesh, 8)):
            state, m = fn(state, w, p, GRAPH_ALPHAS[i][0])
            metrics.append({k: float(v) for k, v in m.items()})
        results["step"][kind] = {"metrics": metrics,
                                 "state": _state_arrays(state)}
    results["step"]["captures"] = sim["captures"] - before

    # the batches a dry-captured sharded superstep fetches, step by step
    fetched = []
    gather = tstep._gather_from_owners

    def recording(*args):
        wave, pitch = gather(*args)
        fetched.append(pitch.tolist())
        return wave, pitch

    tstep._gather_from_owners = recording
    cfg = cfg_for("shard")
    state = fresh(cfg)
    cached(cfg, True, state)
    tstep._gather_from_owners = gather
    law = cfg.train.cached_stream
    results["shard_batches"] = {
        "fetched": fetched,
        "want": [all_p[torch.from_numpy(tstep.cached_batch_indices(
            state.rng, k, 8, GRAPH_NOTES, law)).long()][rows].tolist()
            for k in range(6)]}

    # the sharded fetch at two index sets: all on rank 0's shard, and
    # spread over both
    part = mesh.rows(GRAPH_NOTES)
    fetch = {}
    for name, chosen in (("one_owner", list(range(8))),
                         ("spread", [0, 8, 1, 9, 2, 10, 3, 11])):
        shapes = _Shapes()
        with shapes.mode:
            w, p = gather(mesh, all_w[part], all_p[part],
                          torch.tensor(chosen, dtype=torch.int64),
                          GRAPH_NOTES)
        want = torch.tensor(chosen)[rows]
        fetch[name] = {"shapes": shapes.seen,
                       "equal": bool(torch.equal(w, all_w[want])
                                     and torch.equal(p, all_p[want]))}
    results["fetch"] = fetch

    # one rank's tensors move between the supersteps: both recapture
    cfg = cfg_for()

    def move(i, state):
        if i == 1 and rank == 1:
            p = next(state.g.parameters())
            p.data = p.data.clone()

    before = sim["captures"]
    results["recapture"] = {"graph": cached(cfg, True, on_step=move),
                            "eager": results["cached_replicate"]["eager"]}
    results["recapture"]["captures"] = sim["captures"] - before

    # a capture that fails on rank 1 alone raises on both ranks
    sim["fail"] = f"capture failed on rank {rank}" if rank == 1 else None
    try:
        cached(cfg, True)
        results["failure"] = None
    except RuntimeError as e:
        results["failure"] = str(e)
    sim["fail"] = None
    results["modes"] = sorted(set(sim["modes"]))
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
