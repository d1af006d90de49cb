"""One rank of the port's data-parallel CPU tests (``test_torch_parallel.py``).

Imports torch, numpy and the port, never JAX: the test spawns W of these
(``torch.multiprocessing``, start method ``spawn``) into one gloo group.
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
