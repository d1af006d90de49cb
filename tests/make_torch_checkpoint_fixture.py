"""Write ``tests/data/torch_checkpoint_8787f8c/``: a training checkpoint
as the port wrote it at commit 8787f8c (the last whose train step took its
alpha and Adam's bias corrections as Python floats), and the state that
the same code reached two steps later.

    git archive 8787f8c | tar -x -C OLD
    python tests/make_torch_checkpoint_fixture.py --package-root OLD

It imports ``gansynth_tpu_torch`` from ``OLD`` and runs on the CPU: the
narrow config ``CONFIG`` at stage 1, seed 0, the cached stream over
``note_batch(5)``; two steps (alphas 0.5 and 0.75) are saved by that
code's ``Checkpointer`` as ``checkpoints/2/state.pt``; two more (alpha 1)
give ``after.npz``: every tensor of the state (the networks' parameters
and both Adams' moments, by name) and its step and counts.
``tests/test_torch_graphs.py`` restores the checkpoint with this tree's
code, takes the same two steps and compares.
"""

import argparse
import os
import sys

CONFIG = {"model": dict(latent_dim=8, fmap_base=64, fmap_max=16,
                        fmap_min=8),
          "train": dict(batch_size=2)}
STAGE = 1
EXAMPLES = 5
FIRST_ALPHAS = (0.5, 0.75)
LATER_ALPHAS = (1.0, 1.0)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_checkpoint_8787f8c")


def state_arrays(state):
    """Every tensor of ``state`` as numpy, by name, and its counters."""
    import numpy as np

    out = {}
    for net in ("g", "d", "ema"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = v.detach().cpu().numpy()
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                out[f"{name}.{i}.{k}"] = v.detach().cpu().numpy()
    out["__counts__"] = np.array([state.step, state.g_opt.count,
                                  state.d_opt.count], np.int64)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--package-root", required=True,
                   help="checkout whose gansynth_tpu_torch writes the "
                        "fixture")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import numpy as np
    import torch

    import gansynth_tpu_torch
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.checkpoint import Checkpointer
    from gansynth_tpu_torch.utils.config import Config

    root = os.path.dirname(os.path.dirname(gansynth_tpu_torch.__file__))
    if os.path.abspath(root) != os.path.abspath(args.package_root):
        raise SystemExit(f"imported gansynth_tpu_torch from {root}")
    torch.set_num_threads(2)   # as the tests run (tests/torch_threads.py)
    config = Config().with_overrides(CONFIG)
    waves, pitches = note_batch(EXAMPLES)
    all_waves = torch.from_numpy(waves)
    all_pitches = torch.from_numpy(pitches.astype(np.int32))
    state = create_train_state(config, seed=0, device="cpu")
    superstep = make_cached_superstep(config, STAGE, EXAMPLES)
    state, _ = superstep(state, all_waves, all_pitches, list(FIRST_ALPHAS))
    Checkpointer(os.path.join(OUT, "checkpoints")).save(state.step, state)
    state, _ = superstep(state, all_waves, all_pitches, list(LATER_ALPHAS))
    np.savez_compressed(os.path.join(OUT, "after.npz"),
                        **state_arrays(state))
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
