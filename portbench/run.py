"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Each run is a new process on the machine it starts on: it loads, warms
up (set-up), measures for ``--seconds`` seconds, checks what the timed
path produced against the plain reference and prints one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, then ``notes`` and ``checks``). Each
compared number is printed beside its limit as the last lines on
standard error. It exits 2 without a result when CUDA is missing or has
fewer cards than the cell asks for, and 3 when JAX, flax or the JAX
package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gansynth_tpu"}

# Every cache at a fixed path inside the checkout (the port's kernels
# build under build/torch_kernels by themselves).
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(REPO / "build" / "portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(REPO))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    chips = harness.cell(harness.manifest(), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}; the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    for k, v in result["notes"].items():
        print(f"portbench: {k} = {v}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
