"""The port stands alone: no JAX, no flax, nothing of ``gansynth_tpu``.

The card's machine has PyTorch and no JAX, so one such import anywhere in
the port or in ``chip_smoke.py`` breaks the port there.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gansynth_tpu")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "gansynth_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_forbidden_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    with open(path) as f:
        text = f.read()
    for word in ("import jax", "import flax", "gansynth_tpu."):
        assert word not in text, f"{path}: {word!r}"


def test_scan_covers_every_module_of_the_port():
    """The scan walks the package, so the training path's modules are in
    it with the serving path's."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("chip_smoke.py", "gansynth_tpu_torch/kernels/conv.py",
                "gansynth_tpu_torch/kernels/dblock.py",
                "gansynth_tpu_torch/models/discriminator.py",
                "gansynth_tpu_torch/ops/harmonic.py",
                "gansynth_tpu_torch/train/losses.py",
                "gansynth_tpu_torch/train/state.py",
                "gansynth_tpu_torch/train/step.py",
                "gansynth_tpu_torch/train/schedule.py",
                "gansynth_tpu_torch/data/fixtures.py",
                "gansynth_tpu_torch/data/native_tfrecord.py",
                "gansynth_tpu_torch/train/loop.py",
                "gansynth_tpu_torch/train/supervisor.py",
                "gansynth_tpu_torch/utils/logging.py",
                "gansynth_tpu_torch/utils/audio_io.py",
                "gansynth_tpu_torch/cli.py",
                "gansynth_tpu_torch/evaluation.py",
                "gansynth_tpu_torch/synth/interpolate.py",
                "gansynth_tpu_torch/data/validate.py",
                "gansynth_tpu_torch/data/prefetch.py",
                "gansynth_tpu_torch/parallel/sharding.py"):
        assert rel in scanned


def test_port_imports_without_jax():
    """Import every module of the port in a fresh interpreter in which
    importing jax, flax or gansynth_tpu fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for k in list(sys.modules):\n"
        f"    if k.split('.')[0] in {FORBIDDEN!r}:\n"
        "        del sys.modules[k]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gansynth_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gansynth_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
