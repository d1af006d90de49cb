"""Where the port builds its CUDA kernels, and the key that names a build.

No compiler is needed: the key (``_build.build_key``) hashes the ``.cu``
source, every ``csrc`` header it includes (also through another header),
the flags and ``nvcc --version``'s output, which is monkeypatched here.
A change to any of them must name a new build, so a header edit or a new
toolkit never reuses a stale library. The build dir is
``build/torch_kernels`` in a checkout and the user's cache directory for
an installed package, never the package's own tree.
"""

import shutil

import pytest

from gansynth_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernels' sources that the test may edit."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "nvcc_version", lambda nvcc: "release 12.8")
    return copy


@pytest.mark.parametrize("name", ["conv3x3", "dblock"])
def test_key_covers_the_shared_header(csrc, name):
    assert [h.name for h in _build.included_headers(csrc / f"{name}.cu")] \
        == ["hopper.cuh"]
    before = _build.build_key(name, "nvcc")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_key(name, "nvcc") != before


def test_key_covers_headers_included_by_headers(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    assert [h.name for h in _build.included_headers(csrc / "conv3x3.cu")] \
        == ["hopper.cuh", "inner.cuh"]
    before = _build.build_key("conv3x3", "nvcc")
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.build_key("conv3x3", "nvcc") != before


def test_key_covers_source_flags_and_compiler(csrc, monkeypatch):
    before = _build.build_key("conv3x3", "nvcc")
    assert _build.build_key("conv3x3", "nvcc") == before
    # another kernel's source is not part of this key
    with open(csrc / "dblock.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_key("conv3x3", "nvcc") == before
    monkeypatch.setattr(_build, "nvcc_version",
                        lambda nvcc: "release 12.9")
    assert _build.build_key("conv3x3", "nvcc") != before
    monkeypatch.setattr(_build, "nvcc_version", lambda nvcc: "release 12.8")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.build_key("conv3x3", "nvcc") != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    with open(csrc / "conv3x3.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_key("conv3x3", "nvcc") != before


def test_nvcc_version_is_read_once(monkeypatch):
    calls = []

    class Proc:
        stdout, stderr = "Cuda compilation tools, release 12.8\n", ""

    def run(cmd, **kw):
        calls.append(cmd)
        return Proc()

    monkeypatch.setattr(_build, "_nvcc_versions", {})
    monkeypatch.setattr(_build.subprocess, "run", run)
    assert "release 12.8" in _build.nvcc_version("/x/nvcc")
    assert "release 12.8" in _build.nvcc_version("/x/nvcc")
    assert calls == [["/x/nvcc", "--version"]]


def test_build_dir_in_a_checkout():
    assert (_build.PACKAGE_ROOT / "pyproject.toml").is_file()
    assert _build.build_dir() == _build.PACKAGE_ROOT / "build" / \
        "torch_kernels"


def test_build_dir_outside_a_checkout(tmp_path, monkeypatch):
    site = tmp_path / "site-packages"   # an installed package's parent
    site.mkdir()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(site) == tmp_path / "cache" / \
        "gansynth_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    got = _build.build_dir(site)
    assert got == tmp_path / "home" / ".cache" / "gansynth_tpu_torch" / \
        "kernels"
    assert site not in got.parents


def test_kernel_ab_covers_the_step_shapes_and_needs_a_card(monkeypatch):
    """The A/B tool times K2 at every bf16 shape ``chip_smoke.py`` holds
    it to, and refuses to run without a card."""
    import importlib.util
    import os

    from gansynth_tpu_torch.utils import kernel_ab

    root = _build.PACKAGE_ROOT
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.K2_SHAPES) <= set(kernel_ab.SHAPES["conv3x3"])
    assert smoke.K3_SHAPE in kernel_ab.SHAPES["dblock"]
    monkeypatch.setattr(kernel_ab.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        kernel_ab.main(["conv3x3", "other.cu"])
