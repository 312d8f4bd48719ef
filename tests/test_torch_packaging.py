"""The port's packaging: ``pyproject.toml`` ships its CUDA sources, its
analysis baselines and wire-schema lock, and declares its console scripts
and an optional ``torch`` dependency group beside the JAX package's
entries, which stay as they were; each port
script's ``--help`` exits 0 without importing JAX; and the kernels build in
the checkout's ``build/kernels`` or, where that cannot be written, in a
per-user cache directory."""

import glob
import os
import subprocess
import sys
import tomllib

import pytest

from torchft_tpu_torch import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = {
    "torchft-torch-lighthouse": "torchft_tpu_torch.lighthouse:main",
    "torchft-torch-diagnose": "torchft_tpu_torch.diagnose:main",
    "tft-torch-lint": "torchft_tpu_torch.analysis.cli:main",
    "tft-torch-verify": "torchft_tpu_torch.analysis.verify_cli:main",
}


@pytest.fixture(scope="module")
def project():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_the_cuda_sources_are_package_data(project):
    data = project["tool"]["setuptools"]["package-data"]["torchft_tpu_torch"]
    csrc = os.path.join(REPO, "torchft_tpu_torch")
    shipped = {os.path.relpath(p, csrc) for pat in data
               for p in glob.glob(os.path.join(csrc, pat))}
    sources = {os.path.relpath(p, csrc) for p in glob.glob(os.path.join(csrc, "csrc", "*"))
               if p.endswith((".cu", ".cuh"))}
    # the analysis suite's baselines (one a pass) and its wire-schema lock
    analysis = {os.path.relpath(p, csrc) for p in glob.glob(
        os.path.join(csrc, "analysis", "baselines", "*.txt"))} | {"analysis/protocol.lock"}
    assert sources and len(analysis) == 10 and sources | analysis == shipped
    # every kernel's source is among them, and the sdist carries them too
    assert {f"csrc/{src}" for src, _, _ in _kernels.KERNELS.values()} <= shipped
    manifest = open(os.path.join(REPO, "MANIFEST.in")).read()
    assert "recursive-include torchft_tpu_torch/csrc *.cu *.cuh" in manifest
    assert "torchft_tpu*" in project["tool"]["setuptools"]["packages"]["find"]["include"]


def test_console_scripts_and_the_torch_extra(project):
    scripts = project["project"]["scripts"]
    for name, target in PORT_SCRIPTS.items():
        assert scripts[name] == target
    # the JAX package's entries stay as they are
    assert {k: v for k, v in scripts.items() if k not in PORT_SCRIPTS} == {
        "torchft-tpu-lighthouse": "torchft_tpu.lighthouse:main",
        "torchft-diagnose": "torchft_tpu.diagnose:main",
        "tft-lint": "torchft_tpu.analysis.cli:main",
        "tft-verify": "torchft_tpu.analysis.verify_cli:main",
    }
    assert project["project"]["dependencies"] == ["numpy", "jax", "optax"]
    extra = project["project"]["optional-dependencies"]["torch"]
    assert "torch" in extra and not any(d.startswith(("jax", "optax")) for d in extra)


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_each_port_script_help_exits_0_without_jax(script):
    module, func = PORT_SCRIPTS[script].split(":")
    code = (f"import sys; sys.argv = [{script!r}, '--help']\n"
            f"import {module} as m\n"
            "try:\n"
            f"    rc = m.{func}()\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [n for n in sys.modules if n in ('jax', 'torchft_tpu')"
            " or n.startswith(('jax.', 'torchft_tpu.'))]\n"
            "assert not bad, bad\n"
            "sys.exit(rc or 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")


def test_kernels_build_in_the_checkout_else_in_the_user_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    cache = str(tmp_path / "cache" / "torchft_tpu_torch" / "kernels")
    checkout = tmp_path / "checkout"
    (checkout / "torchft_tpu_torch").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("")
    pkg = str(checkout / "torchft_tpu_torch")
    assert _kernels._build_dir(pkg) == str(checkout / "build" / "kernels")
    # a checkout whose build/ cannot be made there (the check is by
    # os.access, which a test run as root would pass on any mode)
    real_access = os.access
    monkeypatch.setattr(_kernels.os, "access", lambda path, mode: (
        False if str(path) == str(checkout) else real_access(path, mode)))
    assert _kernels._build_dir(pkg) == cache
    monkeypatch.setattr(_kernels.os, "access", real_access)
    # an installed package: no pyproject.toml beside it
    site = tmp_path / "site-packages" / "torchft_tpu_torch"
    site.mkdir(parents=True)
    assert _kernels._build_dir(str(site)) == cache
    # this checkout builds into its own gitignored build/kernels
    assert _kernels.BUILD_DIR == os.path.join(REPO, "build", "kernels")
