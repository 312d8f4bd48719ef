"""The PyTorch port stands alone: it imports neither ``jax`` nor
``torchft_tpu``, and its default-device entry points refuse to run without a
card instead of falling back to the CPU.  The same holds for the port's
examples (``examples/torch/``) and ``chip_smoke.py``.

Trap: the port's package name starts with ``torchft_tpu``, so every check
matches module names equal to ``torchft_tpu`` or starting with
``torchft_tpu.``.
"""

import ast
import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "torchft_tpu_torch")
EXAMPLES = os.path.join(REPO, "examples", "torch")


def _forbidden(name: str) -> bool:
    return any(
        name == root or name.startswith(root + ".")
        for root in ("jax", "jaxlib", "optax", "torchft_tpu")
    )


def _port_sources():
    for root in (PKG, EXAMPLES):
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_the_scan_covers_the_new_modules_and_the_examples():
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {
        "torchft_tpu_torch/diagnose.py",
        "torchft_tpu_torch/checkpointing/transport_bench.py",
        "examples/torch/_demo.py", "examples/torch/actor_trainer.py",
        "examples/torch/slurm_runner.py", "examples/torch/train_ddp.py",
        "examples/torch/train_diloco.py", "examples/torch/train_hsdp.py",
        "examples/torch/train_multihost.py", "chip_smoke.py",
    } <= sources


def test_forbidden_name_check_is_not_fooled_by_the_prefix():
    assert _forbidden("torchft_tpu") and _forbidden("torchft_tpu.manager")
    assert _forbidden("jax.numpy")
    assert not _forbidden("torchft_tpu_torch")
    assert not _forbidden("torchft_tpu_torch.manager")


def test_static_scan_finds_no_forbidden_import():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (
                isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", ""))
                in ("import_module", "__import__")
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                names = [str(node.args[0].value)]
            offenders += [f"{path}:{node.lineno}: {n}" for n in names if _forbidden(n)]
    assert offenders == []


_PROBE = r"""
import json, pkgutil, importlib, sys
import torchft_tpu_torch
for m in pkgutil.walk_packages(torchft_tpu_torch.__path__, "torchft_tpu_torch."):
    importlib.import_module(m.name)
loaded = sorted(
    n for n in sys.modules
    if any(n == r or n.startswith(r + ".") for r in ("jax", "jaxlib", "optax", "torchft_tpu"))
)
import torch
import dataclasses
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import cnn, mlp, moe
from torchft_tpu_torch.models import transformer as tf
from torchft_tpu_torch.checkpointing import transport_bench as tb
cfg = tf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=1,
                           d_ff=64, n_layers=1)
moe_cfg = dataclasses.replace(cfg, n_experts=4)
refused = {}
for name, call in [
    ("Transformer", lambda: tf.Transformer(cfg)),
    ("init_params", lambda: tf.init_params(torch.Generator(), cfg)),
    ("params_from_jax", lambda: convert.params_from_jax({}, cfg)),
    ("moe Transformer", lambda: tf.Transformer(moe_cfg)),
    ("moe init_params", lambda: tf.init_params(torch.Generator(), moe_cfg)),
    ("init_moe_params", lambda: moe.init_moe_params(
        torch.Generator(), moe.MoEConfig(d_model=32, d_ff=64))),
    ("mlp init_params", lambda: mlp.init_params(torch.Generator())),
    ("cnn init_params", lambda: cnn.init_params(torch.Generator())),
    ("transport_bench http", lambda: tb.bench_http(1e-6)),
    ("transport_bench pg", lambda: tb.bench_pg(1e-6)),
]:
    try:
        call()
        refused[name] = False
    except RuntimeError as e:
        refused[name] = "CUDA" in str(e)
print(json.dumps({"loaded": loaded, "cuda": torch.cuda.is_available(),
                  "refused": refused}))
"""


def test_import_loads_no_jax_and_entry_points_refuse_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["loaded"] == []
    assert doc["cuda"] is False
    assert doc["refused"] == {
        "Transformer": True, "init_params": True, "params_from_jax": True,
        "moe Transformer": True, "moe init_params": True,
        "init_moe_params": True, "mlp init_params": True,
        "cnn init_params": True, "transport_bench http": True,
        "transport_bench pg": True,
    }


def test_the_examples_and_the_bench_default_to_the_card():
    """Every example that computes (and the transport bench's CLI) takes
    ``--device`` and defaults it to ``cuda``; the SLURM runner's default
    asks its jobs for cards."""
    import runpy

    argv = {"slurm_runner": ["--", "python", "train.py"]}
    for name in ("train_ddp", "train_diloco", "train_hsdp", "train_multihost",
                 "actor_trainer", "slurm_runner"):
        mod = runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name=name)
        args = mod["parse_args"](argv.get(name, []))
        assert args.device == "cuda", name
    ddp = runpy.run_path(os.path.join(EXAMPLES, "train_ddp.py"), run_name="x")
    assert ddp["parse_args"](["--cpu"]).device == "cpu"
    from torchft_tpu_torch.checkpointing import transport_bench as tb

    for fn in (tb.make_state_dict, tb.bench_http, tb.bench_pg):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
