"""The PyTorch port's rules: it imports nothing of JAX and nothing of the
JAX package, its entry points run on the card unless asked for the CPU,
and it validates the parameters it takes from the JAX package."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import quickstart
from repro_torch.convert import params_from_jax
from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                    generator_specs, init_gan)
from repro_torch.serve.gan import GanServer
from repro_torch.train.loop import make_gan_train_step

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = GanConfig("dcgan", channel_scale=1 / 32)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('PASS')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = init_gan(CFG, torch.Generator().manual_seed(0), "cpu")
    np_g = {k: v.numpy() for k, v in g.items()}
    for call in (lambda: GanServer(CFG, g),
                 lambda: Generator(CFG, g),
                 lambda: init_gan(CFG, torch.Generator()),
                 lambda: params_from_jax(np_g, CFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        GanServer(CFG, g, device="meta")


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, d = init_gan(CFG, torch.Generator().manual_seed(0), "cpu")
    for call in (lambda: Discriminator(CFG, d),
                 lambda: make_gan_train_step(CFG, 2, g, d),
                 lambda: quickstart.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_params_from_jax_validates_names_and_shapes():
    specs = generator_specs(CFG)
    good = {k: np.zeros(s.shape, np.float32) for k, s in specs.items()}
    out = params_from_jax(good, CFG, "cpu")
    assert sorted(out) == sorted(specs)
    assert all(v.dtype == torch.float32 for v in out.values())
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in good.items() if k != "t0_w"},
                        CFG, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(dict(good, t9_w=good["t0_w"]), CFG, "cpu")
    bad = dict(good, t1_w=np.zeros((3, 3, 1, 1), np.float32))
    with pytest.raises(ValueError, match="t1_w"):
        params_from_jax(bad, CFG, "cpu")
