"""The PyTorch port's rules: it imports nothing of JAX and nothing of the
JAX package, its entry points run on the card unless asked for the CPU,
it validates the parameters it takes from the JAX package, and it builds
every LLM config of the JAX package (the encoder and the VLM among
them)."""

import ast
import dataclasses
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
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import serve as llm_serve
from repro_torch.models import transformer as tr
from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                    generator_specs, init_gan)
from repro_torch.program import Program, ProgramSpec, load_or_build
from repro_torch.serve.engine import DecodeEngine, EngineConfig
from repro_torch.serve.gan import GanServer
from repro_torch.serve.gan_engine import GanEngine
from repro_torch.train.loop import make_gan_train_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import make_train_step

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


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = init_gan(CFG, torch.Generator().manual_seed(0), "cpu")
    np_g = {k: v.numpy() for k, v in g.items()}
    cpu_program = Program(ProgramSpec.build(CFG, 2, "generator"),
                          device="cpu", differentiable=False)
    for call in (lambda: GanServer(CFG, g),
                 lambda: GanServer(CFG, g, program=cpu_program),
                 lambda: GanEngine(CFG, g),
                 lambda: Program.build(CFG, 2),
                 lambda: Program(cpu_program.spec),
                 lambda: load_or_build(tmp_path / "none.json", CFG, 2),
                 lambda: Generator(CFG, g),
                 lambda: init_gan(CFG, torch.Generator()),
                 lambda: params_from_jax(np_g, CFG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        GanServer(CFG, g, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        GanEngine(CFG, g, device="meta")
    engine = GanEngine(CFG, g, buckets=(2,), device="cpu", warmup=False)
    assert engine.device.type == "cpu"
    engine.close(timeout=30)


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, d = init_gan(CFG, torch.Generator().manual_seed(0), "cpu")
    for call in (lambda: Discriminator(CFG, d),
                 lambda: Program.build(CFG, 2, "discriminator"),
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


def _tiny_lm():
    cfg = llm_serve.reduced_config("gemma-7b", "tiny")
    return cfg, tr.init(cfg, torch.Generator().manual_seed(0))


def test_llm_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tiny_lm()
    for call in (lambda: DecodeEngine(cfg, params, EngineConfig()),
                 lambda: llm_serve.main(["--arch", "gemma-7b"]),
                 lambda: tr.init_cache(cfg, 1, 8),
                 lambda: lm_params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    engine = DecodeEngine(cfg, params, EngineConfig(n_slots=1, max_len=8),
                          device="cpu")
    assert engine.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        DecodeEngine(cfg, params, EngineConfig(), device="meta")


# the encoder's and the VLM's leaves beside the decoder's, and their
# full-width parameter counts (the reference's count_params)
FRONTEND_LEAVES = {"hubert-xlarge": ("frontend_proj", "pos_embed"),
                   "internvl2-26b": ("img_proj",)}
FULL_PARAMS = {"hubert-xlarge": 988_058_880, "internvl2-26b": 19_882_383_360}


@pytest.mark.parametrize("name", sorted(FRONTEND_LEAVES))
def test_llm_configs_of_the_encoder_and_the_vlm_build(name):
    """The tiny preset builds (specs, parameters on the CPU, cache) with
    its frontend's leaves, and runs one forward on the CPU; the
    full-width config counts the reference's parameters."""
    cfg = llm_serve.reduced_config(name, "tiny")
    params = tr.init(cfg, torch.Generator().manual_seed(0))
    for key in FRONTEND_LEAVES[name]:
        assert tuple(params[key].shape) == tr.model_specs(cfg)[key].shape
    assert tr.init_cache(cfg, 1, 8, device="cpu")["seg0"]["pos0"]["attn"]
    if cfg.family == "encoder":
        batch = {"features": torch.randn((1, 9, cfg.frontend_dim))}
    else:
        batch = {"tokens": torch.zeros((1, 20), dtype=torch.long),
                 "img_embeds": torch.randn((1, cfg.img_tokens,
                                            cfg.frontend_dim))}
    logits, _ = tr.forward(params, batch, cfg)
    assert logits.shape[:2] == (1, batch[next(iter(batch))].shape[1])
    assert bool(torch.isfinite(logits).all())
    assert tr.count_params(get_config(name)) == FULL_PARAMS[name]


def test_llm_options_outside_the_slice_raise():
    cfg, params = _tiny_lm()
    # the int8 cache and the sequence-sharded decode are the slice's
    assert tr.init_cache(cfg, 1, 8, kv_dtype="int8", device="cpu")[
        "seg0"]["pos0"]["attn"]["k"].dtype == torch.int8
    seq = tr.RunFlags(mesh=(2, 1), seq_shard_decode=True)
    assert tr.RunFlags(seq_shard_decode=True).mesh is None
    # a model axis above 1 and a mesh without seq_shard_decode run every
    # family: MLA, MoE, SSM and hybrid layers pass the mesh check at both
    # meshes, and only an SSM head split over the model axis is refused
    tr.RunFlags(mesh=(1, 2), seq_shard_decode=True)
    tr.RunFlags(mesh=(2, 1))
    for name in ("minicpm3-4b", "olmoe-1b-7b", "hymba-1.5b", "mamba2-2.7b"):
        other = llm_serve.reduced_config(name, "tiny")
        for mesh in (seq.mesh, (1, 2)):
            tr.check_mesh(other, mesh)
    odd = dataclasses.replace(llm_serve.reduced_config("mamba2-2.7b",
                                                       "tiny"),
                              ssm_head_dim=256)
    assert odd.ssm_heads % 2
    with pytest.raises(ValueError, match="splits whole SSM heads only"):
        tr.check_mesh(odd, (1, 2))
    # the train options of the reference's RunFlags are the port's too
    for flags in (tr.RunFlags(remat=False), tr.RunFlags(remat_policy="dots"),
                  tr.RunFlags(scan_layers=False),
                  tr.RunFlags(attn_impl="chunked_q")):
        assert not flags.mesh
    with pytest.raises(ValueError, match=r"RunFlags\(mesh"):
        make_train_step(cfg, AdamWConfig(), compute_shardings=object())
    with pytest.raises(ValueError, match="'chunked_q'"):
        tr.RunFlags(attn_impl="blocked")
    # soft-capping and positions given in the batch are the slice's
    soft = dataclasses.replace(cfg, logit_softcap=30.0)
    tr.model_specs(soft)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = tr.forward(params, {"tokens": tokens,
                                    "positions": torch.arange(4)[None] + 2},
                           cfg)
    assert logits.shape == (1, 4, cfg.padded_vocab)
    for name in ("gemma-7b", "qwen1.5-32b", "gemma3-4b", "minicpm3-4b",
                 "olmoe-1b-7b", "llama4-scout-17b-a16e", "mamba2-2.7b",
                 "hymba-1.5b"):
        tr.model_specs(get_config(name))       # the slice's full configs


def test_attention_free_mamba2_takes_any_positions_at_flash():
    """An SSM block runs no attention, so ``attn_impl="flash"`` takes
    arbitrary ``batch["positions"]`` for Mamba2, as the reference does,
    and they change nothing; Hymba's global layers still refuse them
    there."""
    cfg = llm_serve.reduced_config("mamba2-2.7b", "tiny")
    params = tr.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.arange(16).reshape(2, 8)
    positions = torch.tensor(np.random.default_rng(4).integers(0, 99, (2, 8)))
    logits, _ = tr.forward(params, {"tokens": tokens,
                                    "positions": positions}, cfg)
    assert torch.equal(logits, tr.forward(params, {"tokens": tokens}, cfg)[0])
    hymba = llm_serve.reduced_config("hymba-1.5b", "tiny")
    hp = tr.init(hymba, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="masks by index"):
        tr.forward(hp, {"tokens": tokens, "positions": positions}, hymba)


def test_a_segment_of_zero_layers_raises_at_build():
    """Gemma3's tiny preset: 2 layers under a (5, 1) pattern leave its
    group segment with 0 layers, which the reference cannot initialise
    either (its stacked fan-in is 0)."""
    cfg = llm_serve.reduced_config("gemma3-4b", "tiny")
    assert [rep for _, rep in cfg.layer_segments()] == [0, 2]
    for build in (lambda: tr.model_specs(cfg),
                  lambda: tr.init(cfg, torch.Generator()),
                  lambda: tr.count_params(cfg),
                  lambda: tr.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="seg0 .* 0 layers.*reference"):
            build()
    six = dataclasses.replace(cfg, n_layers=6)
    assert tr.count_params(six) > 0


def test_lm_params_from_jax_validates_paths_and_shapes():
    cfg, params = _tiny_lm()

    def to_np(tree):
        return {k: to_np(v) if isinstance(v, dict) else v.float().numpy()
                for k, v in tree.items()}
    np_good = to_np(params)
    out = lm_params_from_jax(np_good, cfg, "cpu")
    assert out["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax({k: v for k, v in np_good.items()
                            if k != "final_norm"}, cfg, "cpu")
    bad = to_np(params)
    bad["segments"]["seg0"]["pos0"]["attn"]["wq"] = np.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="seg0/pos0/attn/wq"):
        lm_params_from_jax(bad, cfg, "cpu")
