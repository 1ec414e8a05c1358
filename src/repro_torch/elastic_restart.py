"""Fault-tolerance demo (the port of ``examples/elastic_restart.py``):
checkpoint → injected crash → restore → the same final state as an
uninterrupted run; then the elastic reshard.

::

    PYTHONPATH=src python -m repro_torch.elastic_restart [--device cpu]

The reshard (:func:`reshard`): a step on a (2, 1) mesh of two ranks
(gloo, sharing the card), its state saved whole; restored on a (1, 2)
mesh of two new ranks and on one device, both equal bit for bit to the
saved arrays; one more step from it on (1, 2), against the same step on
one device.  The reference restores onto eight fake devices in a
subprocess; the port's ranks are processes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models import transformer as tr
from repro_torch.sharding import rules
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import tree_items, tree_leaves
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step

__all__ = ["CFG", "run", "replay", "reshard", "main"]

CFG = dataclasses.replace(
    get_config("gemma-7b"), n_layers=2, d_model=64, d_ff=128, vocab=256,
    n_heads=2, n_kv_heads=2, head_dim=32, tie_embeddings=False)


def run(tmp: str, inject, device: torch.device):
    """16 steps with a checkpoint every 4, from seed 0; ``inject(step)``
    fails chosen steps.  Returns the final state and the loop."""
    step = make_train_step(CFG, AdamWConfig(peak_lr=1e-3, warmup_steps=2),
                           tr.RunFlags(remat=False))
    src = SyntheticLM(CFG, batch=4, seq_len=32, seed=0)
    state = init_train_state(CFG, torch.Generator(device).manual_seed(0))
    loop = TrainLoop(
        LoopConfig(total_steps=16, ckpt_dir=tmp, ckpt_every=4,
                   async_ckpt=False, log_every=4),
        step, make_batch_fn(src, device=device), state,
        failure_injector=inject)
    return loop.run(), loop


# the reshard's model: CFG in f32 (its heads, d_ff and vocab split over 2
# model ranks), weights conditioned to their widths; AdamW with an eps
# above the gradients' rounding, so a step's update is smooth in them
RESHARD_CFG = dataclasses.replace(CFG, dtype="float32")
RESHARD_OPT = AdamWConfig(peak_lr=1e-3, warmup_steps=2, eps=1e-3)
RESHARD_TOL = 1e-4


def _reshard_batch(step: int, device) -> dict:
    src = SyntheticLM(RESHARD_CFG, batch=4, seq_len=32, seed=1)
    return {k: torch.from_numpy(v).to(device) for k, v in src(step).items()}


def _reshard_init(device) -> dict:
    from repro_torch.sharding.parity import condition
    state = init_train_state(RESHARD_CFG,
                             torch.Generator(device).manual_seed(0))
    condition(state["params"], RESHARD_CFG.d_model)
    return state


def _mesh_step(mesh):
    from repro_torch.launch.train import train_shardings
    compute, master = train_shardings(RESHARD_CFG, mesh)
    return make_train_step(RESHARD_CFG, RESHARD_OPT,
                           tr.RunFlags(mesh=mesh, remat=False),
                           compute_shardings=compute,
                           master_shardings=master)


def _reshard_rank(tmp: str, device: str) -> None:
    """One rank of :func:`reshard`: a step on (2, 1) and the state saved;
    then, on a (1, 2) mesh of the same ranks, the state restored, its
    bits checked, one more step, the parameters saved."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    for shape in ((2, 1), (1, 2)):
        mesh = make_local_mesh(*shape, device_type=dev.type)
        step = _mesh_step(mesh)
        specs = step.state_specs
        template = rules.shard_tree(_reshard_init(dev), specs, mesh)
        rows = rules.batch_sharding(mesh, 2, batch_size=4)
        coords = rules.mesh_coords(mesh)

        def batch(i):
            return {k: rules.local_block(v, rows, mesh, coords)
                    for k, v in _reshard_batch(i, dev).items()}
        if shape == (2, 1):
            step(template, batch(0))
            ckpt.save(template, os.path.join(tmp, "saved"), 1, mesh=mesh,
                      shardings=specs)
            continue
        state = ckpt.restore(template, os.path.join(tmp, "saved"),
                             shardings=specs, mesh=mesh)
        whole = rules.gather_tree(state, specs, mesh)
        saved = ckpt.arrays(os.path.join(tmp, "saved"))
        same = all(np.array_equal(t.cpu().numpy(), saved[k])
                   for k, t in tree_items(whole).items())
        _, metrics = step(state, batch(1))
        ckpt.save(state["params"], os.path.join(tmp, "after"), 2, mesh=mesh,
                  shardings=specs["params"])
        if dist.get_rank() == 0:
            torch.save({"same": same, "loss": float(metrics["loss"])},
                       os.path.join(tmp, "restore.pt"))


def reshard(device: torch.device) -> float:
    """The elastic reshard (module docstring); returns the worst leaf's
    ``||update - one-device update|| / ||one-device update||``, raising
    where the bits differ or it exceeds RESHARD_TOL."""
    tmp = tempfile.mkdtemp(prefix="reshard_")
    try:
        spawn(_reshard_rank, 2, tmp, device.type, device=device.type)
        got = torch.load(os.path.join(tmp, "restore.pt"))
        saved = os.path.join(tmp, "saved")
        one = _reshard_init(device)
        one = ckpt.restore(one, saved)
        arrays = ckpt.arrays(saved)
        same_one = all(np.array_equal(t.cpu().numpy(), arrays[k])
                       for k, t in tree_items(one).items())
        print(f"[elastic] saved on (2, 1); restored on (1, 2): bits equal "
              f"{got['same']}; on one device: bits equal {same_one}")
        before = {k: t.clone() for k, t in tree_items(one["params"]).items()}
        step = make_train_step(RESHARD_CFG, RESHARD_OPT,
                               tr.RunFlags(remat=False))
        _, metrics = step(one, _reshard_batch(1, device))
        after = tree_items(ckpt.restore(one["params"],
                                        os.path.join(tmp, "after")))
        worst = 0.0
        for k, p in tree_items(one["params"]).items():
            want = (p - before[k]).double()
            diff = (after[k] - p).double()
            worst = max(worst, float(diff.norm() / want.norm()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[elastic] next step on (1, 2) vs one device: loss "
          f"{got['loss']:.6f} vs {float(metrics['loss']):.6f}; worst "
          f"leaf's update ||a-b||/||b|| {worst:.2e} (tolerance "
          f"{RESHARD_TOL:g})")
    if not (got["same"] and same_one and worst <= RESHARD_TOL):
        raise RuntimeError("the reshard must restore the saved bits and "
                           "step as one device does")
    return worst


def replay(device: torch.device) -> float:
    """Run A, failed at step 9 and restored from its step-8 checkpoint,
    against run B, uninterrupted; returns the largest parameter
    divergence, raising unless A restarted once and the divergence is
    under 1e-5."""
    tmp = tempfile.mkdtemp(prefix="elastic_")
    fired = []

    def inject(s):
        if s == 9 and not fired:
            fired.append(True)
            print(f"[elastic] >>> injecting node failure at step {s} <<<")
            return True
        return False

    try:
        print("[elastic] run A: crash at step 9, restore from checkpoint 8")
        state_a, loop_a = run(tmp, inject, device)
        shutil.rmtree(tmp)
        print(f"[elastic] run A restarts={loop_a.restarts}")
        print("[elastic] run B: uninterrupted control")
        state_b, _ = run(tmp, None, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(state_a["params"]),
                               tree_leaves(state_b["params"])))
    print(f"[elastic] max param divergence crash-vs-control: {diff:.2e}")
    if loop_a.restarts != 1 or not diff < 1e-5:
        raise RuntimeError(f"restart must replay deterministically: "
                           f"{loop_a.restarts} restarts, divergence "
                           f"{diff:.2e}")
    return diff


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the reference sums bf16 products in f32 (forward refuses less)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    diff = replay(dev)
    reshard(dev)
    print("[elastic] done")
    return diff


if __name__ == "__main__":
    main()
