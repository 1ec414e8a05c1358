"""End-to-end LM training script (the port of ``examples/train_lm.py``):
synthetic deterministic data, AdamW with the cosine schedule, gradient
accumulation, async checkpoints and the fault-tolerant loop, through
``repro_torch.launch.train``.

On the card (a ~5M-parameter model, seconds)::

    PYTHONPATH=src python -m repro_torch.train_lm --steps 40

On the CPU, add ``--device cpu`` (keep ``--batch`` and ``--seq`` small);
``--preset 100m --steps 300 --batch 32 --seq 512`` is the ~100M model.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as train_cli

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train_cli.main([
        "--arch", args.arch, "--preset", args.preset,
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq", str(args.seq), "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50", "--device", args.device,
    ])


if __name__ == "__main__":
    main()
