"""Quickstart: train a DCGAN through the GANAX kernels, then serve samples.

    PYTHONPATH=src python -m repro_torch.quickstart --steps 30

runs on the card: every conv and tconv of the forward pass, and every
``dx`` of the backward pass, launches the hand-written GANAX kernel.
``make_gan_train_step`` builds the generator and the discriminator once,
each replaying a program resolved ahead of time (printed after the
run); the fault-tolerant ``TrainLoop`` runs the steps with checkpoints
in a temporary directory.  Then the reference's build → export → load
→ serve flow: the generator's program is saved as JSON, loaded back as
a fresh serving process would, and ``GanServer`` serves a few samples
of the trained generator through it.  ``--device cpu`` runs the
kernels' plain versions instead (keep ``--batch`` and
``--channel-scale`` small there);
``--backend`` pins another dataflow (``ganax-plain``, ``polyphase``,
``zero-insert``).  ``--dtype bf16`` (or
``f16``) trains at that storage precision: activations and weights are
cast to it at use, the kernels' instances of that dtype run forward and
``dx``, every sum is f32, and parameters, gradients and checkpoints stay
f32.
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile
import time

import torch

from repro_torch.core.dataflow import BACKENDS
from repro_torch.device import resolve_device
from repro_torch.models.gan import GanConfig, init_gan
from repro_torch.program import Program, ProgramSpec
from repro_torch.serve.gan import GanServer
from repro_torch.train.loop import LoopConfig, TrainLoop, make_gan_train_step

__all__ = ["synthetic_reals", "make_batch_fn", "train", "main"]


def synthetic_reals(gen: torch.Generator, batch: int,
                    spatial: tuple[int, ...], channels: int,
                    device: torch.device) -> torch.Tensor:
    """'Real' data: one smooth blob per sample, ``(batch, *spatial,
    channels)`` in [0, tanh(1)] (enough for a quickstart objective), drawn
    from ``gen``.  Images for a 2-D model, volumes for 3D-GAN."""
    nd = len(spatial)
    grids = torch.meshgrid(*(torch.linspace(-1, 1, n, device=device)
                             for n in spatial), indexing="ij")
    centers = torch.rand((batch, nd), generator=gen, device=device) - 0.5
    r = 0.1 + 0.3 * torch.rand((batch,), generator=gen, device=device)
    bcast = (batch,) + (1,) * nd
    d2 = sum((g[None] - centers[:, d].reshape(bcast)) ** 2
             for d, g in enumerate(grids))
    blob = torch.tanh(torch.exp(-d2 / (2 * r.reshape(bcast) ** 2)))
    return blob[..., None].expand(*blob.shape, channels).contiguous()


def make_batch_fn(cfg: GanConfig, batch: int, device: torch.device):
    """``batch_fn(step)``: latents and reals drawn from a generator
    seeded by the step, a pure function of it (exact replay after a
    restart)."""
    _, d_layers = cfg.layers
    spatial, channels = tuple(d_layers[0].in_spatial), d_layers[0].cin

    def batch_fn(step: int) -> dict[str, torch.Tensor]:
        gen = torch.Generator(device=device).manual_seed(int(step))
        z = torch.randn((batch, cfg.z_dim), generator=gen, device=device)
        return {"z": z, "real": synthetic_reals(gen, batch, spatial,
                                                channels, device)}
    return batch_fn


def train(cfg: GanConfig, *, steps: int, batch: int, lr: float,
          ckpt_dir: str, device: str | torch.device = "cuda",
          ckpt_every: int | None = None, log_every: int = 5):
    """Train ``cfg``'s networks from parameters drawn with seed 0 for
    ``steps`` adversarial steps (``g_lr = d_lr = 5 * lr``, as the
    reference's quickstart) through ``TrainLoop``, checkpointing every
    ``ckpt_every`` steps (default: ``max(10, steps // 2)``); returns the
    loop and the ``(generator, discriminator)`` pair."""
    dev = resolve_device(device)
    g_params, d_params = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    train_step, nets = make_gan_train_step(cfg, batch, g_params, d_params,
                                           g_lr=lr * 5, device=dev)
    generator, discriminator = nets
    loop = TrainLoop(
        LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                   ckpt_every=ckpt_every or max(10, steps // 2),
                   log_every=log_every),
        train_step, make_batch_fn(cfg, batch, dev),
        (generator.params, discriminator.params))
    loop.run()
    return loop, nets


def main(argv=None) -> tuple[TrainLoop, GanServer]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--channel-scale", type=float, default=0.0625)
    ap.add_argument("--backend", default=None, choices=sorted(BACKENDS),
                    help="dataflow backend (default: ganax, the kernel)")
    ap.add_argument("--dtype", default="float32",
                    help="storage precision: float32 (default), bf16 or "
                         "f16; sums, parameters and checkpoints stay f32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = GanConfig(name="dcgan", channel_scale=args.channel_scale,
                    backend=args.backend, dtype=args.dtype)
    dev = resolve_device(args.device)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop, (generator, discriminator) = train(
            cfg, steps=args.steps, batch=args.batch, lr=args.lr,
            ckpt_dir=ckpt_dir, device=dev)
    # the programs both networks replayed, resolved once before step 0
    print(generator.spec.describe())
    print(discriminator.spec.describe())
    print(f"done: {args.steps} adversarial steps through the "
          f"{generator.spec.summary()} dataflow at {cfg.dtype} on {dev} in "
          f"{time.time() - t0:.1f}s ({loop.checkpoints} checkpoints, "
          f"{loop.restarts} restarts)")

    # Build → export → load → serve: ship the program as data.
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "generator-program.json"
        generator.spec.save(path)
        spec = ProgramSpec.load(path)          # a fresh serving process
        server = GanServer(cfg, generator.params, batch_size=args.batch,
                           program=Program(spec, device=dev,
                                           differentiable=False),
                           device=dev)
        imgs = server.generate(3)
    print(f"served {imgs.shape[0]} samples {tuple(imgs.shape[1:])} from the "
          f"exported program in {server.batches_served} batch(es) "
          f"({server.samples_buffered} buffered for the next call)")
    return loop, server


if __name__ == "__main__":
    main()
