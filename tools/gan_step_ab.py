"""Time the PyTorch port's GAN train steps and generator forwards, tree
against tree, on one CUDA card.

    python3 tools/gan_step_ab.py TREE [TREE ...]
    python3 tools/gan_step_ab.py --serve-pairs TREE_A TREE_B [ROUNDS]

Each TREE is a checkout of this repository (``.``, or another commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The trees run in the order given, each in a process of its
own that builds that tree's kernels and imports that tree's
``src/repro_torch`` (give them in turns, A B B A, so that drift on the
card shows).  For full-width DCGAN and 3D-GAN at batch 64 (seed 0,
TF32 off) each process prints one line ``AB {json}``: the card's name
and power limit (``nvidia-smi``), and the median and least host-clock
time of an adversarial step (D then G, SGD, ended by a synchronise; 25
DCGAN and 5 3D-GAN steps after warm-up), of a generator forward (25
after warm-up) and of ``GanServer.generate(64)`` (the serving path,
ended by a synchronise; 100 after warm-up).  The DCGAN paths are bound
by the host, whose speed differs from one machine to the next and
drifts within one: compare trees only within one run of this script,
in turns.

``--serve-pairs`` loads both trees' ``repro_torch`` into one process
(each call runs with its own tree's modules in ``sys.modules``, so
lazy imports resolve to that tree) and times ``GanServer.generate(64)``
(full width, seed 0, ended by a synchronise) of the two in pairs,
ROUNDS rounds (default 300), alternating which runs first: both sides
see the same host.  It prints one line ``PAIRS {json}`` per model: each
tree's median and quartiles, and the share of rounds B was faster.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (model, warm-up steps, timed steps); generator forwards: 5 and 25
MODELS = (("dcgan", 5, 25), ("3dgan", 2, 5))


def measure(tree: Path) -> dict:
    """One tree's times, in this process (run by ``main`` in a child)."""
    sys.path.insert(0, str(tree / "src"))
    import statistics
    import time

    import torch
    from repro_torch.kernels import build
    from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                        init_gan)
    from repro_torch.quickstart import make_batch_fn
    from repro_torch.serve.gan import GanServer
    from repro_torch.train.loop import (discriminator_grads,
                                        generator_grads, sgd_update)
    if not torch.cuda.is_available():
        raise SystemExit("gan_step_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(("ganax_conv", "ganax_conv3d"))
    dev = torch.device("cuda")

    def timed(fn, warmup, runs):
        times = []
        for i in range(warmup + runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"tree": str(tree), "card": card}
    for model, warmup, runs in MODELS:
        cfg = GanConfig(model)
        g, d = init_gan(cfg, torch.Generator().manual_seed(0), dev)
        batch = make_batch_fn(cfg, 64, dev)(0)
        gen, disc = Generator(cfg, g, dev), Discriminator(cfg, d, dev)

        def step():
            _, dg = discriminator_grads(gen, disc, batch["z"], batch["real"])
            sgd_update(disc.params, dg, 0.02)
            _, gg = generator_grads(gen, disc, batch["z"])
            sgd_update(gen.params, gg, 0.02)

        def forward():
            with torch.no_grad():
                gen(batch["z"])

        server = GanServer(cfg, g, batch_size=64, seed=0, device=dev)
        step_ms, step_min = timed(step, warmup, runs)
        gen_ms, gen_min = timed(forward, 5, 25)
        serve_ms, serve_min = timed(lambda: server.generate(64), 10, 100)
        out[model] = dict(step_ms=step_ms, step_min_ms=step_min,
                          generator_ms=gen_ms, generator_min_ms=gen_min,
                          serve_ms=serve_ms, serve_min_ms=serve_min)
        del gen, disc, g, d, batch, server
        torch.cuda.empty_cache()
    return out


def _load_tree(tree: Path) -> dict:
    """Import ``tree``'s ``repro_torch`` (after removing any other) and
    return its modules by name."""
    import importlib
    for name in [n for n in sys.modules
                 if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    try:
        importlib.import_module("repro_torch.kernels.build").build(
            ("ganax_conv", "ganax_conv3d"))
        for name in ("repro_torch.serve.gan", "repro_torch.models.gan",
                     "repro_torch.kernels.ops"):
            importlib.import_module(name)
    finally:
        sys.path.remove(str(tree / "src"))
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


def serve_pairs(trees: list[Path], rounds: int) -> None:
    """``GanServer.generate(64)`` of two trees in one process, in pairs."""
    import statistics
    import time

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gan_step_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mods = [_load_tree(t) for t in trees]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for model in ("dcgan", "3dgan"):
        servers = []
        for m in mods:
            sys.modules.update(m)
            gan = m["repro_torch.models.gan"]
            cfg = gan.GanConfig(model)
            g, _ = gan.init_gan(cfg, torch.Generator().manual_seed(0), dev)
            server = m["repro_torch.serve.gan"].GanServer(
                cfg, g, batch_size=64, seed=0, device=dev)
            for _ in range(5):      # lazy imports and first launches
                server.generate(64)
            servers.append(server)
        times = [[], []]
        for r in range(rounds):
            for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                sys.modules.update(mods[i])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                servers[i].generate(64)
                torch.cuda.synchronize()
                times[i].append((time.perf_counter() - t0) * 1e3)
        out = {"model": model, "card": card, "rounds": rounds,
               "b_faster_share": sum(b < a for a, b in zip(*times))
               / rounds}
        for name, t in zip("ab", times):
            q = statistics.quantiles(t, n=4)
            out[name] = {"tree": str(trees["ab".index(name)]),
                         "median_ms": statistics.median(t),
                         "q1_ms": q[0], "q3_ms": q[2]}
        print("PAIRS " + json.dumps(out), flush=True)
        del servers
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--serve-pairs":
        serve_pairs([Path(t).resolve() for t in argv[1:3]],
                    int(argv[3]) if len(argv) > 3 else 300)
        return 0
    if len(argv) >= 2 and argv[0] == "--measure":
        print("AB " + json.dumps(measure(Path(argv[1]).resolve())),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            print(f"gan_step_ab: {tree} holds no src/repro_torch",
                  file=sys.stderr)
            return 2
    for tree in argv:
        run = subprocess.run([sys.executable, __file__, "--measure", tree],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
        if run.returncode != 0 or not lines:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
