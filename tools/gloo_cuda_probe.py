"""Which collectives the ``gloo`` backend runs on CUDA tensors.

    PYTHONPATH=src python tools/gloo_cuda_probe.py [--world 2]

Spawns ``--world`` gloo ranks on the card (ranks share ``cuda:0`` on a
one-card machine) and calls each collective the port's mesh uses on
CUDA tensors, checking the result against what it must be: the
list and tensor all-gathers, all-reduce, broadcast, ``send``/``recv``
and ``batch_isend_irecv``.  Prints one ``PROBE {json}`` line per
collective (``ok``, the error the backend raised, or the rank's crash:
each collective runs in a world of its own) and one for a ``("data",
"model")`` ``DeviceMesh`` on ``"cuda"`` over gloo and its groups, then,
in a world of one, the same over NCCL.
``repro_torch.sharding.collectives.GLOO_CUDA`` is the table of the
collectives this probe found gloo to take; the others are staged through
pinned host memory by that rule.  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.mesh import make_local_mesh, spawn  # noqa: E402


def _cases(rank: int, world: int, dev):
    """name -> a thunk returning True when the collective's result is
    right."""
    def x():
        return torch.full((4, 3), float(rank + 1), device=dev)

    def gather_list():
        out = [torch.empty(4, 3, device=dev) for _ in range(world)]
        dist.all_gather(out, x())
        return all(bool((o == r + 1).all()) for r, o in enumerate(out))

    def gather_tensor():
        out = torch.empty(4 * world, 3, device=dev)
        dist.all_gather_into_tensor(out, x())
        return all(bool((out[4 * r:4 * r + 4] == r + 1).all())
                   for r in range(world))

    def all_reduce():
        t = x()
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def broadcast():
        t = x()
        dist.broadcast(t, src=0)
        return bool((t == 1).all())

    def send_recv():
        t = x()
        got = torch.empty_like(t)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            dist.send(t, nxt)
            dist.recv(got, prv)
        else:
            dist.recv(got, prv)
            dist.send(t, nxt)
        return bool((got == prv + 1).all())

    def batch_p2p():
        t = x()
        got = torch.empty_like(t)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, nxt),
                                         dist.P2POp(dist.irecv, got, prv)]):
            w.wait()
        return bool((got == prv + 1).all())

    cases = {"all_gather": gather_list,
             "all_gather_into_tensor": gather_tensor,
             "all_reduce": all_reduce, "broadcast": broadcast}
    if world > 1:           # no rank sends to itself
        cases.update(send_recv=send_recv, batch_isend_irecv=batch_p2p)
    return cases


def _probe_rank(out_dir: str, device: str, op: str) -> None:
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    rows = {}
    for name, fn in _cases(rank, world, dev).items():
        if name != op:
            continue
        try:
            rows[name] = {"ok": bool(fn())}
        except (RuntimeError, ValueError) as e:   # the probe's reading
            rows[name] = {"ok": False, "error": f"{type(e).__name__}: "
                          f"{str(e).splitlines()[0][:200]}"}
        if dev.type == "cuda":
            torch.cuda.synchronize()
    if op == "device_mesh":
        try:
            mesh = make_local_mesh(model=world if world > 1 else None,
                                   device_type=device)
            g = mesh.get_group("model")
            t = torch.ones(2, device=dev if dist.get_backend() == "nccl"
                           else "cpu")
            dist.all_reduce(t, group=g)
            rows[op] = {"ok": bool((t == dist.get_world_size(g)).all()),
                        "shape": dict(zip(mesh.mesh_dim_names,
                                          mesh.shape))}
        except (RuntimeError, ValueError) as e:
            rows[op] = {"ok": False,
                        "error": f"{type(e).__name__}: {e}"[:300]}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rows))


OPS = ("all_gather", "all_gather_into_tensor", "all_reduce", "broadcast",
       "send_recv", "batch_isend_irecv", "device_mesh")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: rehearse the probe on gloo's CPU tensors")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.device == "cuda":
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}")
    runs = [("gloo", args.world)] + \
        ([("nccl", 1)] if args.device == "cuda" else [])
    for backend, world in runs:
        for op in OPS:
            if world == 1 and op in ("send_recv", "batch_isend_irecv"):
                continue        # no rank sends to itself
            # one world a collective: one that crashes a rank (gloo
            # aborts on a device pointer it takes for a host one) hides
            # no other
            with tempfile.TemporaryDirectory() as out:
                try:
                    spawn(_probe_rank, world, out, args.device, op,
                          backend=backend, device=args.device)
                    ranks = [json.loads(Path(out, f"rank{r}.json")
                                        .read_text())[op]
                             for r in range(world)]
                except torch.multiprocessing.ProcessExitedException as e:
                    ranks = [{"ok": False, "crashed": str(e)}]
            print("PROBE " + json.dumps({"backend": backend, "world": world,
                                         "op": op, "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
