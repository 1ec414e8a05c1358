"""Device meshes on ``torch.distributed``, and a launcher of ranks.

The port of ``repro.launch.mesh``.  JAX drives every device of a mesh
from one controller; PyTorch runs one process per rank.  So a mesh here
is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks
of the initialised process group, with the reference's axes
``("data", "model")``: rank ``r`` of a ``(data, model)`` mesh sits at
``(r // model, r % model)``, the row-major order in which
``jax.make_mesh`` lays devices out.  Every function here builds the mesh
when it is called: importing the module touches no process group.

:func:`spawn` is torch's stand-in for JAX's single controller: it starts
``world`` ranks with ``torch.multiprocessing`` (spawn), each under a
process group met through a ``file://`` rendezvous in a temporary
directory (no TCP port), and runs one module-level function in each.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.sharding.collectives import release_staging

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_shape",
           "production_mesh_shape", "POD_STRIDE", "spawn", "world_size",
           "RANK_TIMEOUT_S"]

# rank stride between pods in the multi-pod mesh (the pod axis varies
# slowest): what classifies a collective as within a pod or across pods
POD_STRIDE = 256

# how long a rank waits in one collective before it raises (a peer that
# died leaves the others blocked, never hung)
RANK_TIMEOUT_S = 300


def world_size() -> int:
    """The ranks of the initialised process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def production_mesh_shape(multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The shape and axes of the reference's production mesh: 16×16 a
    pod, ×2 pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh over the process group's ranks:
    256 of them (512 with ``multi_pod``), which must all exist."""
    shape, axes = production_mesh_shape(multi_pod)
    need = 1
    for v in shape:
        need *= v
    n = world_size()
    if n < need:
        raise ValueError(f"the production mesh {shape} needs {need} "
                         f"ranks; the process group has {n}")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def mesh_shape(n: int, data: int | None = None,
               model: int | None = None) -> tuple[int, int]:
    """The ``(data, model)`` shape :func:`make_local_mesh` takes over
    ``n`` ranks, in the reference's four forms:

    * ``()``: factor all ``n`` ranks, ``model`` the first of 4, 2 that
      divides ``n``.  **Odd counts and 1 fall back to ``model=1``**:
      every rank goes to ``data``, so ``model > 1`` must never be
      assumed from this form.
    * ``(data=N)``: exactly ``(N, 1)``, the data-parallel serving mesh.
    * ``(model=M)``: all ranks, ``(n // M, M)``; raises unless ``M``
      divides ``n``.
    * ``(data=N, model=M)``: exactly that shape over the first ``N·M``
      ranks; raises unless that many exist."""
    if data is None and model is None:
        model, data = 1, n
        for m in (4, 2):
            if n % m == 0 and n >= m:
                model, data = m, n // m
                break
    elif model is None:
        model = 1
    elif data is None:
        if n % model:
            raise ValueError(f"model={model} does not divide the "
                             f"{n} local devices")
        data = n // model
    need = data * model
    if need > n:
        raise ValueError(f"mesh ({data}, {model}) needs {need} devices; "
                         f"only {n} available")
    return int(data), int(model)


def make_local_mesh(data: int | None = None, model: int | None = None,
                    *, device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the initialised
    process group, shaped by :func:`mesh_shape` (its four forms and
    errors are the reference's, over the world size where the reference
    counts ``jax.devices()``).  ``device_type`` is ``"cuda"`` (ranks
    that share one card all sit on ``cuda:0``) or ``"cpu"`` when the
    caller asks.  Every rank of the group must call it, also one that
    lies outside a mesh over fewer ranks."""
    d, m = mesh_shape(world_size(), data, model)
    return DeviceMesh(device_type, torch.arange(d * m).reshape(d, m),
                      mesh_dim_names=("data", "model"))


def _rank_main(rank: int, fn, world: int, init: str, backend: str,
               device: str, args: tuple) -> None:
    if device == "cuda":
        # ranks beyond the card count share the cards round robin (one
        # card: every rank on cuda:0); gloo tolerates that, NCCL does not
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        fn(*args)
        release_staging()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo",
          device: str = "cuda") -> None:
    """Run ``fn(*args)`` in ``world`` new processes, each a rank of one
    process group (``backend``: ``"gloo"``, or ``"nccl"`` with a card a
    rank).  ``fn`` must be a module-level function (the children import
    it by name); it reads its rank from ``torch.distributed``.  With
    ``device="cuda"`` (the default) each rank sets its card first;
    ``device="cpu"`` runs the ranks on the CPU.  Returns when every
    rank has returned; raises if any rank raised (the others are
    terminated)."""
    if int(world) < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    resolve_device(device)      # no card: raise here, before any rank
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, int(world), init, backend, device, args),
            nprocs=int(world), join=True, start_method="spawn")
