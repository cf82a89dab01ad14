"""Device meshes, the collectives of tensor-parallel serving, and a launcher.

The counterpart of ``flash_attention_tpu/parallel/mesh.py``. The JAX package
lays a named mesh over the devices of one controller; the port is SPMD: one
process per rank, all of them in one ``torch.distributed`` process group
that the caller has initialised, and ``make_mesh`` lays a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's dims over
that group. Axes:

  data    -- batch (pure DP, no comms in attention)
  model   -- heads / hidden (TP: an all-reduce after wo and after the FFN)
  context -- kv sequence (CP; not ported yet)

A tensor-parallel model call names its axis as the pair ``(mesh, "model")``
(``models.llama``'s ``tp_axis``), and reaches the other ranks only through
``psum`` and ``axis_index`` here.

Transport: gloo, for CPU and CUDA tensors alike. NCCL refuses two ranks on
one card, and serving needs only all-reduces. ``psum`` stages a CUDA tensor
through a pinned host buffer on every call (device to host, gloo's
all-reduce on the host, host to device): a synchronising copy, so a
tensor-parallel step reads the card twice a layer.

``spawn(fn, world, *args)`` runs ``fn(rank, world, *args)`` in ``world``
processes of a fresh gloo group and returns their results; the tests and
``chip_smoke.py`` share it.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

AXES = ("data", "model", "context")
# a collective that waits this long for a peer fails (and spawn with it)
TIMEOUT_S = 600.0


def make_mesh(data: int = 1, model: int = 1, context: int = 1,
              device_type: str | None = None):
    """A (data, model, context) ``DeviceMesh`` over the initialised process
    group, on ``device_type`` ("cuda" unless the caller asks for "cpu").

    The world size must be ``data * model * context`` exactly: each rank is
    one process, and a rank outside the mesh would have no part. (The JAX
    package takes the first ``data * model * context`` devices of more.)"""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.mesh.spawn)")
    need = data * model * context
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need a world of {need} ranks "
                         f"(data {data} x model {model} x context "
                         f"{context}), have {world}")
    return init_device_mesh(device_type or "cuda", (data, model, context),
                            mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along mesh dim ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along mesh dim ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of mesh dim ``axis``, in x's dtype
    (``jax.lax.psum``), as a new tensor on x's device. Every rank gets the
    same bits. A CUDA tensor goes through a pinned host buffer."""
    group = mesh.get_group(axis)
    if x.device.type == "cpu":
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    dist.all_reduce(host, group=group)
    return host.to(x.device, non_blocking=True)


def _rank_main(rank: int, world: int, init: str, out_dir: str, fn,
               args) -> None:
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world: int, *args) -> list:
    """``fn(rank, world, *args)`` in ``world`` processes started with the
    spawn method, each a rank of a gloo process group (a ``file://``
    rendezvous in a temporary directory), and their return values, by rank
    (each ``torch.save``-able). ``fn`` must be importable by name from a
    module whose import is cheap: each child imports it afresh. A rank that
    raises stops the others and the call raises; a collective that waits
    ``TIMEOUT_S`` seconds for a peer fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, f"file://{os.path.join(d, 'rendezvous')}", d,
                       fn, args))
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
