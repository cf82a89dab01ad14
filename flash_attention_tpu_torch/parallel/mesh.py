"""Device meshes, the collectives of tensor parallelism, point-to-point
transport, and a launcher.

The counterpart of ``flash_attention_tpu/parallel/mesh.py``. The JAX package
lays a named mesh over the devices of one controller; the port is SPMD: one
process per rank, all of them in one ``torch.distributed`` process group
that the caller has initialised, and ``make_mesh`` lays a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's dims over
that group. Axes:

  data    -- batch (pure DP, no comms in attention)
  model   -- heads / hidden (TP: an all-reduce after wo and after the FFN)
  context -- kv sequence (CP: ring attention, ``parallel.sharded_attention``)

A pipeline (``parallel.pipeline``) takes any ``DeviceMesh`` with a named
``pipe`` dim. A model call names its axis as the pair ``(mesh, "model")``
(``models.llama``'s ``tp_axis``), and reaches the other ranks only through
the functions here.

Transport: gloo, for CPU and CUDA tensors alike. NCCL refuses two ranks on
one card. ``psum`` stages a CUDA tensor through a pinned host buffer on
every call (device to host, gloo's all-reduce on the host, host to device):
a synchronising copy, so a tensor-parallel step reads the card twice a
layer. ``ppermute`` stages the same way.

Gradients. ``psum`` itself records no graph. Training under tensor
parallelism (Megatron's conjugate pair, where the JAX package relies on
``shard_map``'s transposes) goes through two autograd functions around it:
``reduce_from`` (g: ``psum`` forward, identity backward) after a
row-parallel product and on a replicated loss, and ``copy_to`` (f: identity
forward, ``psum`` backward) where a replicated activation or weight enters
rank-local work.

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
    host = _host(x)
    dist.all_reduce(host, group=group)
    return host.to(x.device, non_blocking=True)


class _ReduceFrom(torch.autograd.Function):
    """g: the sum over the axis forward, the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _CopyTo(torch.autograd.Function):
    """f: x as it is forward, the gradient summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.axis = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy.contiguous(), *ctx.axis), None, None


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` whose backward passes the gradient through unchanged
    (Megatron's g). For a sum whose result every rank then uses alike (the
    row-parallel wo and w_down, a loss replicated over the axis): each
    rank's part then gets the whole, replicated gradient. Do not use
    ``torch.distributed.nn.functional.all_reduce`` here: its backward
    all-reduces too, which gives every upstream gradient ``size`` times its
    value."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return psum(x, mesh, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x itself forward, with the gradient summed over the axis backward
    (Megatron's f). Put it where a replicated tensor enters rank-local work
    (the residual stream into the column-parallel wq/wk/wv/w_gate/w_up, the
    router of a rank's experts): each rank's gradient is then the sum of
    every rank's partial one, the same bits on each. Without autograd it is
    x."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyTo.apply(x, mesh, axis)


def _group_ranks(mesh, axis: str) -> list[int]:
    """The global ranks of mesh dim ``axis``'s group that holds this rank,
    by their index along the dim."""
    return dist.get_process_group_ranks(mesh.get_group(axis))


def _host(x: torch.Tensor) -> torch.Tensor:
    """x on the host (a pinned copy of a CUDA tensor; a contiguous CPU
    tensor as it is), ready for gloo."""
    if x.device.type == "cpu":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _host_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype,
                       pin_memory=x.device.type != "cpu")


def isend(x: torch.Tensor, mesh, axis: str, dst: int, tag: int = 0):
    """Post the send of ``x`` to index ``dst`` along mesh dim ``axis``;
    returns the pending work, which holds the host copy it sends: keep it
    until its ``wait()``. A CUDA tensor is copied to pinned host memory
    first (a synchronising copy)."""
    host = _host(x)
    work = dist.isend(host, _group_ranks(mesh, axis)[dst],
                      group=mesh.get_group(axis), tag=tag)
    return work, host


def recv(like: torch.Tensor, mesh, axis: str, src: int,
         tag: int = 0) -> torch.Tensor:
    """A tensor of ``like``'s shape and dtype from index ``src`` along mesh
    dim ``axis`` (the send with the same tag), on ``like``'s device."""
    host = _host_like(like)
    dist.recv(host, _group_ranks(mesh, axis)[src], group=mesh.get_group(axis),
              tag=tag)
    return host.to(like.device, non_blocking=True)


def ppermute(x, mesh, axis: str, perm):
    """``jax.lax.ppermute``: each rank sends ``x`` (a tensor, or a tuple or
    list of tensors sent together) to its destination under ``perm``
    (pairs (source, destination) of indices along mesh dim ``axis``) and
    returns what its source sent; a rank that is no destination gets zeros.

    Every send and receive is posted before any is waited on, so a ring
    (each rank a source and a destination) does not deadlock. Cost: gloo
    point-to-point over the host. A CUDA tensor is copied to pinned host
    memory before its send (a synchronising copy) and each received one
    back to the card after its receive, every call: for K and V of a ring
    step (b, s, hk, d) bf16 that is about 2 b s hk d bytes each way."""
    xs = list(x) if isinstance(x, (tuple, list)) else [x]
    me = axis_index(mesh, axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends to or from index {me} twice")
    group, ranks = mesh.get_group(axis), _group_ranks(mesh, axis)
    bufs, works = [], []
    for i, t in enumerate(xs):
        if src:
            bufs.append(_host_like(t))
            works.append(dist.irecv(bufs[-1], ranks[src[0]], group=group,
                                    tag=i))
    keep = []
    for i, t in enumerate(xs):
        if dst:
            keep.append(_host(t))
            works.append(dist.isend(keep[-1], ranks[dst[0]], group=group,
                                    tag=i))
    for w in works:
        w.wait()
    if src:
        out = [b.to(t.device, non_blocking=True) for b, t in zip(bufs, xs)]
    else:
        out = [torch.zeros_like(t) for t in xs]
    return out[0] if not isinstance(x, (tuple, list)) else type(x)(out)


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
