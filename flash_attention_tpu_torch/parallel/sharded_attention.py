"""Distributed flash attention: head-parallel (TP) and context-parallel (ring).

The counterpart of ``flash_attention_tpu/parallel/sharded_attention.py``:

* ``shard_flash_attention`` -- batch over the ``data`` mesh dim, heads over
  ``model`` (GQA keeps each kv head with its query group, so attention
  needs no communication), and optionally the sequence over ``context``
  through the ring;
* ``ring_flash_attention`` -- each rank holds a chunk of the sequence; the
  K/V chunks travel round the ring (``parallel.mesh.ppermute``) while each
  rank attends its queries to the chunk in hand, and the partials merge by
  their LSE (``merge_partials``). Differentiable: the backward sends K/V
  round again with their gradients' fp32 accumulators, recomputing P from
  the saved global LSE;
* ``merge_partials`` -- the (o, lse) combine of two partials.

The port is SPMD (one process a rank): where the JAX package runs these
under ``shard_map`` with an axis name, a rank calls them on its own blocks
and names an axis as the pair ``(mesh, dim name)``, as ``models.llama``'s
``tp_axis`` does. Each ring step runs the port's kernels (``ops.attention``):
the segmented forward, dq and dkv with the step's global positions when
causal, the dense ones when not. The transport is gloo, staged through
pinned host memory for CUDA tensors (see ``parallel.mesh``), so a step's
K/V hop is a synchronising copy each way and does not overlap the kernel.
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.ops.attention import (  # noqa: F401 re-export
    bwd, flash_attention, fwd, merge_partials)
from flash_attention_tpu_torch.parallel.mesh import axis_index, ppermute
from flash_attention_tpu_torch.parallel.mesh import axis_size as _axis_size

# LSE of a row with no live key in a *partial* result: finite (not -inf),
# so the merge's exp and log stay free of NaN; any real contribution
# dominates it. The JAX package's value.
EMPTY_LSE = -1e37


def _ring_positions(me, step, n, b, sq_local, sk_local, seq_offset, device):
    """Global (q_pos, kv_pos), each (b, s) int32, for the chunk held at
    ``step`` (from rank ``(me - step) % n``), q shifted by ``seq_offset``
    for the lower-right causal alignment."""
    src = (me - step) % n
    q_pos = (me * sq_local + seq_offset
             + torch.arange(sq_local, dtype=torch.int32, device=device))
    kv_pos = src * sk_local + torch.arange(sk_local, dtype=torch.int32,
                                           device=device)
    return (q_pos.expand(b, sq_local).contiguous(),
            kv_pos.expand(b, sk_local).contiguous())


def _step_segs(q, k, me, step, n, causal, seq_offset):
    """The segs of a ring step (one segment, the step's positions), or None
    when not causal."""
    if not causal:
        return None
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    zq = torch.zeros((b, sq), dtype=torch.int32, device=q.device)
    zk = torch.zeros((b, sk), dtype=torch.int32, device=q.device)
    return (zq, zk, *_ring_positions(me, step, n, b, sq, sk, seq_offset,
                                     q.device))


def _ring_fwd(q, k, v, axis, causal, sm_scale, n, seq_offset):
    mesh, name = axis
    me = axis_index(mesh, name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = lse = None
    kb, vb = k, v
    for step in range(n):
        segs = _step_segs(q, kb, me, step, n, causal, seq_offset)
        o_i, lse_i = fwd(q, kb, vb, causal, sm_scale=sm_scale, segs=segs,
                         empty_lse=EMPTY_LSE)
        if step < n - 1:
            kb, vb = ppermute((kb, vb), mesh, name, perm)
        o, lse = (o_i, lse_i) if o is None else merge_partials(o, lse, o_i,
                                                               lse_i)
    # rows that saw no key anywhere get LSE 0, as the one-device kernel
    lse = torch.where(lse <= EMPTY_LSE / 2, 0.0, lse)
    return o, lse


def _ring_bwd(q, k, v, o, lse, do, axis, causal, sm_scale, n, seq_offset):
    """dQ accumulates here in fp32 (its rows never move); dK/dV accumulate
    in fp32 buffers that travel WITH their K/V chunk, and one last hop
    takes each chunk's gradients home. P comes from the saved global LSE,
    so the chunks' contributions sum exactly."""
    mesh, name = axis
    me = axis_index(mesh, name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kb, vb = k, v
    for step in range(n):
        segs = _step_segs(q, kb, me, step, n, causal, seq_offset)
        dq_i, dk_i, dv_i = bwd(q, kb, vb, o, lse, do, causal,
                               sm_scale=sm_scale, segs=segs)
        dq += dq_i.float()
        dk += dk_i.float()
        dv += dv_i.float()
        if step < n - 1:
            kb, vb, dk, dv = ppermute((kb, vb, dk, dv), mesh, name, perm)
    dk, dv = ppermute((dk, dv), mesh, name, perm)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """The counterpart of the JAX ring's ``custom_vjp``: the forward saves
    (q, k, v, o, lse); the LSE cotangent is dropped, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, sm_scale, n, seq_offset):
        o, lse = _ring_fwd(q, k, v, axis, causal, sm_scale, n, seq_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = (axis, causal, sm_scale, n, seq_offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, o, lse, do.contiguous(),
                               *ctx.options)
        return dq, dk, dv, None, None, None, None, None


def ring_flash_attention(
    q,
    k,
    v,
    axis_name,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    axis_size: int | None = None,
    seq_offset_k_minus_q: int = 0,
):
    """Context-parallel attention over a ring of ranks: (o, lse).

    ``axis_name`` is the pair ``(mesh, dim name)`` of the ring. Each rank
    passes its chunk of sequence-sharded tensors, q (b, sq_local, h, d) and
    k/v (b, sk_local, hk, d) -- chunk ``i`` of the sequence on index ``i``
    of the dim -- and gets its rows of O (b, sq_local, h, d) and of the
    global LSE (b, h, sq_local). K/V go round the ring while each rank
    attends to the chunk in hand. ``seq_offset_k_minus_q`` is total seqlen
    k minus total seqlen q (the lower-right causal alignment; 0 for
    self-attention). Differentiable in q, k and v (the LSE carries no
    gradient, as in JAX). ``axis_size``, when given, must be the dim's
    size."""
    if not (isinstance(axis_name, tuple) and len(axis_name) == 2):
        raise TypeError("axis_name is a (mesh, dim name) pair in the port")
    n = _axis_size(*axis_name)
    if axis_size is not None and axis_size != n:
        raise ValueError(f"axis_size {axis_size} but dim {axis_name[1]!r} "
                         f"has {n} ranks")
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    args = (axis_name, causal, sm_scale, n, seq_offset_k_minus_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Ring.apply(q, k, v, *args)
    return _ring_fwd(q, k, v, *args)


def _dim(mesh, name) -> int:
    return 1 if name is None else _axis_size(mesh, name)


def _block(x, mesh, name, dim: int):
    """This rank's contiguous block of x along ``dim`` for mesh dim
    ``name`` (a view; x itself for no dim or a dim of one rank)."""
    n = _dim(mesh, name)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"size {x.shape[dim]} of dim {dim} must divide "
                         f"{name} {n}")
    part = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, name) * part, part)


def shard_flash_attention(
    q,
    k,
    v,
    mesh,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str | None = None,
    local: bool = False,
    **fwd_kwargs,
):
    """Mesh-sharded attention: batch on ``data``, heads on ``model``, and
    optionally the sequence on ``context`` (ring attention). Returns this
    rank's block of O.

    q: (b, sq, h, d); k/v: (b, sk, hk, d), the full tensors (every rank
    the same), or with ``local`` this rank's blocks: batch block ``i`` of
    the data dim's index ``i``, head block of the model dim's, sequence
    chunk of the context dim's. h and hk of the full tensors must divide
    the model dim (GQA co-location; for hk < tp replicate K/V outside).
    The result is O's block (b / dp, sq / cp, h / tp, d) at the same
    place, as ``parallel.tp_inference`` returns a rank's K/V. Without a
    context dim it is ``flash_attention`` (with ``fwd_kwargs``) on the
    rank's block, with no communication; with one the ring (where, as in
    JAX, ``fwd_kwargs`` do not apply). Differentiable end to end: from the
    full tensors, the gradient reaches this rank's block of them only."""
    tp, cp = _dim(mesh, model_axis), _dim(mesh, context_axis)
    if not local:
        h, hk = q.shape[2], k.shape[2]
        if h % tp != 0 or hk % tp != 0:
            raise ValueError(f"heads ({h}, {hk}) must divide model axis {tp}")
        seq_offset = k.shape[1] - q.shape[1]
        q, k, v = ((_block(_block(_block(x, mesh, data_axis, 0), mesh,
                                      model_axis, 2), mesh, context_axis, 1))
                   for x in (q, k, v))
    else:
        seq_offset = (k.shape[1] - q.shape[1]) * cp
    if context_axis is None:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               **fwd_kwargs)
    o, _ = ring_flash_attention(q, k, v, (mesh, context_axis), causal=causal,
                                sm_scale=sm_scale, axis_size=cp,
                                seq_offset_k_minus_q=seq_offset)
    return o
