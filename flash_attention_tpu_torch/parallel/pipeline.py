"""Pipeline parallelism: GPipe-style microbatched training over a mesh dim.

The counterpart of ``flash_attention_tpu/parallel/pipeline.py``. Each rank
is one stage of the ``pipe`` dim (and, with a ``data`` dim, one replica):
stage s holds layers [s L / S, (s + 1) L / S) of the stacked (L, ...) layer
weights (``stage_specs``), stage 0 also embeds and the last stage also
takes the loss.

Schedule: M microbatches flow through S stages over M + S - 1 ticks. At
tick t stage s runs microbatch t - s, and skips the ticks outside [0, M)
(the GPipe bubble, (S - 1) / (M + S - 1) of the ticks). The stage boundary
is a point-to-point send to the right (``parallel.mesh.isend`` / ``recv``,
gloo, through pinned host memory for CUDA tensors), tagged by microbatch.
The loss is psum(loss_sum) / psum(valid_sum) over the pipe (and data) dims,
through ``parallel.mesh.reduce_from``, so it comes back replicated.

Backward: ``loss.backward()`` on every rank. Where the JAX package's
gradients flow back through the scan and the transpose of its ppermute,
here the boundary is a pair of autograd functions: the sender's backward
receives the activation's gradient from the right, and the receiver's
backward sends it back to the left. Both are tagged by microbatch, and the
gradient sends are posted (``isend``) and waited only when the backward
ends: the autograd engines of two stages need not take the microbatches in
the same order, and a blocking send would deadlock them. Over a data dim
every weight enters the stage through ``parallel.mesh.copy_to``, so its
gradient is summed over the replicas in the backward (once a leaf, when
the engine has gathered that leaf's gradient).

Remat: each layer group (a layer, or Gemma-2's group of ``window_pattern``
layers) under ``torch.utils.checkpoint``, as ``llama.train_loss`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.ops.quant import QuantizedTensor
from flash_attention_tpu_torch.parallel import mesh as pmesh


def stage_specs(params, axis: str = "pipe") -> dict:
    """For each leaf, whether its leading (layer) axis splits over mesh dim
    ``axis`` (the counterpart of JAX's PartitionSpecs). Embed, the final
    norm and the lm_head are replicated: stage 0 and the last stage read
    them, the others hold copies they never use."""
    return {k: k in llama._PER_LAYER for k in params}


def _stage_params(params, cfg: llama.LlamaConfig, mesh, axis: str) -> dict:
    """This stage's part of a full tree (views of its layers' slices), or
    an already staged tree as it is."""
    n_stages = pmesh.axis_size(mesh, axis)
    per = cfg.n_layers // n_stages
    if params["norm_attn"].shape[0] == per:
        return params
    s = pmesh.axis_index(mesh, axis)
    split = stage_specs(params, axis)
    return {k: v.narrow(0, s * per, per) if split[k] else v
            for k, v in params.items()}


def _wait_all(pending: list) -> None:
    """Wait for every posted send of ``pending`` (pairs of the work and the
    host copy it sends), and forget them."""
    while pending:
        pending.pop()[0].wait()


class _Send(torch.autograd.Function):
    """Forward: post the send of x to the right (tag: the microbatch) and
    return a zero scalar that the caller adds into its loss, which ties the
    send into the graph. Backward: receive x's gradient from the right."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dst, tag, pending):
        pending.append(pmesh.isend(x.detach(), mesh, axis, dst, tag))
        ctx.meta = (mesh, axis, dst, tag, x.shape, x.dtype, x.device)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        mesh, axis, dst, tag, shape, dtype, device = ctx.meta
        like = torch.empty(shape, dtype=dtype, device=device)
        return (pmesh.recv(like, mesh, axis, dst, tag), None, None, None,
                None, None)


class _Recv(torch.autograd.Function):
    """Forward: receive the activation from the left (tag: the
    microbatch). Backward: post the send of its gradient to the left into
    ``pending``, the call's list, which the engine waits on when the
    backward ends. ``anchor`` is a scalar that requires grad, so that the
    engine reaches this node."""

    @staticmethod
    def forward(ctx, anchor, like, mesh, axis, src, tag, pending):
        ctx.meta = (mesh, axis, src, tag, pending)
        return pmesh.recv(like, mesh, axis, src, tag)

    @staticmethod
    def backward(ctx, dx):
        mesh, axis, src, tag, pending = ctx.meta
        if not pending:
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: _wait_all(pending))
        pending.append(pmesh.isend(dx.contiguous(), mesh, axis, src, tag))
        return None, None, None, None, None, None, None


def _stage_forward(x, layers, cfg: llama.LlamaConfig, positions, *,
                   remat: bool):
    """This stage's layers on ``x``, a layer group at a time (Gemma-2's
    ``window_pattern`` layers, each with its own window), each group under
    ``torch.utils.checkpoint`` with ``remat``: the same
    ``llama._dense_layer`` math as one device's forward."""
    period = cfg.window_pattern if cfg.sliding_window is not None else 1

    def group(x, *ws):
        for j, w in enumerate(ws):
            x = llama._dense_layer(x, w, cfg, positions,
                                   cfg.layer_window(j))[0]
        return x

    for g in range(0, len(layers), period):
        ws = layers[g:g + period]
        if remat and torch.is_grad_enabled():
            x = checkpoint(group, x, *ws, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = group(x, *ws)
    return x


def pipeline_train_loss(params, tokens, targets, cfg: llama.LlamaConfig, *,
                        mesh, axis: str = "pipe",
                        data_axis: str | None = None,
                        n_micro: int | None = None, remat: bool = True):
    """Pipeline-parallel ``llama.train_loss`` (mean next-token CE).

    Every rank calls it with the same tokens/targets (b, s) int (targets
    < 0 are ignored), the whole batch, which must divide n_micro (default:
    the pipe dim's size) times the data dim's size (data replica i takes
    rows [i b / dp, (i + 1) b / dp)). ``params`` is the full tree or this
    stage's (``stage_specs``: the per-layer leaves' layer slices). ``mesh``
    is any ``DeviceMesh`` with a dim named ``axis`` (and ``data_axis``).
    Returns the loss, replicated on every rank; ``loss.backward()`` on
    every rank gives each stage the gradients of its layers (stage 0
    embed's, the last stage norm_out's and lm_head's), summed over the
    data replicas. From a full tree that requires grad, each leaf's
    gradient is nonzero in this stage's slice only."""
    n_stages = pmesh.axis_size(mesh, axis)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} must divide the pipe "
                         f"axis {n_stages}")
    period = cfg.window_pattern if cfg.sliding_window is not None else 1
    if (cfg.n_layers // n_stages) % period:
        raise ValueError(f"layers per stage {cfg.n_layers // n_stages} must "
                         f"divide window_pattern {period}")
    dp = pmesh.axis_size(mesh, data_axis) if data_axis else 1
    m = n_micro or n_stages
    b, s = tokens.shape
    if b % (m * dp):
        raise ValueError(f"batch {b} must divide n_micro {m} x dp {dp}")
    if "lora" in params:
        raise ValueError("pipeline training with LoRA stacks is not "
                         "supported yet")
    if any(isinstance(v, QuantizedTensor) for v in params.values()):
        raise ValueError("pipeline training takes float weights "
                         "(quantized tensors do not train)")
    params = _stage_params(params, cfg, mesh, axis)
    if dp > 1:  # each leaf's gradient summed over the replicas
        params = {k: pmesh.copy_to(v, mesh, data_axis)
                  for k, v in params.items()}
    sid = pmesh.axis_index(mesh, axis)
    last = n_stages - 1
    dev = params["embed"].device
    if dp > 1:
        r = pmesh.axis_index(mesh, data_axis)
        tokens = tokens[r * (b // dp):(r + 1) * (b // dp)]
        targets = targets[r * (b // dp):(r + 1) * (b // dp)]
    mb = tokens.shape[0] // m
    toks = tokens.to(dev).reshape(m, mb, s)
    tgts = targets.to(dev).reshape(m, mb, s)
    positions = torch.arange(s, device=dev).expand(mb, s)
    layers = llama._layer_weights(params)
    like = torch.empty((mb, s, cfg.dim), dtype=params["embed"].dtype,
                       device=dev)
    grad = torch.is_grad_enabled()
    anchor = torch.zeros((), requires_grad=grad, device=dev)
    loss_sum = torch.zeros((), device=dev)
    valid_sum = torch.zeros((), dtype=torch.int64, device=dev)
    sends: list = []  # this forward's sends to the right
    grad_sends: list = []  # the backward's sends to the left
    for t in range(m + n_stages - 1):
        mi = t - sid
        if not 0 <= mi < m:  # the GPipe bubble: an idle tick
            continue
        if sid == 0:
            x = llama._embed(params, toks[mi], cfg)
        elif grad:
            x = _Recv.apply(anchor, like, mesh, axis, sid - 1, mi,
                            grad_sends)
        else:
            x = pmesh.recv(like, mesh, axis, sid - 1, mi)
        x = _stage_forward(x, layers, cfg, positions, remat=remat)
        if sid == last:
            nll, nv = llama._loss_sums(x, params, cfg, tgts[mi])
            loss_sum = loss_sum + nll
            valid_sum = valid_sum + nv
        elif grad:
            loss_sum = loss_sum + _Send.apply(x, mesh, axis, sid + 1, mi,
                                              sends)
        else:
            sends.append(pmesh.isend(x, mesh, axis, sid + 1, mi))
    _wait_all(sends)
    # only the last stage summed a loss; the sum over the pipe (and data)
    # dims replicates it, with an identity backward
    for dim in (axis,) + ((data_axis,) if data_axis else ()):
        loss_sum = pmesh.reduce_from(loss_sum, mesh, dim)
        valid_sum = pmesh.psum(valid_sum, mesh, dim)
    return loss_sum / valid_sum.clamp(min=1)
