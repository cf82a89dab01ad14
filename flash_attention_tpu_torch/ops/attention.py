"""Public flash-attention API: ``fwd``, ``bwd`` and the differentiable
``flash_attention``.

Layout (batch, seqlen, heads, head_dim) as in the JAX package; LSE comes back
(batch, heads, seqlen_q) fp32. On a CUDA tensor each call launches the
hand-written kernels (``ops.flash_fwd``, ``ops.flash_bwd``); on a CPU tensor
it runs their plain fp32 versions. The kernels take bf16 and fp16 as they are
and mask their own ragged edges, so nothing is upcast or padded here, except
a head dim other than 64, 128 or 256 below 256: the kernels run it
zero-padded to the next of the three (:func:`padded_head_dim`), as the JAX
package pads.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import flash_bwd as _bwd_mod
from flash_attention_tpu_torch.ops import flash_fwd as _fwd_mod
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.utils.options import reject_unported


def _check_heads(q, k):
    if k.shape[-1] != q.shape[-1]:
        raise ValueError("q and k head_dim mismatch")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"num_heads {q.shape[2]} must be divisible by "
                         f"num_heads_k {k.shape[2]}")


def kernel_head_dim(d: int) -> int:
    """The head dim the CUDA kernels run ``d`` at: 64, 128 and 256 as they
    are, any other d up to 256 zero-padded to the next of the three (so 192
    runs at 256, as the JAX package pads it to a multiple of 128)."""
    for kd in _fwd_mod.HEAD_DIMS:
        if d <= kd:
            return kd
    raise NotImplementedError(
        f"head_dim {d} on the card: the kernels take d <= 256; d 384 and 512, "
        f"which the JAX package runs, are not ported yet (ROADMAP.md, queue "
        f"B part 1)")


def padded_head_dim(fn, d_pad: int, *xs):
    """``fn(*xs)`` with every (b, s, h, d) input zero-padded to head dim
    ``d_pad``, and every (b, s, h, d_pad) output sliced back to d; other
    inputs and outputs (LSE, D) pass as they are. Exact: zero columns add
    nothing to Q K^T or dO V^T, and give zero columns of O, dQ, dK and dV.
    The caller fixes ``sm_scale`` from the real d first."""
    d = xs[0].shape[-1]
    if d == d_pad:
        return fn(*xs)
    out = fn(*(F.pad(x, (0, d_pad - d)) if x.dim() == 4 else x for x in xs))

    def cut(y):
        return y[..., :d] if y.dim() == 4 else y
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def fwd(q, k, v, is_causal: bool = False, *, sm_scale: float | None = None,
        block_sizes=None, interpret: bool | None = None, segs=None,
        window_size: tuple | None = None, softcap: float | None = None,
        empty_lse: float = 0.0, kv_split: int | None = None):
    """Forward pass: (o, lse).

    q: (b, sq, h, d); k/v: (b, sk, hk, d) with h % hk == 0. ``window_size``
    is an optional (left, right) sliding window (entries < 0 = unbounded),
    ``softcap`` squashes scaled scores to ``softcap * tanh(s / softcap)``.
    Rows with no live key (causal with sq > sk, or a window that misses
    every key) give O = 0 and LSE = ``empty_lse``. ``block_sizes`` and
    ``interpret`` (the TPU kernels' tiles, Pallas interpret mode), ``segs``
    (segment ids and positions) and ``kv_split`` (the long-context KV
    split) are not ported: a value other than None raises
    NotImplementedError."""
    reject_unported("fwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None), segs=(segs, None),
                    kv_split=(kv_split, None))
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=is_causal,
                                   sm_scale=sm_scale, window=window_size,
                                   softcap=softcap, empty_lse=empty_lse)
    kernel = functools.partial(_fwd_mod.flash_fwd, causal=is_causal,
                               sm_scale=sm_scale, empty_lse=empty_lse,
                               window=window_size, softcap=softcap)
    return padded_head_dim(kernel, kernel_head_dim(q.shape[-1]), q, k, v)


def bwd(q, k, v, o, lse, do, is_causal: bool = False, *,
        sm_scale: float | None = None, block_sizes=None,
        interpret: bool | None = None, segs=None,
        window_size: tuple | None = None, softcap: float | None = None,
        parts: str = "all"):
    """Backward pass: (dq, dk, dv), dq like q and dk/dv like k (the GQA
    group summed in the kernel), each in its input's dtype.

    o and lse are the forward's outputs, do the gradient of o. ``parts`` is
    a profiling hook: "di" runs only D = rowsum(dO * O) and returns it
    (b, h, sq) fp32, "dq" runs D and dQ and returns dq, "all" (the default)
    runs everything. ``window_size``, ``softcap`` and the options that are
    not ported (``block_sizes``, ``interpret``, ``segs``) as in :func:`fwd`."""
    reject_unported("bwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None), segs=(segs, None))
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    if q.device.type == "cpu":
        return _bwd_mod.flash_bwd_reference(
            q, k, v, o, lse, do, causal=is_causal, sm_scale=sm_scale,
            window=window_size, softcap=softcap, parts=parts)
    kernel = functools.partial(_bwd_mod.flash_bwd, causal=is_causal,
                               sm_scale=sm_scale, window=window_size,
                               softcap=softcap, parts=parts)
    return padded_head_dim(kernel, kernel_head_dim(q.shape[-1]), q, k, v, o,
                           lse, do)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX package's ``custom_vjp``: the forward saves
    (q, k, v, o, lse) and the backward calls :func:`bwd`. LSE is an output
    without a gradient (the JAX backward drops its cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window_size, softcap):
        o, lse = fwd(q, k, v, causal, sm_scale=sm_scale,
                     window_size=window_size, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.options = (causal, sm_scale, window_size, softcap)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, window_size, softcap = ctx.options
        # the kernels take any strides with a contiguous head dim; the
        # incoming gradient may be a broadcast or otherwise strided view
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal,
                         sm_scale=sm_scale, window_size=window_size,
                         softcap=softcap)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None, segment_ids=None,
                    block_sizes=None, interpret: bool | None = None,
                    window_size: tuple | None = None,
                    softcap: float | None = None, return_lse: bool = False):
    """Differentiable flash attention, with the JAX package's arguments in
    its order.

    q: (b, sq, h, d); k/v: (b, sk, hk, d). Gradients flow to q, k and v
    through :func:`bwd` when autograd records; otherwise this is
    :func:`fwd`. Returns o (b, sq, h, d), or (o, lse) with ``return_lse``.
    ``segment_ids`` (packed batches), ``block_sizes`` (the TPU kernels'
    tiles) and ``interpret`` (Pallas interpret mode) are not ported: a value
    other than None raises NotImplementedError."""
    reject_unported("flash_attention", segment_ids=(segment_ids, None),
                    block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashAttention.apply(q, k, v, causal, sm_scale,
                                       window_size, softcap)
    else:
        o, lse = fwd(q, k, v, causal, sm_scale=sm_scale,
                     window_size=window_size, softcap=softcap)
    return (o, lse) if return_lse else o
