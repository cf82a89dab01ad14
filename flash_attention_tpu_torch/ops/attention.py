"""Public flash-attention API: ``fwd``, ``bwd`` and the differentiable
``flash_attention``.

Layout (batch, seqlen, heads, head_dim) as in the JAX package; LSE comes back
(batch, heads, seqlen_q) fp32. On a CUDA tensor each call launches the
hand-written kernels (``ops.flash_fwd``, ``ops.flash_bwd``); on a CPU tensor
it runs their plain fp32 versions. The kernels take bf16 and fp16 as they are
and mask their own ragged edges, so nothing is upcast or padded here.
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.ops import flash_bwd as _bwd_mod
from flash_attention_tpu_torch.ops import flash_fwd as _fwd_mod
from flash_attention_tpu_torch.ops.reference import reference_attention


def _check_heads(q, k):
    if k.shape[-1] != q.shape[-1]:
        raise ValueError("q and k head_dim mismatch")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"num_heads {q.shape[2]} must be divisible by "
                         f"num_heads_k {k.shape[2]}")


def _cuda_options(window_size, softcap):
    if window_size is not None or softcap is not None:
        raise NotImplementedError("window_size and softcap run only in the "
                                  "plain version (CPU) so far")


def fwd(q, k, v, is_causal: bool = False, *, sm_scale: float | None = None,
        window_size: tuple | None = None, softcap: float | None = None,
        empty_lse: float = 0.0):
    """Forward pass: (o, lse).

    q: (b, sq, h, d); k/v: (b, sk, hk, d) with h % hk == 0. ``window_size``
    is an optional (left, right) sliding window (entries < 0 = unbounded),
    ``softcap`` squashes scaled scores to ``softcap * tanh(s / softcap)``;
    both run only in the plain version so far. Rows with no live key (causal
    with sq > sk) give O = 0 and LSE = ``empty_lse``."""
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=is_causal,
                                   sm_scale=sm_scale, window=window_size,
                                   softcap=softcap, empty_lse=empty_lse)
    _cuda_options(window_size, softcap)
    return _fwd_mod.flash_fwd(q, k, v, causal=is_causal, sm_scale=sm_scale,
                              empty_lse=empty_lse)


def bwd(q, k, v, o, lse, do, is_causal: bool = False, *,
        sm_scale: float | None = None, window_size: tuple | None = None,
        softcap: float | None = None, parts: str = "all"):
    """Backward pass: (dq, dk, dv), dq like q and dk/dv like k (the GQA
    group summed in the kernel), each in its input's dtype.

    o and lse are the forward's outputs, do the gradient of o. ``parts`` is
    a profiling hook: "di" runs only D = rowsum(dO * O) and returns it
    (b, h, sq) fp32, "dq" runs D and dQ and returns dq, "all" (the default)
    runs everything. ``window_size`` and ``softcap`` run only in the plain
    version so far."""
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    if q.device.type == "cpu":
        return _bwd_mod.flash_bwd_reference(
            q, k, v, o, lse, do, causal=is_causal, sm_scale=sm_scale,
            window=window_size, softcap=softcap, parts=parts)
    _cuda_options(window_size, softcap)
    return _bwd_mod.flash_bwd(q, k, v, o, lse, do, causal=is_causal,
                              sm_scale=sm_scale, parts=parts)


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
                    sm_scale: float | None = None,
                    window_size: tuple | None = None,
                    softcap: float | None = None, return_lse: bool = False):
    """Differentiable flash attention.

    q: (b, sq, h, d); k/v: (b, sk, hk, d). Gradients flow to q, k and v
    through :func:`bwd` when autograd records; otherwise this is
    :func:`fwd`. Returns o (b, sq, h, d), or (o, lse) with ``return_lse``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashAttention.apply(q, k, v, causal, sm_scale,
                                       window_size, softcap)
    else:
        o, lse = fwd(q, k, v, causal, sm_scale=sm_scale,
                     window_size=window_size, softcap=softcap)
    return (o, lse) if return_lse else o
