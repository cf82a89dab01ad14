"""Public flash-attention API, forward only: ``fwd`` and ``flash_attention``.

Layout (batch, seqlen, heads, head_dim) as in the JAX package; LSE comes back
(batch, heads, seqlen_q) fp32. On a CUDA tensor the call launches the
hand-written kernel (``ops.flash_fwd``); on a CPU tensor it runs the plain
fp32 version (``ops.reference``). The kernel takes bf16 and fp16 as they are
and masks its own ragged edges, so nothing is upcast or padded here.
"""

from __future__ import annotations

from flash_attention_tpu_torch.ops import flash_fwd as _fwd_mod
from flash_attention_tpu_torch.ops.reference import reference_attention


def fwd(q, k, v, is_causal: bool = False, *, sm_scale: float | None = None,
        window_size: tuple | None = None, softcap: float | None = None,
        empty_lse: float = 0.0):
    """Forward pass: (o, lse).

    q: (b, sq, h, d); k/v: (b, sk, hk, d) with h % hk == 0. ``window_size``
    is an optional (left, right) sliding window (entries < 0 = unbounded),
    ``softcap`` squashes scaled scores to ``softcap * tanh(s / softcap)``;
    both run only in the plain version so far. Rows with no live key (causal
    with sq > sk) give O = 0 and LSE = ``empty_lse``."""
    b, sq, h, d = q.shape
    if k.shape[-1] != d:
        raise ValueError("q and k head_dim mismatch")
    if h % k.shape[2]:
        raise ValueError(f"num_heads {h} must be divisible by num_heads_k "
                         f"{k.shape[2]}")
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=is_causal,
                                   sm_scale=sm_scale, window=window_size,
                                   softcap=softcap, empty_lse=empty_lse)
    if window_size is not None or softcap is not None:
        raise NotImplementedError("window_size and softcap run only in the "
                                  "plain version (CPU) so far")
    return _fwd_mod.flash_fwd(q, k, v, causal=is_causal, sm_scale=sm_scale,
                              empty_lse=empty_lse)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None,
                    window_size: tuple | None = None,
                    softcap: float | None = None, return_lse: bool = False):
    """Flash attention, forward only (no backward yet).

    Raises if an input requires grad. Returns o (b, sq, h, d), or (o, lse)
    with ``return_lse``."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention has no backward yet; "
                                  "call it under torch.no_grad() or "
                                  "torch.inference_mode()")
    o, lse = fwd(q, k, v, causal, sm_scale=sm_scale, window_size=window_size,
                 softcap=softcap)
    return (o, lse) if return_lse else o
