"""Public flash-attention API: ``fwd``, ``bwd``, the differentiable
``flash_attention`` and the packed variable-length ``varlen_fwd`` and
``varlen_bwd``.

Layout (batch, seqlen, heads, head_dim) as in the JAX package; LSE comes back
(batch, heads, seqlen_q) fp32. On a CUDA tensor each call launches the
hand-written kernels (``ops.flash_fwd``, ``ops.flash_bwd``); on a CPU tensor
it runs their plain fp32 versions. The kernels take bf16 and fp16 as they are
and mask their own ragged edges, so nothing is upcast or padded here, except
a head dim other than 64, 128 or 256 below 256: the kernels run it
zero-padded to the next of the three (:func:`padded_head_dim`), as the JAX
package pads.

Packed batches run the kernels' segmented instances: ``fwd``/``bwd`` take
``segs`` (segment ids and positions), ``flash_attention`` takes
``SegmentIds`` and derives the positions, and ``varlen_*`` build both from
cu_seqlens, with q positions shifted by len_k - len_q per sequence so that
causal is lower-right aligned in each.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import flash_bwd as _bwd_mod
from flash_attention_tpu_torch.ops import flash_fwd as _fwd_mod
from flash_attention_tpu_torch.ops.reference import reference_attention
from flash_attention_tpu_torch.ops.segments import KV_PAD_SEG, Q_PAD_SEG
from flash_attention_tpu_torch.utils.options import reject_unported


class SegmentIds(NamedTuple):
    """Packed-sequence segment ids: q and kv are int tensors of shape
    (batch, seqlen_{q,kv}); tokens attend only within equal ids, which must
    lie in contiguous runs."""

    q: torch.Tensor
    kv: torch.Tensor


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
    every key) give O = 0 and LSE = ``empty_lse``. ``segs`` is (q_seg,
    kv_seg, q_pos, kv_pos), each (b, s) int: a query sees only keys of its
    own segment id, and causal and the window compare the positions
    (``kv_pos - q_pos``) instead of the row and column indices.
    ``block_sizes`` and ``interpret`` (the TPU kernels' tiles, Pallas
    interpret mode) and ``kv_split`` (the long-context KV split) are not
    ported: a value other than None raises NotImplementedError."""
    reject_unported("fwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None), kv_split=(kv_split, None))
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    if q.device.type == "cpu":
        if segs is not None:
            return _fwd_mod.flash_fwd_segmented_reference(
                q, k, v, segs, causal=is_causal, sm_scale=sm_scale,
                empty_lse=empty_lse, window=window_size, softcap=softcap)
        return reference_attention(q, k, v, causal=is_causal,
                                   sm_scale=sm_scale, window=window_size,
                                   softcap=softcap, empty_lse=empty_lse)
    kernel = functools.partial(_fwd_mod.flash_fwd, causal=is_causal,
                               sm_scale=sm_scale, empty_lse=empty_lse,
                               window=window_size, softcap=softcap,
                               segs=segs)
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
    runs everything. ``segs``, ``window_size``, ``softcap`` and the options
    that are not ported (``block_sizes``, ``interpret``) as in
    :func:`fwd`."""
    reject_unported("bwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    kw = dict(causal=is_causal, sm_scale=sm_scale, window=window_size,
              softcap=softcap, parts=parts, segs=segs)
    if q.device.type == "cpu":
        return _bwd_mod.flash_bwd_reference(q, k, v, o, lse, do, **kw)
    kernel = functools.partial(_bwd_mod.flash_bwd, **kw)
    return padded_head_dim(kernel, kernel_head_dim(q.shape[-1]), q, k, v, o,
                           lse, do)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX package's ``custom_vjp``: the forward saves
    (q, k, v, o, lse) and the segs, and the backward calls :func:`bwd`. LSE
    is an output without a gradient (the JAX backward drops its cotangent),
    and the segs take none."""

    @staticmethod
    def forward(ctx, q, k, v, segs, causal, sm_scale, window_size, softcap):
        o, lse = fwd(q, k, v, causal, sm_scale=sm_scale, segs=segs,
                     window_size=window_size, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse,
                              *(segs if segs is not None else ()))
        ctx.mark_non_differentiable(lse)
        ctx.options = (causal, sm_scale, window_size, softcap)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, *segs = ctx.saved_tensors
        causal, sm_scale, window_size, softcap = ctx.options
        # the kernels take any strides with a contiguous head dim; the
        # incoming gradient may be a broadcast or otherwise strided view
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal,
                         sm_scale=sm_scale, segs=tuple(segs) or None,
                         window_size=window_size, softcap=softcap)
        return dq, dk, dv, None, None, None, None, None


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
    ``segment_ids`` (a :class:`SegmentIds`) packs several sequences in a
    row: tokens attend within equal ids, causal within each run by its
    positions (:func:`_positions_from_segment_ids`). ``block_sizes`` (the
    TPU kernels' tiles) and ``interpret`` (Pallas interpret mode) are not
    ported: a value other than None raises NotImplementedError."""
    reject_unported("flash_attention", block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    segs = None
    if segment_ids is not None:
        q_pos, kv_pos = _positions_from_segment_ids(segment_ids)
        segs = (segment_ids.q, segment_ids.kv, q_pos, kv_pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashAttention.apply(q, k, v, segs, causal, sm_scale,
                                       window_size, softcap)
    else:
        o, lse = fwd(q, k, v, causal, sm_scale=sm_scale, segs=segs,
                     window_size=window_size, softcap=softcap)
    return (o, lse) if return_lse else o


def _positions_from_segment_ids(segment_ids: SegmentIds):
    """Within-segment positions (q_pos, kv_pos) for causal masking of packed
    batches: each token's index less the index where its run of equal ids
    starts. Needs contiguous runs; where q and kv counts per segment differ,
    ``varlen_fwd`` applies the per-sequence lower-right shift."""

    def pos(seg):
        b, s = seg.shape
        idx = torch.arange(s, device=seg.device).expand(b, s)
        boundary = torch.ones_like(seg, dtype=torch.bool)
        boundary[:, 1:] = seg[:, 1:] != seg[:, :-1]
        start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
        return (idx - start).int()

    return pos(segment_ids.q), pos(segment_ids.kv)


def _varlen_segs(cu_q, cu_k, total_q: int, total_k: int):
    """(q_seg, kv_seg, q_pos, kv_pos), each (1, total), from cu_seqlens.

    Each token's sequence index and position in it; q positions are shifted
    by len_k - len_q of their sequence, so the one compare kv_pos <= q_pos
    is lower-right-aligned causal in every sequence. Tokens past cu[-1]
    (padding in the packed buffer) get the pad sentinels: -2 for q (JAX
    gives them -1, the key's sentinel, and then a tail row sees the tail
    keys of its own tile; here it sees no key, so its O is 0 and its LSE 0)
    and -1 for kv."""
    cu_q = torch.as_tensor(cu_q).long()
    cu_k = torch.as_tensor(cu_k).long()

    def seg_and_pos(cu, total, pad):
        idx = torch.arange(total, device=cu.device)
        seg = torch.searchsorted(cu, idx, right=True) - 1
        pos = idx - cu[seg]
        return torch.where(idx < cu[-1], seg, pad), pos

    q_seg, q_pos = seg_and_pos(cu_q, total_q, Q_PAD_SEG)
    kv_seg, kv_pos = seg_and_pos(cu_k, total_k, KV_PAD_SEG)
    shift = torch.diff(cu_k) - torch.diff(cu_q)  # len_k - len_q per sequence
    q_pos = q_pos + shift[q_seg.clamp(0, shift.shape[0] - 1)]
    return tuple(x.int()[None] for x in (q_seg, kv_seg, q_pos, kv_pos))


def varlen_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k,
               max_seqlen_q: int | None = None,
               max_seqlen_k: int | None = None, is_causal: bool = False, *,
               sm_scale: float | None = None, block_sizes=None,
               interpret: bool | None = None,
               window_size: tuple | None = None,
               softcap: float | None = None):
    """Packed variable-length forward.

    q: (total_q, h, d); k/v: (total_k, hk, d); cu_seqlens int (nseq + 1,)
    on any device. Returns o (total_q, h, d) and lse (h, total_q) fp32, the
    packed LSE ``varlen_bwd`` takes. ``window_size`` is a sliding window
    over within-sequence positions (lower-right aligned per sequence).
    ``max_seqlen_*`` are accepted and unused, as in the JAX package;
    ``block_sizes`` and ``interpret`` as in :func:`fwd`."""
    reject_unported("varlen_fwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    segs = _varlen_segs(torch.as_tensor(cu_seqlens_q, device=q.device),
                        torch.as_tensor(cu_seqlens_k, device=q.device),
                        q.shape[0], k.shape[0])
    o, lse = fwd(q[None], k[None], v[None], is_causal, sm_scale=sm_scale,
                 segs=segs, window_size=window_size, softcap=softcap)
    return o[0], lse[0]


def varlen_bwd(q, k, v, o, lse, do, cu_seqlens_q, cu_seqlens_k,
               max_seqlen_q: int | None = None,
               max_seqlen_k: int | None = None, is_causal: bool = False, *,
               sm_scale: float | None = None, block_sizes=None,
               interpret: bool | None = None,
               window_size: tuple | None = None,
               softcap: float | None = None):
    """Packed variable-length backward: (dq, dk, dv) in the packed layouts
    of q and k. ``lse`` is the packed (h, total_q) LSE of
    :func:`varlen_fwd`; the other arguments as there."""
    reject_unported("varlen_bwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    segs = _varlen_segs(torch.as_tensor(cu_seqlens_q, device=q.device),
                        torch.as_tensor(cu_seqlens_k, device=q.device),
                        q.shape[0], k.shape[0])
    dq, dk, dv = bwd(q[None], k[None], v[None], o[None], lse[None], do[None],
                     is_causal, sm_scale=sm_scale, segs=segs,
                     window_size=window_size, softcap=softcap)
    return dq[0], dk[0], dv[0]
