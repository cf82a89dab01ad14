"""Public flash-attention API: ``fwd``, ``bwd``, the differentiable
``flash_attention`` and the packed variable-length ``varlen_fwd`` and
``varlen_bwd``.

Layout (batch, seqlen, heads, head_dim) as in the JAX package; LSE comes back
(batch, heads, seqlen_q) fp32. On a CUDA tensor each call launches the
hand-written kernels (``ops.flash_fwd``, ``ops.flash_bwd``); on a CPU tensor
it runs their plain fp32 versions. The kernels take bf16 and fp16 as they are
and mask their own ragged edges, so nothing is upcast or padded here, except
a head dim other than 64, 128, 256, 384 or 512 up to 512: the kernels run it
zero-padded to the next of these (:func:`padded_head_dim`), as the JAX
package pads; the backward takes the same head dims
(:func:`backward_head_dim`). Above 512 the card's kernels raise.

Packed batches run the kernels' segmented instances: ``fwd``/``bwd`` take
``segs`` (segment ids and positions), ``flash_attention`` takes
``SegmentIds`` and derives the positions, and ``varlen_*`` build both from
cu_seqlens, with q positions shifted by len_k - len_q per sequence so that
causal is lower-right aligned in each.

Long keys: a dense forward over more than ``KV_SPLIT`` keys (causal, right
window or none) runs one kernel launch per chunk of ``KV_SPLIT`` keys and
merges the chunks' (O, LSE) with :func:`merge_partials`, as the JAX package
does; ``fwd(kv_split=)`` sets the chunk. The running O is held in fp32
across the merges and rounded once, where JAX rounds it after every merge.
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
    """The head dim the forward, paged and kv-write kernels run ``d`` at: 64,
    128, 256, 384 and 512 as they are, any other d up to 512 zero-padded to
    the next of them (192 runs at 256, 257-384 at 384 and 385-512 at 512,
    as the JAX package pads them to a multiple of 128)."""
    for kd in _fwd_mod.HEAD_DIMS:
        if d <= kd:
            return kd
    raise NotImplementedError(
        f"head_dim {d} on the card: the kernels take d <= 512; the JAX "
        f"package pads d above 512 to a multiple of 128 (576 to 640), which "
        f"is not ported yet (ROADMAP.md, queue B part 1)")


def backward_head_dim(d: int) -> int:
    """The head dim the backward kernels run ``d`` at: as
    :func:`kernel_head_dim` (257-384 at 384, 385-512 at 512). Above 512 it
    raises, as that does, naming ROADMAP: there is no plain fallback on the
    card."""
    return kernel_head_dim(d)


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


def _merge_weights(lse1, lse2):
    """(a1, a2, lse) of a merge: each partial's weight per row, (b, sq, h,
    1) fp32, and the union's LSE (see :func:`merge_partials`)."""
    lse_max = torch.maximum(lse1, lse2)
    alive = lse_max != float("-inf")
    lm = torch.where(alive, lse_max, 0.0)
    lse = torch.where(
        alive, lm + torch.log(torch.exp(lse1 - lm) + torch.exp(lse2 - lm)),
        float("-inf"))
    ls = torch.where(alive, lse, 0.0)
    a1 = torch.exp(lse1 - ls).transpose(1, 2)[..., None]
    a2 = torch.exp(lse2 - ls).transpose(1, 2)[..., None]
    return a1, a2, lse


def merge_partials(o1, lse1, o2, lse2):
    """Merge two attention partials computed over disjoint kv sets.

    o*: (b, sq, h, d); lse*: (b, h, sq) natural-log-sum-exp per row.
    Returns (o, lse) equal to attention over the union of the kv sets, o in
    o1's dtype (the products and the sum in fp32). Rows dead in one partial
    carry lse = -inf there and weigh exactly 0; rows dead in both keep
    lse = -inf and get O = 0 (the -inf - -inf of the stable log-sum-exp is
    replaced by 0, as in the JAX package). Plain PyTorch on every device:
    it is XLA, not a Pallas kernel, in the JAX package."""
    a1, a2, lse = _merge_weights(lse1, lse2)
    o = o1.float() * a1 + o2.float() * a2
    return o.to(o1.dtype), lse


def _merge_into(o, lse, oc, lsec):
    """:func:`merge_partials` of the running fp32 ``o``, updated in place,
    and a chunk's (``oc``, ``lsec``): the same products and sum without an
    fp32 copy of ``o``. Returns (o, lse)."""
    a1, a2, lse = _merge_weights(lse, lsec)
    return o.mul_(a1).add_(oc.float().mul_(a2)), lse


# Longest K/V one forward launch takes: above it a dense forward (causal, a
# right-bounded window, or none) runs chunks of KV_SPLIT keys and merges
# them (the JAX package's value and rule).
KV_SPLIT = 8192


def _fwd_split(q, k, v, split, *, causal, sm_scale, window, softcap,
               empty_lse):
    """The forward as chunks of ``split`` keys merged by
    :func:`merge_partials`. Chunk [c0, c1) is a non-causal call with the
    global band ``col - row - (sk - sq) <= wr`` rewritten in its own
    lower-right coordinates, ``<= wr + (sk - c1)``: a right-bounded window,
    or none where every row sees the whole chunk; a band of exactly
    (-1, 0) (causal's last chunk) runs as the causal call it is. Each chunk
    marks its dead rows with LSE -inf, so the merge weighs them 0; the
    running (O, LSE) stays fp32, merged in place, and rows dead in every
    chunk get O = 0 and LSE = ``empty_lse``."""
    sq, sk = q.shape[1], k.shape[1]
    band = _fwd_mod.normalize_band(causal, window)
    wr = None if band is None else band[1]
    o = lse = None
    for c0 in range(0, sk, split):
        c1 = min(c0 + split, sk)
        cwin = None
        if wr is not None and wr + (sk - c1) < sq - 1:
            cwin = (-1, wr + (sk - c1))
        causal_c = cwin == (-1, 0)
        oc, lsec = fwd(q, k[:, c0:c1], v[:, c0:c1], causal_c,
                       sm_scale=sm_scale,
                       window_size=None if causal_c else cwin,
                       softcap=softcap, empty_lse=float("-inf"), kv_split=sk)
        o, lse = (oc.float(), lsec) if o is None else _merge_into(
            o, lse, oc, lsec)
    dead = torch.isneginf(lse)
    o = torch.where(dead.transpose(1, 2)[..., None], 0.0, o)
    lse = torch.where(dead, float(empty_lse), lse)
    return o.to(q.dtype), lse


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
    ``kv_split`` (default ``KV_SPLIT``) is the most keys one launch takes:
    a dense call over more keys, with no left window bound, runs in chunks
    (:func:`_fwd_split`). ``block_sizes`` and ``interpret`` (the TPU
    kernels' tiles, Pallas interpret mode) are not ported: a value other
    than None raises NotImplementedError."""
    reject_unported("fwd", block_sizes=(block_sizes, None),
                    interpret=(interpret, None))
    _check_heads(q, k)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1]**0.5
    split = KV_SPLIT if kv_split is None else kv_split
    band = _fwd_mod.normalize_band(is_causal, window_size)
    if (segs is None and k.shape[1] > split
            and (band is None or band[0] is None)):
        return _fwd_split(q, k, v, split, causal=is_causal,
                          sm_scale=sm_scale, window=window_size,
                          softcap=softcap, empty_lse=empty_lse)
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
    return padded_head_dim(kernel, backward_head_dim(q.shape[-1]), q, k, v,
                           o, lse, do)


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
