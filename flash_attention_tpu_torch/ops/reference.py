"""Plain PyTorch attention: the fp32 oracle and its autograd backward.

The same semantics as the JAX package's ``ops/reference.py``:

* GQA head-group expansion (q heads // kv heads).
* Lower-right-aligned causal masking: (row, col) is masked iff
  ``col - row > seqlen_k - seqlen_q``; a (left, right) window bounds the
  same relative offset (entries < 0 are unbounded).
* Segment ids and positions (packed batches): with positions the relative
  offset is ``kv_pos - q_pos`` instead, for causal and the window alike, and
  a query sees only keys of its own segment id.
* Optional softcap ``softcap * tanh(s / softcap)`` before masking.
* Fully-masked rows give O = 0 and LSE = ``empty_lse`` (0 by default).
* LSE = m + log(sum(exp(s - m))), natural log, shape (batch, heads, sq).

All math runs in float32 whatever the input dtype; O is cast back. This is
the plain version behind ``ops.attention.fwd`` on the CPU, and what the CUDA
kernel is held against on the card. ``reference_attention_bwd`` is autograd
through it: the oracle gradients the backward is held against.
"""

from __future__ import annotations

import torch


def _build_mask(seqlen_q: int, seqlen_k: int, causal: bool, window=None,
                device=None, segs=None):
    """Boolean (sq, sk) mask, or (b, sq, sk) with ``segs``; True = attend;
    None when nothing is masked.

    ``segs`` is (q_seg, kv_seg, q_pos, kv_pos), each (b, s) int, any entry
    None: segment ids mask unequal pairs, and positions replace the
    lower-right row and column offsets."""
    q_seg, kv_seg, q_pos, kv_pos = segs if segs is not None else (None,) * 4
    if q_pos is None:
        rows = torch.arange(seqlen_q, device=device)[:, None]
        cols = torch.arange(seqlen_k, device=device)[None, :]
        rel = (cols - rows) - (seqlen_k - seqlen_q)
    else:
        rel = kv_pos[..., None, :].long() - q_pos[..., :, None].long()
    mask = None
    if causal:
        mask = rel <= 0
    if window is not None:
        wl, wr = window
        if wl is not None and wl >= 0:
            mask = rel >= -wl if mask is None else mask & (rel >= -wl)
        if wr is not None and wr >= 0:
            mask = rel <= wr if mask is None else mask & (rel <= wr)
    if q_seg is not None:
        same = q_seg[..., :, None] == kv_seg[..., None, :]
        mask = same if mask is None else mask & same
    return mask


def reference_attention(q, k, v, causal: bool = False,
                        sm_scale: float | None = None, q_segment_ids=None,
                        kv_segment_ids=None, q_positions=None,
                        kv_positions=None, window=None,
                        softcap: float | None = None, empty_lse: float = 0.0):
    """Dense attention. q (b, sq, h, d); k/v (b, sk, hk, d).

    ``q_segment_ids``/``kv_segment_ids`` (b, sq)/(b, sk) int: tokens attend
    only within equal ids; ``q_positions``/``kv_positions``: positions for
    the causal compare and the window (``kv_pos - q_pos``) in place of the
    row and column indices. Returns (o (b, sq, h, d) in q.dtype, lse
    (b, h, sq) float32)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(f"num_heads {h} must be divisible by num_heads_k {hk}")
    group = h // hk
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    qf = q.float().transpose(1, 2)                                   # b h q d
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)   # b h k d
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    # where no gradient is taken, the (b, h, sq, sk) scores are updated in
    # place: the same values, a third of the memory traffic
    new = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    s = s * scale if new else s.mul_(scale)
    if softcap is not None:
        s = (softcap * torch.tanh(s / softcap) if new
             else s.div_(softcap).tanh_().mul_(softcap))
    mask = _build_mask(sq, sk, causal, window, device=q.device,
                       segs=(q_segment_ids, kv_segment_ids, q_positions,
                             kv_positions))
    if mask is not None:
        mask = ~(mask if mask.dim() == 2 else mask[:, None])
        s = (s.masked_fill(mask, float("-inf")) if new
             else s.masked_fill_(mask, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    alive = m > float("-inf")
    m0 = torch.where(alive, m, torch.zeros_like(m))
    p = torch.exp(s - m0) if new else s.sub_(m0).exp_()
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(alive, l, torch.ones_like(l))
    o = torch.matmul(p, vf)
    o = o / denom if new else o.div_(denom)
    lse = torch.where(alive, m + torch.log(denom),
                      torch.full_like(m, empty_lse))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def reference_attention_bwd(q, k, v, do, causal: bool = False,
                            sm_scale: float | None = None, window=None,
                            softcap: float | None = None, segs=None):
    """Oracle gradients (dq, dk, dv), fp32, by autograd through the fp32
    ``reference_attention`` (causal, window, softcap and ``segs``, the
    (q_seg, kv_seg, q_pos, kv_pos) of a packed batch, included)."""
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    seg_kw = {} if segs is None else dict(zip(
        ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions"),
        segs))
    with torch.enable_grad():
        o, _ = reference_attention(qf, kf, vf, causal=causal,
                                   sm_scale=sm_scale, window=window,
                                   softcap=softcap, **seg_kw)
        return torch.autograd.grad(o, (qf, kf, vf), do.float())
