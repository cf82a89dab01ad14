"""Per-block segment metadata for the segmented (varlen) attention kernels.

The counterpart of the JAX package's ``ops/segments.py``. For each block of
one axis (query rows in the forward and dq, keys in dkv) it computes the
contiguous [lo, hi] range of blocks of the other axis that can hold ANY live
token: one of the same segment that the causal compare allows. A CUDA
kernel reads its CTA's range from the ``(b, n_blocks)`` arrays and loops over
those tiles only, so a packed batch of S equal sequences costs about 1 / S of
the dense call. The JAX package also needs ``clamp_for_dma``, which clamps a
streamed block index into the range so that Pallas elides the DMAs of the
grid steps outside it; the CUDA kernels' loop over [lo, hi] loads nothing
outside the range, so it has no counterpart here.

Correctness depends only on the ranges being an OVER-approximation. The
searchsorted derivation needs the packed ``(seg, pos)`` key to be
non-decreasing along the streamed axis (true for cu_seqlens layouts); a
batch row whose key is not sorted falls back to the full range, as in JAX.

Everything here runs on the tensors' device with no host synchronisation
(no ``.item()``, no branch on tensor data), so a later CUDA graph can
capture it.
"""

from __future__ import annotations

import torch

# pad sentinels of the query and the key axis: they never match each other
# or a real segment (ids >= 0)
Q_PAD_SEG = -2
KV_PAD_SEG = -1


# keys are seg * SPAN + pos in int64: any int32 position fits in a span, and
# the pads take the largest id, which real ids stay below
SPAN = 1 << 32
PAD_KEY_SEG = (1 << 31) - 1


def _lex_keys(seg, pos):
    """Non-decreasing key per token: seg * SPAN + pos, with pad tokens
    (seg < 0) pushed past every real segment."""
    return torch.where(seg < 0, PAD_KEY_SEG, seg) * SPAN + pos


def block_ranges(a_seg, a_pos, o_seg, o_pos, block_a: int, block_o: int, *,
                 causal: bool, causal_dir: str):
    """For each block of the ``a`` axis, the [lo, hi] (inclusive) range of
    ``o``-axis blocks holding any token some a-row may attend to or be seen
    by.

    a_seg, a_pos (b, sa): the axis a CTA owns; o_seg, o_pos (b, so): the
    axis it streams; int32 ids below 2**31 - 1 and int32 positions.
    ``causal_dir`` "kv_le_q" (forward and dq: o is the kv axis, allowed iff
    kv_pos <= q_pos) or "q_ge_kv" (dkv: o is the q axis, allowed iff q_pos
    >= kv_pos). Returns (lo, hi) int32 (b, ceil(sa / block_a)); an empty
    range has lo > hi. A length that is not a multiple of its block counts
    its last partial block (JAX's callers pad to whole blocks with the
    sentinels, which gives the same ranges).

    The keys are int64 over a span that holds every int32 position, so they
    cannot overflow: the JAX package's int32 keys, sized from the data,
    need a guard that falls back to the full range where they might, and
    here nothing is left for it to guard. Only the order of the keys
    decides the ranges, so they equal JAX's wherever its guard holds."""
    if causal_dir not in ("kv_le_q", "q_ge_kv"):
        raise ValueError(f"causal_dir must be 'kv_le_q' or 'q_ge_kv', got "
                         f"{causal_dir!r}")
    a_seg, a_pos, o_seg, o_pos = (x.long() for x in (a_seg, a_pos, o_seg,
                                                     o_pos))
    b, sa = a_seg.shape
    so = o_seg.shape[1]
    o_key = _lex_keys(o_seg, o_pos).contiguous()

    # smallest and largest o key a row could match: its segment's first and
    # last token, narrowed by the causal compare on the side it bounds
    base = a_seg * SPAN
    key_lo = base + a_pos if causal and causal_dir == "q_ge_kv" \
        else base - SPAN // 2
    key_hi = base + a_pos if causal and causal_dir == "kv_le_q" \
        else base + (SPAN // 2 - 1)
    lo_tok = torch.searchsorted(o_key, key_lo, side="left")
    hi_tok = torch.searchsorted(o_key, key_hi, side="right") - 1

    valid = a_seg >= 0
    lo_tok = torch.where(valid, lo_tok, so)  # out of the block's min
    hi_tok = torch.where(valid, hi_tok, -1)  # out of the block's max
    na = -(-sa // block_a)
    pad = na * block_a - sa
    if pad:
        lo_tok = torch.nn.functional.pad(lo_tok, (0, pad), value=so)
        hi_tok = torch.nn.functional.pad(hi_tok, (0, pad), value=-1)
    lo_blk = lo_tok.view(b, na, block_a).amin(-1) // block_o
    hi_blk = hi_tok.view(b, na, block_a).amax(-1)
    hi_blk = torch.where(hi_blk >= 0, hi_blk // block_o, -1)

    # the ranges hold only where the o keys are sorted
    sorted_ok = (o_key[:, 1:] >= o_key[:, :-1]).all(1, keepdim=True)
    no = -(-so // block_o)
    lo_blk = torch.where(sorted_ok, lo_blk, 0)
    hi_blk = torch.where(sorted_ok, hi_blk, no - 1)
    return lo_blk.int(), hi_blk.int()
