"""Deterministic identity-pattern test inputs, as in the JAX package's
``utils/debug_inputs.py`` (which builds them with ``jax.numpy``; this is the
port's own torch copy).

Token ``i`` of every head is the one-hot row ``e_{i mod head_dim}``. Score
matrices then hold exact 0/1 blocks and outputs become readable index
patterns, so an off-by-one block boundary reads as a shifted stripe. A query
whose one-hot row matches exactly one key's puts nearly all its attention on
that key when the scale is large: the case in which the backward's dP - D
has to cancel.
"""

from __future__ import annotations

import torch


def identity_sequence(seqlen: int, heads: int, head_dim: int, dtype,
                      device="cuda"):
    """(seqlen, heads, head_dim): row i is one-hot at column i % head_dim,
    identical across heads."""
    rows = torch.eye(head_dim, dtype=dtype, device=device)[
        torch.arange(seqlen, device=device) % head_dim]
    return rows[:, None, :].expand(seqlen, heads, head_dim)


def identity_batch(batch: int, seqlen: int, heads: int, head_dim: int, dtype,
                   device="cuda"):
    """(batch, seqlen, heads, head_dim), the same pattern in every batch row
    (a contiguous tensor)."""
    seq = identity_sequence(seqlen, heads, head_dim, dtype, device)
    return seq[None].expand(batch, *seq.shape).contiguous()


def identity_packed(lens, heads: int, head_dim: int, dtype, device="cuda"):
    """Packed (sum(lens), heads, head_dim); the one-hot pattern restarts at
    column 0 for each sequence, so a cross-sequence leak shows up as a
    phase-shifted stripe."""
    lens = [int(n) for n in lens]
    if not lens or sum(lens) == 0:
        return torch.zeros((0, heads, head_dim), dtype=dtype, device=device)
    return torch.cat([identity_sequence(n, heads, head_dim, dtype, device)
                      for n in lens if n > 0], dim=0)
