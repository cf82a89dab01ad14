"""Speculative decoding: the draft model's proposal rollout.

The counterpart of ``flash_attention_tpu/serving/spec.py``. A small draft
model proposes ``n_draft`` tokens per row (``draft_rollout``); the engine's
target model scores them all in one ``prefill_chunk``
(``Engine._spec_decode_batch``) and ``sampling.spec_accept`` keeps the
longest accepted prefix and one corrected or bonus token. The emitted tokens
are distributed exactly as sequential target samples.

The draft keeps its own page pools but shares the allocator's page ids and
tables with the target's cache, so one page table drives both models. The
JAX package runs the rollout as one ``lax.scan`` dispatch; here the steps
are the draft's own launches with nothing read back between them.
``tp_draft_rollout`` runs the rollout on one rank of a tensor-parallel
engine, the draft sharded like the target.
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.parallel import tp_inference
from flash_attention_tpu_torch.parallel.mesh import axis_size
from flash_attention_tpu_torch.serving import sampling


def draft_rollout(params, k_pages, v_pages, k_scales, v_scales, tokens,
                  lengths, page_tables, temps, seeds, positions,
                  cfg: llama.LlamaConfig, n_draft: int, tp_axis=None):
    """``n_draft`` autoregressive draft tokens per row, with no readback.

    k_pages/v_pages (and k_scales/v_scales or None): the DRAFT model's
    cache, updated in place. tokens (b,): the last committed token per row;
    lengths (b,) int32 including it; page_tables (b, pages_per_seq) int32,
    shared with the target's cache; device tensors. temps, seeds, positions:
    per-row host sequences, positions the output index of the first drafted
    token. Draft token j is drawn by ``sampling.draft_sample`` at position
    ``positions + j``.

    Runs n_draft + 1 decode steps, as the JAX rollout does: each step writes
    only the FED token's K/V, so the last step feeds d_{g-1} for its write
    alone (its sample is not taken): when verification accepts every
    proposal and the bonus token, the next rollout reads that slot. Writes
    past the committed frontier land in reserved slots that later feeds
    rewrite before ``lengths`` lets a read reach them. ``tp_axis`` ((mesh,
    axis)) runs each step on one rank's part (``tp_draft_rollout``).

    Returns (draft_tokens (b, n_draft) int64, draft_logits (b, n_draft, V)
    fp32, k_pages, v_pages, k_scales, v_scales)."""
    ps = k_pages.shape[-2]
    tok, ln = tokens, lengths
    toks, logs = [], []
    for j in range(n_draft + 1):
        wpage = page_tables.gather(1, ((ln - 1) // ps).long()[:, None])[:, 0]
        woff = (ln - 1) % ps
        logits, *_ = llama.decode_step(
            params, k_pages, v_pages, k_scales, v_scales, tok, ln,
            page_tables, wpage.int(), woff.int(), cfg, tp_axis=tp_axis)
        if j == n_draft:
            break  # this step fed d_{g-1} for its K/V write only
        tok = sampling.draft_sample(logits, temps, seeds,
                                    [p + j for p in positions])
        toks.append(tok)
        logs.append(logits)
        ln = ln + 1
    return (torch.stack(toks, 1), torch.stack(logs, 1), k_pages, v_pages,
            k_scales, v_scales)


def tp_draft_rollout(params, k_pages, v_pages, k_scales, v_scales, tokens,
                     lengths, page_tables, temps, seeds, positions, *,
                     cfg: llama.LlamaConfig, n_draft: int, mesh,
                     axis: str = "model"):
    """Tensor-parallel draft rollout on this rank: ``draft_rollout`` on its
    part of the draft's ``params`` and its kv heads of the draft's cache,
    with two all-reduces a layer (like ``tp_decode_step``), so the logits
    are replicated and every rank draws the SAME draft tokens. Returns as
    ``draft_rollout``, the cache rank-local."""
    tp = axis_size(mesh, axis)
    return draft_rollout(
        tp_inference.shard_params(params, cfg, mesh, axis), k_pages, v_pages,
        k_scales, v_scales, tokens, lengths, page_tables, temps, seeds,
        positions, tp_inference.local_config(cfg, tp), n_draft,
        tp_axis=(mesh, axis))
