"""Multi-step decode: ``decode_block`` target decode steps per engine step.

The counterpart of ``flash_attention_tpu/serving/multistep.py``. The engine
(``Engine(decode_block=k)``) hands the whole block to ``decode_rollout``,
which runs k ``decode_step``s back to back on the card, feeding each step
the previous step's sample, and returns the (b, k) tokens for ONE readback:
the per-token host round trip (the readback of the sampled tokens, the
scheduler's tick, the batch's host-side tables) is paid once a block. The
JAX package runs the block as one ``lax.scan`` dispatch; here each step is
still its own launches (a CUDA graph over the block is later work), but
nothing reads the device between them: the write slot comes from the page
table on the card, and the sampling keys depend only on (seed, position),
which the host knows.

Exactness: step j samples output index ``positions + j`` with the
single-step engine's key, so the emitted tokens are the single-step
engine's. Rows that stop inside a block drop the tail; its K/V writes
landed in reserved, not yet committed slots that the engine's
``seq_truncate`` returns.

``tp_decode_rollout`` is the rollout on one rank of a tensor-parallel
engine: each step's ``decode_step`` runs on the rank's part of the weights
and its kv heads, with the two all-reduces a layer, so the logits are
replicated and every rank samples the same tokens with no further
communication. Its all-reduces read the card (``parallel.mesh.psum``).
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.parallel import tp_inference
from flash_attention_tpu_torch.parallel.mesh import axis_size
from flash_attention_tpu_torch.serving import sampling


def decode_rollout(params, k_pages, v_pages, k_scales, v_scales, tokens,
                   lengths, page_tables, temps, top_ks, top_ps, seeds,
                   positions, lora_ids, cfg: llama.LlamaConfig, n_steps: int,
                   need_filters: bool, want_logprobs: bool, tp_axis=None):
    """``n_steps`` autoregressive target tokens per row, with no readback.

    tokens (b,): the last committed token per row; lengths (b,) int32: the
    committed length including it; page_tables (b, pages_per_seq) int32,
    device tensors. temps, top_ks, top_ps, seeds, positions: per-row host
    sequences, positions the output index of the first token. Step j feeds
    the previous step's sample, writes its K/V at position ``lengths - 1 +
    j`` (the engine reserves the slots beforehand) and samples output
    ``positions + j`` with ``sampling.sample_tokens``. The caches are
    updated in place. ``lora_ids`` ((b,) device tensor, or None) selects
    each row's adapter in every step; ``tp_axis`` ((mesh, axis)) runs each
    step on one rank's part (``tp_decode_rollout``).

    Returns (tokens (b, n_steps) int64, logprobs (b, n_steps) fp32, zeros
    unless ``want_logprobs``, k_pages, v_pages, k_scales, v_scales)."""
    ps = k_pages.shape[-2]
    tok, ln = tokens, lengths
    toks, lps = [], []
    for j in range(n_steps):
        wpage = page_tables.gather(1, ((ln - 1) // ps).long()[:, None])[:, 0]
        woff = (ln - 1) % ps
        logits, *_ = llama.decode_step(
            params, k_pages, v_pages, k_scales, v_scales, tok, ln,
            page_tables, wpage.int(), woff.int(), cfg, tp_axis=tp_axis,
            lora_ids=lora_ids)
        tok = sampling.sample_tokens(logits, temps, top_ks, top_ps, seeds,
                                     [p + j for p in positions],
                                     need_filters=need_filters)
        toks.append(tok)
        lps.append(sampling.token_logprobs(logits, tok) if want_logprobs
                   else torch.zeros(tok.shape, device=tok.device))
        ln = ln + 1
    return (torch.stack(toks, 1), torch.stack(lps, 1), k_pages, v_pages,
            k_scales, v_scales)


def tp_decode_rollout(params, k_pages, v_pages, k_scales, v_scales, tokens,
                      lengths, page_tables, temps, top_ks, top_ps, seeds,
                      positions, *, cfg: llama.LlamaConfig, n_steps: int,
                      need_filters: bool, want_logprobs: bool, mesh,
                      axis: str = "model"):
    """Tensor-parallel multi-step decode on this rank: ``decode_rollout``
    on its part of ``params`` (the full or the sharded tree) and its kv
    heads of the cache, with the local config and two all-reduces a layer.
    The post-all-reduce logits are replicated, so every rank draws the SAME
    tokens and the fed token stays consistent across ranks with no extra
    communication. Returns as ``decode_rollout``, the cache rank-local."""
    tp = axis_size(mesh, axis)
    return decode_rollout(
        tp_inference.shard_params(params, cfg, mesh, axis), k_pages, v_pages,
        k_scales, v_scales, tokens, lengths, page_tables, temps, top_ks,
        top_ps, seeds, positions, None, tp_inference.local_config(cfg, tp),
        n_steps, need_filters, want_logprobs, tp_axis=(mesh, axis))
