"""Token sampling for the serving engine.

Greedy rows take the argmax (the first index of the maximum, as JAX's
argmax). Other rows sample from temperature-scaled logits, optionally
filtered by top-k and top-p (``_mask_row``).

Replay property: the random bits for a request's token at position ``p``
depend only on ``(seed, p)``: each sampled row draws from its own
``torch.Generator`` seeded from that pair, so preemption and re-prefill
replay the identical completion. The bits differ from the JAX package's
(``fold_in(PRNGKey(seed), p)``): the same seed gives other samples here,
with the same distribution; greedy rows agree exactly.
"""

from __future__ import annotations

import torch


_MASK64 = (1 << 64) - 1


def _row_generator(seed: int, position: int, device) -> torch.Generator:
    """A generator whose state depends only on (seed, position). The pair
    goes through the splitmix64 finaliser, so every bit of the 64-bit seed
    depends on both (the CPU generator reads only the low 32 bits)."""
    x = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    g = torch.Generator(device=device)
    g.manual_seed(x ^ (x >> 31))
    return g


def _mask_row(scaled, top_k: int, top_p: float):
    """Apply top-k and top-p to one (vocab,) row of temperature-scaled
    logits; excluded entries become -inf. Every token tied with the cut
    threshold is kept."""
    v = scaled.shape[0]
    srt = torch.sort(scaled, descending=True).values
    thr = torch.tensor(float("-inf"), device=scaled.device)
    if top_k > 0:
        thr = torch.maximum(thr, srt[min(top_k - 1, v - 1)])
    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(srt, dim=0), dim=0)
        cut = int(torch.searchsorted(cum, torch.tensor(
            [top_p], dtype=cum.dtype, device=cum.device))[0])
        thr = torch.maximum(thr, srt[min(cut, v - 1)])
    return torch.where(scaled >= thr, scaled, torch.full_like(scaled, float("-inf")))


def sample_tokens(logits, temps, top_ks, top_ps, seeds, positions, *,
                  need_filters: bool):
    """One token per row. logits (b, vocab); temps, top_ks, top_ps, seeds,
    positions: per-row Python sequences (temperature <= 0 = greedy, top_k 0
    and top_p 1.0 = off). ``need_filters`` False skips top-k and top-p for
    every row, as the JAX package compiles them out when no request of the
    batch uses them. Returns (b,) int64 on the logits' device."""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temps):
        if t <= 0.0:
            continue
        row = logits[i] / max(float(t), 1e-6)
        if need_filters and (top_ks[i] > 0 or top_ps[i] < 1.0):
            row = _mask_row(row, int(top_ks[i]), float(top_ps[i]))
        g = _row_generator(seeds[i], positions[i], logits.device)
        out[i] = torch.multinomial(torch.softmax(row, dim=-1), 1, generator=g)[0]
    return out


def token_logprobs(logits, tokens):
    """log p(token) under the raw model distribution (no temperature, no
    filters). logits (b, vocab), tokens (b,) -> (b,) fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, tokens.long()[:, None])[:, 0]
