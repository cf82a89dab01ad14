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

A draw is the exponential race ``argmax(p / E)``, E ~ Exp(1) from the row's
generator (what ``torch.multinomial`` computes for one sample, without its
check of ``p``, which reads the device), so nothing here waits for the
card: the multi-step and draft rollouts sample k tokens with no readback.

Speculative decoding draws from three sub-streams of (seed, position), each
keyed on a tag as well (``_spec_keys``): the draft's proposal, the accept
uniform and the residual resample, independent of one another and of the
plain stream. Greedy rows take no random bits: a proposal is accepted iff
it is the target's argmax, and the resample is that argmax.
"""

from __future__ import annotations

import torch


_MASK64 = (1 << 64) - 1


def _splitmix(x: int) -> int:
    """The splitmix64 finaliser of ``x`` (64 bits)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _row_generator(seed: int, position: int, device,
                   tag: int = 0) -> torch.Generator:
    """A generator whose state depends only on (seed, position), and on
    ``tag`` for a speculative sub-stream (0: the plain stream). The pair
    goes through the splitmix64 finaliser, so every bit of the 64-bit seed
    depends on both (the CPU generator reads only the low 32 bits); a tag
    goes through it once more."""
    x = _splitmix(((int(seed) & 0xFFFFFFFF) << 32)
                  | (int(position) & 0xFFFFFFFF))
    if tag:
        x = _splitmix(x ^ (int(tag) * 0xD1B54A32D192ED03 & _MASK64))
    g = torch.Generator(device=device)
    g.manual_seed(x)
    return g


def _race(weights, g: torch.Generator):
    """One index drawn with probability proportional to ``weights`` (a
    (vocab,) row, >= 0): ``argmax(weights / E)``, E ~ Exp(1) from ``g``.
    For softmax weights this is ``torch.multinomial(weights, 1, generator=g)``
    bit for bit, without its check, which reads the device."""
    return torch.argmax(weights / torch.empty_like(weights).exponential_(
        1, generator=g))


def _mask_row(scaled, top_k: int, top_p: float):
    """Apply top-k and top-p to one (vocab,) row of temperature-scaled
    logits; excluded entries become -inf. Every token tied with the cut
    threshold is kept."""
    v = scaled.shape[0]
    srt = torch.sort(scaled, descending=True).values
    # fills, not copies from the host: nothing here waits for the card
    thr = scaled.new_full((), float("-inf"))
    if top_k > 0:
        thr = torch.maximum(thr, srt[min(top_k - 1, v - 1)])
    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(srt, dim=0), dim=0)
        cut = torch.searchsorted(cum, cum.new_full((1,), top_p))
        thr = torch.maximum(thr, srt[cut.clamp(max=v - 1)][0])
    return torch.where(scaled >= thr, scaled, torch.full_like(scaled, float("-inf")))


def sample_tokens(logits, temps, top_ks, top_ps, seeds, positions, *,
                  need_filters: bool):
    """One token per row. logits (b, vocab); temps, top_ks, top_ps, seeds,
    positions: per-row Python sequences (temperature <= 0 = greedy, top_k 0
    and top_p 1.0 = off). ``need_filters`` False skips top-k and top-p for
    every row, as the JAX package compiles them out when no request of the
    batch uses them. Returns (b,) int64 on the logits' device; reads
    nothing back from it."""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    for i, t in enumerate(temps):
        if t <= 0.0:
            continue
        row = logits[i] / max(float(t), 1e-6)
        if need_filters and (top_ks[i] > 0 or top_ps[i] < 1.0):
            row = _mask_row(row, int(top_ks[i]), float(top_ps[i]))
        g = _row_generator(seeds[i], positions[i], logits.device)
        out[i] = _race(torch.softmax(row, dim=-1), g)
    return out


# The speculative sub-streams of (seed, position): the draft's draw, the
# accept uniform and the residual resample (independent, or rejection
# sampling is not exact)
_DRAFT_TAG = 1
_ACCEPT_TAG = 2
_RESAMPLE_TAG = 3


def _spec_keys(seeds, positions, tag, device) -> list[torch.Generator]:
    """One generator per row for sub-stream ``tag`` at absolute output
    ``positions`` (per-row host sequences)."""
    return [_row_generator(s, p, device, tag) for s, p in zip(seeds, positions)]


def draft_sample(logits, temps, seeds, positions):
    """The draft model's next token: greedy rows the argmax, others one
    draw from the temperature-scaled softmax on the ``_DRAFT_TAG``
    sub-stream (no top-k/top-p: the engine rejects filtered requests under
    speculation). logits (b, V); temps, seeds, positions per-row sequences.
    Returns (b,) int64 on the logits' device, reading nothing back."""
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    keys = _spec_keys(seeds, positions, _DRAFT_TAG, logits.device)
    for i, t in enumerate(temps):
        if t > 0.0:
            out[i] = _race(torch.softmax(logits[i] / max(float(t), 1e-6),
                                         dim=-1), keys[i])
    return out


def spec_accept(target_logits, draft_logits, draft_tokens, temps, seeds,
                positions):
    """Speculative-decoding acceptance (Leviathan et al. rejection sampling).

    target_logits (b, g+1, V): the target's logits at the g+1 verification
    positions (the fed token and the g proposals); draft_logits (b, g, V):
    the distributions the proposals were drawn from; draft_tokens (b, g);
    temps, seeds, positions per-row sequences, positions the output index
    of the first token emitted this step. Proposal j of a sampled row is
    accepted when u * q(d) < p(d) (u uniform on the ``_ACCEPT_TAG`` stream
    at position + j), and the first rejection resamples from max(p - q, 0)
    (``_RESAMPLE_TAG``); a row that accepts all draws its bonus token from
    p. A greedy row accepts a proposal iff it equals the target's argmax,
    and resamples that argmax, with no random bits.

    Returns (out_tokens (b, g+1) int64, n_emit (b,) int64): row i emits
    ``out_tokens[i, :n_emit[i]]``. Emitted tokens are distributed exactly as
    g+1 sequential target samples. Reads nothing back from the device."""
    b, c, v = target_logits.shape
    g = c - 1
    dev = target_logits.device
    target_logits = target_logits.float()
    greedy_tok = torch.argmax(target_logits, dim=-1)       # (b, g+1)
    d = draft_tokens.to(dev).long()
    sampled = [i for i, t in enumerate(temps) if t > 0.0]
    # greedy rows: p is one-hot at the target's argmax
    accept = d == greedy_tok[:, :g]                        # (b, g)
    resample = greedy_tok.clone()
    if sampled:
        idx = torch.tensor(sampled, device=dev)
        t = torch.tensor([max(float(temps[i]), 1e-6) for i in sampled],
                         device=dev)[:, None, None]
        p = torch.softmax(target_logits[idx] / t, dim=-1)   # (n, g+1, V)
        q = torch.softmax(draft_logits[idx].float() / t, dim=-1)
        ds = d[idx]
        pd = p[:, :g].gather(-1, ds[..., None])[..., 0]
        qd = q.gather(-1, ds[..., None])[..., 0]
        u = torch.empty((len(sampled), c), device=dev)
        resid = torch.cat([(p[:, :g] - q).clamp(min=0.0), p[:, g:]], dim=1)
        # an all-zero residual (p == q) only where the proposal was accepted
        resid = torch.where(resid.sum(-1, keepdim=True) > 0.0, resid, p)
        res = torch.empty((len(sampled), c), dtype=torch.long, device=dev)
        for r, i in enumerate(sampled):
            pos = [positions[i] + j for j in range(c)]
            for j, key in enumerate(_spec_keys([seeds[i]] * c, pos,
                                               _ACCEPT_TAG, dev)):
                u[r, j] = torch.rand((), device=dev, generator=key)
            for j, key in enumerate(_spec_keys([seeds[i]] * c, pos,
                                               _RESAMPLE_TAG, dev)):
                res[r, j] = _race(resid[r, j], key)
        accept[idx] = u[:, :g] * qd < pd
        resample[idx] = res
    n_accept = torch.cumprod(accept.long(), dim=1).sum(dim=1)   # (b,)
    keep = torch.arange(g, device=dev)[None, :] < n_accept[:, None]
    out = torch.cat([torch.where(keep, d, resample[:, :g]),
                     resample[:, g:]], dim=1)
    return out, n_accept + 1


def token_logprobs(logits, tokens):
    """log p(token) under the raw model distribution (no temperature, no
    filters). logits (b, vocab), tokens (b,) -> (b,) fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, tokens.long()[:, None])[:, 0]
