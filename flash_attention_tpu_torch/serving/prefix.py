"""Automatic prefix caching: content-addressed reuse of prompt KV pages.

Requests sharing a prompt prefix (system prompts, few-shot preambles,
multi-turn histories) reuse the pages already holding that prefix's KV
instead of recomputing it: admission ADOPTS the cached pages (allocator
refcounts, ``seq_alloc_prefixed``) and prefill runs only the uncached
suffix through the ``prefill_chunk`` path with per-row ``done`` offsets.

Pages are keyed by a CHAIN hash — page i's key commits to every token of
pages 0..i — so a lookup is a prefix walk that stops at the first miss, and
two prompts share a page only when they agree on ALL tokens up to its end.
The registry holds one allocator pin per cached page, so a page (and its
KV) outlives the sequences that produced it; eviction (LRU, registry-only
pages first — unpinning a page other sequences still reference frees no
memory) happens on admission pressure.

The port's own copy of ``flash_attention_tpu/serving/prefix.py`` (numpy
and hashlib only, the same digests, lookups and eviction order).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


class PrefixCache:
    def __init__(self, rt, page_size: int):
        self.rt = rt
        self.ps = page_size
        # digest -> page id; order = LRU (move_to_end on every touch)
        self.by_digest: OrderedDict[bytes, int] = OrderedDict()
        self.evictions = 0

    def _digests(self, prompt: list[int], salt: int = 0):
        """Chain digests of the prompt's FULL pages (partial tail excluded:
        a partially-filled page is written by later prefill/decode steps and
        must stay private to its sequence). ``salt`` keys the whole chain —
        multi-LoRA passes the adapter slot, because a page's KV depends on
        the adapter's wk/wv deltas: the same prompt under different
        adapters must NOT share pages."""
        h = salt.to_bytes(8, "little", signed=True)
        for i in range(len(prompt) // self.ps):
            m = hashlib.blake2b(h, digest_size=16)
            m.update(np.asarray(prompt[i * self.ps: (i + 1) * self.ps],
                                np.int64).tobytes())
            h = m.digest()
            yield h

    def lookup(self, prompt: list[int], max_tokens: int,
               salt: int = 0) -> list[int]:
        """Longest cached prefix as page ids, capped at ``max_tokens`` (the
        caller keeps at least one context token for the suffix dispatch —
        the last token's logits must be computed to sample from). Touches
        the LRU. Call immediately before ``seq_alloc_prefixed``: the pages
        are only guaranteed alive while their registry pins are."""
        max_pages = min(len(prompt), max_tokens) // self.ps
        pages = []
        for i, d in enumerate(self._digests(prompt, salt)):
            if i >= max_pages:
                break
            page = self.by_digest.get(d)
            if page is None:
                break  # chain walk: a miss ends every longer prefix too
            self.by_digest.move_to_end(d)
            pages.append(page)
        return pages

    def register(self, prompt: list[int], page_table: list[int],
                 salt: int = 0) -> None:
        """Pin + index the prompt's full pages after prefill wrote their KV.
        ``page_table`` holds the sequence's pages positionally. Digests
        already present keep their existing page (first writer wins — both
        hold identical KV, and re-pointing would strand the old pin)."""
        for i, d in enumerate(self._digests(prompt, salt)):
            if d in self.by_digest:
                self.by_digest.move_to_end(d)
                continue
            page = page_table[i]
            if page < 0 or self.rt.page_pin(page) != 0:
                continue
            self.by_digest[d] = page

    def evictable(self) -> int:
        """Pages eviction could actually free right now (registry is the
        only reference)."""
        return sum(1 for p in self.by_digest.values()
                   if self.rt.page_refcount(p) == 1)

    def evict(self, n_pages: int, keep: set[bytes] = frozenset()) -> int:
        """Unpin up to ``n_pages`` LRU entries whose pin is the LAST
        reference (those frees actually return memory; unpinning a page
        running sequences still share would only destroy future reuse).
        ``keep`` protects digests about to be adopted. Returns pages freed.
        """
        freed = 0
        for d in list(self.by_digest):
            if freed >= n_pages:
                break
            if d in keep:
                continue
            p = self.by_digest[d]
            if self.rt.page_refcount(p) != 1:
                continue
            del self.by_digest[d]
            self.rt.page_unpin(p)
            self.evictions += 1
            freed += 1
        return freed

    def keep_set(self, prompt: list[int], max_tokens: int,
                 salt: int = 0) -> set[bytes]:
        """Digests an imminent adoption of ``prompt`` would use (excluded
        from eviction between the admission check and the allocation)."""
        out, n = set(), min(len(prompt), max_tokens) // self.ps
        for i, d in enumerate(self._digests(prompt, salt)):
            if i >= n or d not in self.by_digest:
                break
            out.add(d)
        return out
