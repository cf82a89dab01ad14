"""Continuous-batching scheduler.

FCFS admission over the paged-KV page budget (the native allocator's
``can_admit``), iteration-level scheduling: every engine step decodes one
token for every running sequence; new requests are admitted (prefilled)
whenever slots + pages allow. If a decode step cannot allocate a page, the
most recently admitted sequence is preempted back to the waiting queue
(its pages freed; it will re-prefill when re-admitted).

The PyTorch port's own copy of the JAX package's scheduler (it imports
nothing of that package).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from flash_attention_tpu_torch.serving.native import PagedRuntime


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]            # prompt token ids
    max_new_tokens: int
    output: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1               # allocator slot while running
    eos_id: Optional[int] = None
    error: Optional[str] = None  # set when a device error failed this request
    # Sampling params. temperature 0.0 = greedy argmax. Sampling is keyed by
    # (seed, position) — stateless per token — so a preempted request that
    # re-prefills its kept output continues with the IDENTICAL completion it
    # would have produced uninterrupted.
    temperature: float = 0.0
    top_k: int = 0               # 0 = no top-k filter
    top_p: float = 1.0           # 1.0 = no nucleus filter
    seed: int = 0
    # Prefix caching: tokens of this admission's context whose KV pages were
    # ADOPTED from the cache (page-aligned); prefill skips them. Set by the
    # engine's alloc hook at every (re-)admission.
    cached_tokens: int = 0
    # Multi-LoRA: adapter stack slot (0 = base model).
    lora_id: int = 0
    # Per-token logprobs: when True, token_logprobs[i] is log p(output[i])
    # under the RAW model distribution (no temperature/filters).
    logprobs: bool = False
    token_logprobs: list = dataclasses.field(default_factory=list)

    # Additional stop tokens beyond eos_id (tuple: Requests stay hashable
    # and the set is usually tiny). Generation stops on ANY of them.
    stop_ids: tuple = ()

    @property
    def done(self) -> bool:
        if self.error is not None:
            return True
        if self.output and (self.output[-1] == self.eos_id
                            or self.output[-1] in self.stop_ids):
            return True
        return len(self.output) >= self.max_new_tokens

    @property
    def context_len(self) -> int:
        """Tokens that must live in the cache: prompt + generated so far."""
        return len(self.prompt) + len(self.output)


class Scheduler:
    def __init__(self, runtime: PagedRuntime, max_batch: int,
                 reserve_pages: int = 0, live_from_page_fn=None,
                 can_admit_fn=None, alloc_fn=None):
        self.rt = runtime
        self.max_batch = max_batch
        self.reserve_pages = reserve_pages
        # Sliding-window serving: maps a context length to the first page the
        # attention window can still read (engine supplies it from the model
        # config + kernel block granularity). Pages before it are allocated
        # as holes and never backed by memory. Default: everything is live.
        self.live_from_page = live_from_page_fn or (lambda tokens: 0)
        # Admission overrides (prefix caching): the engine supplies a check
        # that counts cached-page reuse/eviction headroom and an allocator
        # that adopts cached pages. Defaults: plain page-budget admission.
        self.can_admit_fn = can_admit_fn or (
            lambda req: self.rt.can_admit(
                req.context_len + 1, self.reserve_pages,
                self.live_from_page(req.context_len + 1)))
        self.alloc_fn = alloc_fn or (
            lambda req: self.rt.seq_alloc(
                req.context_len, self.live_from_page(req.context_len)))
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def admit(self) -> list[Request]:
        """Admit waiting requests while budget allows. Returns newly admitted
        requests (caller must prefill them).

        A re-admitted (previously preempted) request keeps its generated
        tokens: the budget and page allocation cover prompt+output, and the
        caller re-prefills the whole context (vLLM-style recompute) so the
        completion is preserved — not restarted — even under future
        non-greedy sampling."""
        admitted = []
        while (self.waiting and len(self.running) < self.max_batch and
               self.can_admit_fn(self.waiting[0])):
            req = self.waiting.popleft()
            slot = self.alloc_fn(req)
            if slot < 0:
                self.waiting.appendleft(req)
                break
            req.slot = slot
            self.running.append(req)
            admitted.append(req)
        return admitted

    def grow(self, req: Request) -> bool:
        """Reserve cache space for one more token of ``req``. On page
        exhaustion, preempts the newest other sequence(s) and retries; returns
        False if ``req`` itself had to be preempted."""
        while self.rt.seq_append(req.slot) != 0:
            victim = None
            for cand in reversed(self.running):
                if cand is not req:
                    victim = cand
                    break
            if victim is None:
                self.preempt(req)
                return False
            self.preempt(victim)
        return True

    def preempt(self, req: Request) -> None:
        """Free the victim's pages and park it; generated tokens are KEPT
        (see admit) so preemption never discards progress."""
        self.rt.seq_free(req.slot)
        req.slot = -1
        self.running.remove(req)
        self.waiting.appendleft(req)

    def finish(self, req: Request) -> None:
        self.rt.seq_free(req.slot)
        req.slot = -1
        self.running.remove(req)

    def fail(self, req: Request, error: str) -> None:
        """Surface a device error on ``req``: mark it failed, free its pages,
        and drop it from whichever queue holds it. The engine stays alive for
        the other requests."""
        req.error = error
        self.rt.seq_free(req.slot)
        req.slot = -1
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
