"""Prefix caching (``Engine(prefix_cache=True)``) in the port, on the CPU.

``serving.prefix.PrefixCache`` is the port's own copy of the JAX package's
registry: its chain digests, lookups, keep sets and evictions must be JAX's
on the same prompts and page tables. The engine adopts the cached pages of
a shared prompt prefix and prefills only the suffix (``prefill_chunk``
with a page-aligned ``done``); it must emit the uncached engine's greedy
tokens, share pages between running requests, evict under pressure,
re-admit a preempted request onto its own pinned pages, compose with
speculative decoding, and emit the JAX package's prefix-cached engine's
tokens with the same reused-token count (fp32, ``LlamaConfig.tiny``, the
JAX side's Pallas kernels in interpret mode).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu.serving.native import PagedRuntime as JaxRuntime
from flash_attention_tpu.serving.prefix import PrefixCache as JaxPrefixCache
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.serving import scheduler as tsched
from flash_attention_tpu_torch.serving.native import PagedRuntime
from flash_attention_tpu_torch.serving.prefix import PrefixCache

torch.set_num_threads(2)

CFG = tl.LlamaConfig.tiny()
ENGINE_KW = dict(total_pages=96, page_size=16, max_batch=4, max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    pj = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny(),
                        dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return pj, pt


def _mk_prompts(seed, shared_len, tails):
    rng = np.random.default_rng(seed)
    shared = list(map(int, rng.integers(0, 255, shared_len)))
    return [shared + list(map(int, rng.integers(0, 255, t))) for t in tails]


def _sequential(make, prompts, max_new):
    """Each prompt served alone, in turn, so later ones can hit."""
    eng, outs = make(), []
    for p in prompts:
        r = eng.add_request(p, max_new_tokens=max_new)
        eng.run()
        assert r.error is None, r.error
        outs.append(r.output)
    return outs, eng


# ---------------------------------------------------------------- registry
def test_registry_matches_jax():
    """The same allocations, registrations, lookups, keep sets and
    evictions on both registries give the same digests, pages and
    counts."""
    caches = []
    for runtime, cache in ((JaxRuntime, JaxPrefixCache),
                           (PagedRuntime, PrefixCache)):
        rt = runtime(16, 4, 4, native=False)
        caches.append((rt, cache(rt, page_size=4)))
    prompt = list(range(11))                    # 2 full pages + a tail
    other = [99] + prompt[1:]                   # page 0 differs
    half = prompt[:4] + [99] + prompt[5:]       # page 1 differs
    seen = []
    for rt, pc in caches:
        log = [list(pc._digests(prompt)), list(pc._digests(prompt, salt=3))]
        slot = rt.seq_alloc(len(prompt))
        table = rt.seq_page_table(slot, 3)
        pc.register(prompt, table)
        log += [pc.lookup(prompt, len(prompt) - 1), pc.lookup(prompt, 7),
                pc.lookup(other, 10), pc.lookup(half, 10),
                sorted(pc.keep_set(prompt, 10)), pc.keep_set(prompt, 3)]
        slot2 = rt.seq_alloc(len(prompt))
        pc.register(prompt, rt.seq_page_table(slot2, 3))  # first writer wins
        log += [list(pc.by_digest.items()), pc.evictable()]
        rt.seq_free(slot)
        rt.seq_free(slot2)
        log += [pc.evictable(), pc.evict(1, keep=pc.keep_set(prompt, 4)),
                pc.evict(5), pc.evictions, rt.free_pages()]
        seen.append(log)
    assert seen[0] == seen[1]
    # a full hit capped a token short, the cap binding, a first-page miss
    # ending the chain, a second-page miss
    assert [len(x) for x in seen[1][2:6]] == [2, 1, 0, 1]


# ------------------------------------------------------------------ engine
def test_prefix_engine_matches_uncached_and_jax(params):
    """Sequential requests sharing a 40-token prefix: the uncached port
    engine's tokens and the JAX prefix-cached engine's, two reused pages
    for each later request as in JAX, and a consistent pool (free + pinned
    == total - the trash page)."""
    pj, pt = params
    prompts = _mk_prompts(0, 40, (5, 9, 3))
    base, _ = _sequential(lambda: Engine(CFG, pt, **ENGINE_KW), prompts, 6)
    cached, eng = _sequential(
        lambda: Engine(CFG, pt, prefix_cache=True, **ENGINE_KW), prompts, 6)
    jax_out, ej = _sequential(
        lambda: JaxEngine(jl.LlamaConfig.tiny(), pj, kv_dtype=jnp.float32,
                          prefix_cache=True, **ENGINE_KW), prompts, 6)
    assert cached == base == jax_out
    assert eng.stats["prefix_reused_tokens"] == \
        ej.stats["prefix_reused_tokens"] == 2 * 2 * 16
    assert eng.stats["prefill_tokens"] == ej.stats["prefill_tokens"]
    pinned = len(eng.prefix.by_digest)
    assert all(eng.rt.page_refcount(p) == 1
               for p in eng.prefix.by_digest.values())
    assert eng.rt.free_pages() + pinned == eng.rt.total_pages - 1


def test_prefix_engine_concurrent_sharing(params):
    """A request admitted while the prefix's owner still runs adopts its
    pages (refcount >= 3: the owner, the registry, the adopter), and both
    emit the uncached engine's tokens."""
    _, pt = params
    p1, p2 = _mk_prompts(1, 48, (3, 7))
    eng = Engine(CFG, pt, prefix_cache=True, **ENGINE_KW)
    r1 = eng.add_request(p1, max_new_tokens=12)
    eng.step()                                  # prefill r1, register pages
    eng.step()
    r2 = eng.add_request(p2, max_new_tokens=6)
    eng.step()                                  # admit and prefill r2
    assert r2.cached_tokens == 48
    assert any(eng.rt.page_refcount(p) >= 3 for p in eng.prefix.lookup(p1, 48))
    eng.run()
    base = Engine(CFG, pt, **ENGINE_KW)
    b1, b2 = (base.add_request(p, max_new_tokens=n)
              for p, n in ((p1, 12), (p2, 6)))
    base.run()
    assert (r1.output, r2.output) == (b1.output, b2.output)


def test_prefix_eviction_under_pressure(params):
    """More distinct prompts than the pool can cache: admission evicts
    registry-only pages, every request completes with the uncached
    engine's tokens."""
    _, pt = params
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(0, 255, 40 + i)))
               for i in range(6)]
    kw = dict(total_pages=16, page_size=16, max_batch=2, max_seq_len=128)
    outs = []
    for prefix in (True, False):
        eng = Engine(CFG, pt, prefix_cache=prefix, **kw)
        reqs = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        eng.run()
        assert all(r.error is None for r in reqs)
        outs.append([r.output for r in reqs])
        if prefix:
            assert eng.prefix.evictions > 0
            pinned = len(eng.prefix.by_digest)
            assert eng.rt.free_pages() + pinned == eng.rt.total_pages - 1
    assert outs[0] == outs[1]


def test_prefix_preemption_readmission_reuses_own_pages(params, monkeypatch):
    """A request preempted by growth re-admits by adopting its own pinned
    prompt pages (both were admitted before any registration, so any reuse
    is the re-admission's) and completes as an unpressured run does."""
    _, pt = params
    preempts = []
    orig = tsched.Scheduler.preempt
    monkeypatch.setattr(tsched.Scheduler, "preempt",
                        lambda self, req: (preempts.append(req.uid),
                                           orig(self, req))[1])
    prompts = _mk_prompts(3, 32, (1, 5))

    def run(total_pages):
        eng = Engine(CFG, pt, total_pages=total_pages, page_size=16,
                     max_batch=4, max_seq_len=128, prefix_cache=True)
        reqs = [eng.add_request(p, max_new_tokens=60) for p in prompts]
        eng.run()
        assert all(r.error is None for r in reqs)
        return [r.output for r in reqs], eng

    ample, _ = run(64)
    preempts.clear()
    tight, eng = run(12)
    assert tight == ample
    assert preempts, "the tight pool was expected to force a preemption"
    assert eng.stats["prefix_reused_tokens"] >= 32


def test_prefix_with_speculative_decoding(params):
    """Prefix caching with a draft (the target's first layer): the adopted
    pages hold the draft's prefix K/V too, and the greedy tokens are the
    plain engine's."""
    _, pt = params
    dcfg = dataclasses.replace(CFG, n_layers=1)
    dp = {k: (v[:1] if k not in ("embed", "lm_head", "norm_out") else v)
          for k, v in pt.items()}
    prompts = _mk_prompts(4, 40, (4, 8))
    spec, eng = _sequential(
        lambda: Engine(CFG, pt, prefix_cache=True, draft_cfg=dcfg,
                       draft_params=dp, n_draft=2, **ENGINE_KW), prompts, 8)
    base, _ = _sequential(lambda: Engine(CFG, pt, **ENGINE_KW), prompts, 8)
    assert spec == base
    assert eng.stats["prefix_reused_tokens"] >= 2 * 16
    assert eng.stats["spec_steps"] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_size=16), "chunked prefill"),
    (dict(window=32), "sliding-window"),
])
def test_prefix_rejects_incompatible_modes(params, kw, match):
    """JAX's ValueErrors, in both packages: prefix caching with chunked
    prefill, and with window page reclamation."""
    pj, pt = params
    kw = dict(kw)
    window = kw.pop("window", None)
    for make, cfg, p, extra in (
            (JaxEngine, jl.LlamaConfig.tiny(), pj, dict(kv_dtype=jnp.float32)),
            (Engine, CFG, pt, {})):
        if window:
            cfg = dataclasses.replace(cfg, sliding_window=window)
        with pytest.raises(ValueError, match=match):
            make(cfg, p, total_pages=32, page_size=16, max_batch=2,
                 max_seq_len=128, prefix_cache=True, **kw, **extra)
