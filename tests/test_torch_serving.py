"""The port's serving stack against the JAX package's, on the CPU.

The engine must emit the JAX engine's greedy tokens exactly, on the prompts
of ``tests/test_serving.py`` (including more requests than ``max_batch``),
with the same fp32 weights (``params_from_jax``). Also: the allocator and
scheduler copies, and sampling (greedy and ``_mask_row`` equal JAX's; the
random bits replay from (seed, position)).
"""

import inspect
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.serving import sampling as jsampling
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.serving import sampling
from flash_attention_tpu_torch.serving.native import PagedRuntime
from flash_attention_tpu_torch.serving.scheduler import Request, Scheduler

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    pj = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny(),
                        dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return pj, pt


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 255, size=n))) for n in sizes]


# (seed, prompt sizes, new tokens, engine kwargs): tests/test_serving.py's
# test_engine_matches_dense_greedy and test_engine_more_requests_than_batch
CASES = {
    "three_prompts": (0, (5, 23, 17), 6,
                      dict(total_pages=96, page_size=16, max_batch=4,
                           max_seq_len=256)),
    "more_than_batch": (1, (9, 30, 14, 21, 7), 4,
                        dict(total_pages=48, page_size=16, max_batch=2,
                             max_seq_len=128)),
}


@pytest.fixture(scope="module")
def jax_outputs(params):
    """The JAX engine's greedy tokens per case, computed once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            seed, sizes, n_new, kw = CASES[case]
            eng = JaxEngine(jl.LlamaConfig.tiny(), params[0],
                            kv_dtype=jnp.float32, **kw)
            reqs = [eng.add_request(p, max_new_tokens=n_new)
                    for p in _prompts(seed, sizes)]
            eng.run()
            cache[case] = [r.output for r in reqs]
        return cache[case]
    return get


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine(params, jax_outputs, case, native):
    _, pt = params
    seed, sizes, n_new, kw = CASES[case]
    prompts = _prompts(seed, sizes)
    eng = Engine(tl.LlamaConfig.tiny(), pt, native_allocator=native, **kw)
    assert eng.rt.is_native == native
    reqs = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    done = eng.run()
    assert len(done) == len(prompts)
    for r, want in zip(reqs, jax_outputs(case)):
        assert r.error is None
        assert r.output == want, (r.output, want)
    st = eng.throughput()
    assert st["prefill_dispatches"] >= 1 and st["decode_steps"] >= n_new - 1


def test_engine_run_calls_on_step_after_every_step(params, jax_outputs):
    """``run(on_step=f)`` calls f(engine) once after each step, the last
    time when no work is left, and serves the same tokens as ``run()``."""
    _, pt = params
    seed, sizes, n_new, kw = CASES["three_prompts"]
    eng = Engine(tl.LlamaConfig.tiny(), pt, **kw)
    reqs = [eng.add_request(p, max_new_tokens=n_new)
            for p in _prompts(seed, sizes)]
    seen = []
    eng.run(on_step=lambda e: seen.append(
        (e.sched.has_work, sum(len(r.output) for r in reqs))))
    assert [w for w, _ in seen] == [True] * (len(seen) - 1) + [False]
    assert [n for _, n in seen] == sorted(n for _, n in seen)
    assert seen[-1][1] == n_new * len(sizes)
    assert [r.output for r in reqs] == jax_outputs("three_prompts")


def test_engine_stream_and_unsupported_options(params):
    _, pt = params
    eng = Engine(tl.LlamaConfig.tiny(), pt, total_pages=32, page_size=16,
                 max_batch=2, max_seq_len=64)
    r = eng.add_request([1, 2, 3], max_new_tokens=3)
    events = list(eng.stream())
    assert events[-1][2] and sum(len(t) for _, t, _ in events) == 3
    assert r.output == [t for _, ts, _ in events for t in ts]
    with pytest.raises(ValueError):
        eng.add_request([1] * 60, max_new_tokens=10)
    for kw in (dict(prefix_cache=True), dict(decode_block=4),
               dict(lora_rank=4)):
        with pytest.raises(NotImplementedError):
            Engine(tl.LlamaConfig.tiny(), pt, **kw)
    # a quantized cache (ported) streams the same way
    q8 = Engine(tl.LlamaConfig.tiny(), pt, total_pages=8, page_size=128,
                max_batch=2, max_seq_len=256, kv_quant=True)
    r = q8.add_request([1, 2, 3], max_new_tokens=3)
    events = list(q8.stream())
    assert events[-1][2] and sum(len(t) for _, t, _ in events) == 3
    assert r.error is None and q8.k_pages.dtype == torch.int8


# A non-default value of each of the JAX engine's options that the port has
# not ported yet (the params are fp32, so fp16 is neither the default nor
# the weights' dtype, nor an 8-bit type with kv_quant).
UNPORTED_ENGINE_OPTIONS = {
    "kv_dtype": torch.float16, "mesh": object(),
    "tp_axis": "tp", "draft_cfg": jl.LlamaConfig.tiny(),
    "draft_params": {}, "n_draft": 2, "prefix_cache": True,
    "decode_block": 4, "lora_rank": 4, "lora_targets": ("wq",),
    "max_loras": 2}


@pytest.mark.parametrize("option", ["signature", "kv_quant",
                                    *UNPORTED_ENGINE_OPTIONS])
def test_engine_takes_jax_keywords(params, option):
    """Engine takes every keyword of the JAX engine, in its order; an
    unported option at a non-default value raises NotImplementedError
    naming it. ``kv_quant`` (ported) builds the int8 cache with unit
    scales, and raises ValueError naming it at a page size other than
    128, as the JAX engine does."""
    _, pt = params
    if option == "kv_quant":
        eng = Engine(tl.LlamaConfig.tiny(), pt, total_pages=8, page_size=128,
                     max_batch=1, max_seq_len=256, kv_quant=True)
        assert eng.k_pages.dtype == eng.v_pages.dtype == torch.int8
        assert eng.k_scales.shape == (2, 2, 8, 8, 128)
        assert bool((eng.k_scales == 1).all() and (eng.v_scales == 1).all())
        with pytest.raises(ValueError, match="kv_quant"):
            Engine(tl.LlamaConfig.tiny(), pt, kv_quant=True)
        return
    if option == "signature":
        assert list(inspect.signature(Engine.__init__).parameters) == list(
            inspect.signature(JaxEngine.__init__).parameters)
        Engine(tl.LlamaConfig.tiny(), pt, total_pages=8, page_size=16,
               max_batch=1, max_seq_len=32, kv_dtype=torch.float32,
               tp_axis="model", n_draft=4, max_loras=8)
        return
    with pytest.raises(NotImplementedError, match=re.escape(option)):
        Engine(tl.LlamaConfig.tiny(), pt,
               **{option: UNPORTED_ENGINE_OPTIONS[option]})


def test_engine_sampling_replays(params):
    """Non-greedy requests: the same (seed, position) keys give the same
    completion in a second engine."""
    _, pt = params

    def gen():
        eng = Engine(tl.LlamaConfig.tiny(), pt, total_pages=32, page_size=16,
                     max_batch=2, max_seq_len=64)
        a = eng.add_request([5, 6, 7], 6, temperature=0.8, top_k=20, seed=3)
        b = eng.add_request([9, 9], 6, temperature=1.0, top_p=0.9, seed=4,
                            logprobs=True)
        eng.run()
        return a.output, b.output, b.token_logprobs

    first, second = gen(), gen()
    assert first == second
    assert len(first[2]) == 6 and all(lp <= 0.0 for lp in first[2])


@pytest.mark.parametrize("native", [False, True])
def test_allocator(native):
    rt = PagedRuntime(16, 4, 4, native=native)
    a = rt.seq_alloc(10)
    assert rt.seq_num_pages(a) == 3 and rt.free_pages() == 13
    for _ in range(3):
        assert rt.seq_append(a) == 0
    assert rt.seq_num_pages(a) == 4 and rt.seq_length(a) == 13
    table = rt.seq_page_table(a, 6, pad=-1)
    assert table[4:] == [-1, -1] and len(set(table[:4])) == 4
    rt.seq_free(a)
    assert rt.free_pages() == 16


def test_scheduler_preemption():
    rt = PagedRuntime(total_pages=8, page_size=4, max_seqs=4, native=False)
    s = Scheduler(rt, max_batch=4)
    r1 = Request(1, [0] * 16, 4)   # 4 pages
    r2 = Request(2, [0] * 12, 4)   # 3 pages
    s.add(r1)
    s.add(r2)
    assert [r.uid for r in s.admit()] == [1, 2]
    for _ in range(5):
        ok = s.grow(r1)
    assert ok and r2 in s.waiting and r2 not in s.running


def test_greedy_and_logprobs_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 300), dtype=np.float32)
    logits[2, [10, 20]] = 9.0  # a tie: both take the first index
    b = 4
    jt = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.zeros(b), jnp.zeros(b, jnp.int32),
        jnp.ones(b), jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.int32),
        need_filters=False)
    tt = sampling.sample_tokens(torch.from_numpy(logits), [0.0] * b, [0] * b,
                                [1.0] * b, [0] * b, [0] * b,
                                need_filters=False)
    assert tt.tolist() == np.asarray(jt).tolist() and tt[2] == 10
    np.testing.assert_allclose(
        sampling.token_logprobs(torch.from_numpy(logits), tt).numpy(),
        np.asarray(jsampling.token_logprobs(jnp.asarray(logits), jt)),
        atol=1e-5)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.5), (5, 1.0), (3, 0.9),
                                         (0, 0.999), (1, 0.1)])
def test_mask_row_matches_jax(top_k, top_p):
    row = np.random.default_rng(top_k).standard_normal(64).astype(np.float32)
    want = np.asarray(jsampling._mask_row(jnp.asarray(row), top_k, top_p))
    got = sampling._mask_row(torch.from_numpy(row), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sampling_replay_property():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 1000), dtype=np.float32))

    def draw(seed, pos):
        return int(sampling.sample_tokens(logits, [1.0], [0], [1.0], [seed],
                                          [pos], need_filters=False)[0])

    assert draw(3, 17) == draw(3, 17)
    assert len({draw(3, p) for p in range(20)}) > 1  # positions differ
    assert len({draw(s, 5) for s in range(20)}) > 1  # seeds differ
