"""Multi-step decode (``Engine(decode_block=k)``) in the port, on the CPU.

The JAX package's contract (``tests/test_multistep.py``): the emitted
tokens are the single-step engine's, bit for bit, for every sampling mode
and stop condition; a block only changes how many tokens arrive per host
round trip. Each of JAX's tests is held here within the port (the port's
random bits differ from JAX's, so sampled tokens are compared with the
port's single-step engine), and one greedy run against the JAX package's
multi-step engine (``LlamaConfig.tiny``, fp32, its Pallas kernels in
interpret mode): the same tokens.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl

torch.set_num_threads(2)

CFG = tl.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params():
    pj = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny(),
                        dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return pj, pt


def _run(params, prompts, max_new, *, decode_block=1, engine_kw=None,
         req_kw=None):
    kw = dict(total_pages=96, page_size=16, max_batch=4, max_seq_len=256)
    kw.update(engine_kw or {})
    eng = Engine(CFG, params[1], decode_block=decode_block, **kw)
    reqs = [eng.add_request(p, max_new_tokens=max_new, **(rk or {}))
            for p, rk in zip(prompts, req_kw or [{}] * len(prompts))]
    done = eng.run(max_steps=500)
    assert len(done) == len(reqs)
    for r in reqs:
        assert r.error is None, r.error
    return reqs, eng


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 255, size=n))) for n in sizes]


def test_multistep_greedy_bitwise(params):
    prompts = _prompts(0, (5, 23, 17))
    base, _ = _run(params, prompts, 7)
    for k in (2, 4):
        multi, eng = _run(params, prompts, 7, decode_block=k)
        assert [a.output for a in base] == [b.output for b in multi], k
        assert eng.rt.free_pages() == eng.rt.total_pages - 1


def test_multistep_greedy_matches_jax(params):
    """The JAX package's multi-step engine, greedy, fp32: the same tokens
    (and the same decode dispatches) as the port's."""
    prompts = _prompts(0, (5, 23, 17))
    ej = JaxEngine(jl.LlamaConfig.tiny(), params[0], total_pages=96,
                   page_size=16, max_batch=4, max_seq_len=256,
                   kv_dtype=jnp.float32, decode_block=4)
    rj = [ej.add_request(p, max_new_tokens=7) for p in prompts]
    ej.run()
    multi, eng = _run(params, prompts, 7, decode_block=4)
    assert [r.output for r in multi] == [r.output for r in rj]
    assert eng.stats["decode_steps"] == ej.stats["decode_steps"]


def test_multistep_sampled_bitwise(params):
    """Temperature, top-k, top-p and seeds: the (seed, position) keys make
    multi-step draws the single-step engine's."""
    prompts = _prompts(1, (9, 14))
    req_kw = [dict(temperature=0.8, top_k=50, seed=7),
              dict(temperature=1.1, top_p=0.9, seed=3)]
    base, _ = _run(params, prompts, 9, req_kw=req_kw)
    multi, _ = _run(params, prompts, 9, decode_block=4, req_kw=req_kw)
    assert [a.output for a in base] == [b.output for b in multi]


def test_multistep_stop_mid_block(params):
    """A stop token at step j < k drops the block's tail: exactly the
    single-step truncation."""
    (probe,), _ = _run(params, [[1, 2, 3]], 8)
    stop = probe.output[3]
    kw = [dict(stop_ids={stop, 99999})]
    (base,), _ = _run(params, [[1, 2, 3]], 8, req_kw=kw)
    (multi,), eng = _run(params, [[1, 2, 3]], 8, decode_block=4, req_kw=kw)
    cut = probe.output[: probe.output.index(stop) + 1]
    assert multi.output == base.output == cut
    assert eng.rt.free_pages() == eng.rt.total_pages - 1


def test_multistep_max_new_not_multiple_of_block(params):
    prompt = _prompts(2, (11,))
    (base,), _ = _run(params, prompt, 5)
    (multi,), _ = _run(params, prompt, 5, decode_block=4)
    assert multi.output == base.output and len(multi.output) == 5


def test_multistep_kv_quant(params):
    prompt = _prompts(3, (19,))
    ekw = dict(total_pages=16, page_size=128, max_batch=2, kv_quant=True)
    (base,), _ = _run(params, prompt, 6, engine_kw=ekw)
    (multi,), eng = _run(params, prompt, 6, decode_block=3, engine_kw=ekw)
    assert eng.k_pages.dtype == torch.int8
    assert multi.output == base.output


def test_multistep_logprobs(params):
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6]]
    kw = [dict(logprobs=True)]
    (base,), _ = _run(params, prompt, 5, req_kw=kw)
    (multi,), _ = _run(params, prompt, 5, decode_block=2, req_kw=kw)
    assert multi.output == base.output
    assert len(multi.token_logprobs) == 5
    np.testing.assert_allclose(multi.token_logprobs, base.token_logprobs,
                               atol=1e-5)


def test_multistep_survives_preemption(params):
    """A pool too small for both sequences preempts mid-generation; the
    truncated reservation and the kept output's recompute still give the
    uninterrupted completions."""
    p1, p2 = _prompts(4, (30, 30))
    kw = [dict(temperature=0.9, top_k=64, seed=11), {}]
    roomy = dict(total_pages=32, max_batch=2, max_seq_len=96)
    (alone,), _ = _run(params, [p1], 40, req_kw=kw[:1], engine_kw=roomy)
    contended, eng = _run(params, [p1, p2], 40, decode_block=4, req_kw=kw,
                          engine_kw=dict(total_pages=10, max_batch=2,
                                         max_seq_len=96))
    assert contended[0].output == alone.output
    (base2,), _ = _run(params, [p2], 40, engine_kw=roomy)
    assert contended[1].output == base2.output
    assert eng.rt.free_pages() == eng.rt.total_pages - 1


@pytest.mark.parametrize("package", ["jax", "port"])
def test_multistep_rejects_spec_combination(params, package):
    """decode_block with a draft model, and decode_block < 1, raise JAX's
    ValueErrors in both packages."""
    p = params[0] if package == "jax" else params[1]
    make, cfg = ((JaxEngine, jl.LlamaConfig.tiny()) if package == "jax"
                 else (Engine, CFG))
    kw = dict(total_pages=32, page_size=16, max_batch=2, max_seq_len=128)
    if package == "jax":
        kw["kv_dtype"] = jnp.float32
    with pytest.raises(ValueError, match="decode_block"):
        make(cfg, p, decode_block=2, draft_cfg=cfg, draft_params=p, **kw)
    with pytest.raises(ValueError, match="decode_block must be >= 1"):
        make(cfg, p, decode_block=0, **kw)


def test_multistep_fewer_dispatches(params):
    """k tokens a decode dispatch, and one readback a block."""
    prompt = _prompts(6, (7,))
    reads = []
    orig = torch.Tensor.tolist

    def counted(t):
        reads.append(t.shape)
        return orig(t)
    torch.Tensor.tolist = counted
    try:
        (req,), eng = _run(params, prompt, 9, decode_block=4)
    finally:
        torch.Tensor.tolist = orig
    # prefill emits token 1; decode emits the other 8 in ceil(8/4) = 2
    # dispatches instead of 8, each read back once
    assert eng.stats["decode_steps"] == 2
    assert eng.stats["decode_tokens"] == 8
    assert reads == [(1,), (1, 4), (1, 4)]
