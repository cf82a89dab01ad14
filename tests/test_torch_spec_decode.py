"""Speculative decoding in the port, against the JAX package's on the CPU.

``llama.write_chunk_to_pages`` (the token-granular commit of a verification
chunk: one kv-write launch per chunk position on the card, the plain write
here) must write JAX's bits; ``sampling.spec_accept`` keeps the greedy
prefix and, sampled, emits the target's distribution whatever the draft's;
and ``Engine(draft_cfg=, draft_params=, n_draft=)`` emits, greedy, the
tokens of the engine without a draft and of the JAX package's speculative
engine. The draft is the target cut to its first layer, its parameters
views of the target's, built the same way in both packages. fp32 on both
sides (the JAX side's Pallas kernels in interpret mode).

The port's random bits differ from JAX's (``serving/sampling.py``): the
sampled checks hold the port to itself (replay after preemption, draft ==
target accepting every proposal, the frequency test), and only greedy
tokens are compared across the packages.
"""

import dataclasses

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

torch.set_num_threads(2)

CFG_J, CFG_T = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
DRAFT_LAYERS = 1
ENGINE_KW = dict(total_pages=96, page_size=16, max_batch=4, max_seq_len=256)
PROMPT_SIZES = (5, 23)
NEW = 9


def _draft(params, cfg, n_layers=DRAFT_LAYERS):
    """The target's first ``n_layers`` layers, embedding, final norm and
    lm_head: (config, parameters as views of the target's)."""
    L = cfg.n_layers
    cut = {k: (v[:n_layers] if k not in ("embed", "lm_head", "norm_out")
               and v.shape[0] == L else v) for k, v in params.items()}
    return dataclasses.replace(cfg, n_layers=n_layers), cut


def _prompts(seed=0, sizes=PROMPT_SIZES):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, 255, size=n))) for n in sizes]


@pytest.fixture(scope="module")
def params():
    pj = jl.init_params(jax.random.PRNGKey(0), CFG_J, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return pj, pt


def _port(pt, prompts, n_new=NEW, spec=True, req_kw=None, **kw):
    eng_kw = dict(ENGINE_KW)
    if spec:
        dcfg, dp = _draft(pt, CFG_T)
        eng_kw.update(draft_cfg=dcfg, draft_params=dp, n_draft=3)
    eng_kw.update(kw)
    eng = Engine(CFG_T, pt, **eng_kw)
    reqs = [eng.add_request(p, max_new_tokens=n_new, **(req_kw or {}))
            for p in prompts]
    eng.run()
    for r in reqs:
        assert r.error is None, r.error
    return [r.output for r in reqs], eng


@pytest.fixture(scope="module")
def jax_spec_outputs(params):
    """The JAX package's speculative engine, greedy, on the same prompts
    with the same cut draft (one run for the module)."""
    pj, _ = params
    dcfg, dp = _draft(pj, CFG_J)
    eng = JaxEngine(CFG_J, pj, kv_dtype=jnp.float32, draft_cfg=dcfg,
                    draft_params=dp, n_draft=3, **ENGINE_KW)
    reqs = [eng.add_request(p, max_new_tokens=NEW) for p in _prompts()]
    eng.run()
    assert all(r.error is None for r in reqs)
    return [r.output for r in reqs], eng.stats


# ------------------------------------------------------------ chunk commit
@pytest.mark.parametrize("quant", [False, True])
def test_write_chunk_to_pages_matches_jax(quant):
    """bf16 pages, or int8 pages with their scale tiles from fp32 rows: the
    port writes JAX's bits (the scales to 1e-6 relative). Rows start
    mid-page, cross a page, and the last spills past its 3-page table
    (clipped to its last page, as in JAX)."""
    rng = np.random.default_rng(3)
    L, b, c, hk, hd = 2, 4, 5, 2, 64
    ps, P, npp = (128 if quant else 8), 14, 3
    ks, vs = (rng.standard_normal((L, b, c, hk, hd), dtype=np.float32)
              for _ in range(2))
    done = np.array([1, ps - 2, 5, 3 * ps - 2], np.int32)
    clen = np.full((b,), c, np.int32)
    tables = (rng.permutation(P - 1)[: b * npp].reshape(b, npp) + 1).astype(
        np.int32)
    if quant:
        kp = np.zeros((L, hk, P, ps, hd), np.int8)
        sc = np.ones((L, hk, P, 8, 128), np.float32)
        jargs = (jnp.asarray(sc), jnp.asarray(sc))
        targs = (torch.from_numpy(sc.copy()), torch.from_numpy(sc.copy()))
        jkv = tuple(map(jnp.asarray, (ks, vs)))
        tkv = tuple(map(torch.from_numpy, (ks, vs)))
        jp, tp = jnp.asarray(kp), torch.from_numpy(kp)
    else:
        kp = rng.standard_normal((L, hk, P, ps, hd), dtype=np.float32)
        jargs, targs = (None, None), (None, None)
        jkv = tuple(jnp.asarray(x, jnp.bfloat16) for x in (ks, vs))
        tkv = tuple(torch.from_numpy(x).bfloat16() for x in (ks, vs))
        jp = jnp.asarray(kp, jnp.bfloat16)
        tp = torch.from_numpy(kp).bfloat16()
    want = jl.write_chunk_to_pages(jp, jp.copy(), jkv, jnp.asarray(done),
                                   jnp.asarray(clen), jnp.asarray(tables),
                                   *jargs)
    got = tl.write_chunk_to_pages(tp.clone(), tp.clone(), tkv,
                                  torch.from_numpy(done),
                                  torch.from_numpy(clen),
                                  torch.from_numpy(tables), *targs)
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"),
                          got, want):
        if g is None:
            assert w is None
            continue
        if "scales" in name:
            # XLA's fusion rounds amax / 127 an ulp apart from the eager
            # division (JAX's own test allows the same for its oracle)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       err_msg=name)
            continue
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        w = np.asarray(w).view(np.int16) if g.dtype == torch.int16 \
            else np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ------------------------------------------------------------- accept rule
def test_spec_accept_greedy_prefix():
    """Greedy: exactly the proposals matching the target's argmax chain are
    kept and the first mismatch becomes the target's argmax, as JAX's."""
    v, g = 16, 3
    rng = np.random.default_rng(0)
    tl_ = rng.standard_normal((1, g + 1, v)).astype(np.float32)
    chain = np.argmax(tl_[0], -1)
    for n_match in range(g + 1):
        d = chain[:g].copy()
        if n_match < g:
            d[n_match] = (d[n_match] + 1) % v
        dl = rng.standard_normal((1, g, v)).astype(np.float32)
        out, n_emit = sampling.spec_accept(
            torch.from_numpy(tl_), torch.from_numpy(dl),
            torch.from_numpy(d[None]), [0.0], [5], [2])
        out_j, n_j = jsampling.spec_accept(
            jnp.asarray(tl_), jnp.asarray(dl), jnp.asarray(d[None]),
            jnp.zeros((1,)), jnp.asarray([5], jnp.int32),
            jnp.asarray([2], jnp.int32))
        assert int(n_emit[0]) == int(n_j[0]) == n_match + 1
        np.testing.assert_array_equal(out[0, : n_match + 1].numpy(),
                                      chain[: n_match + 1])
        np.testing.assert_array_equal(out[0, : n_match + 1].numpy(),
                                      np.asarray(out_j[0, : n_match + 1]))


def test_spec_accept_distribution_exact():
    """The first emitted token's frequencies over 4000 seeds match the
    target's softmax whatever the draft's (total variation < 0.04, JAX's
    gate), the proposals drawn by ``draft_sample`` as in serving."""
    v, g, n = 8, 2, 4000
    rng = np.random.default_rng(1)
    tlog = torch.from_numpy(np.broadcast_to(
        rng.standard_normal((1, g + 1, v)), (n, g + 1, v)).astype(np.float32))
    dlog = torch.from_numpy(np.broadcast_to(
        rng.standard_normal((1, g, v)), (n, g, v)).astype(np.float32))
    temps, seeds = [1.0] * n, list(range(n))
    d = torch.stack([sampling.draft_sample(dlog[:, j], temps, seeds,
                                           [3 + j] * n) for j in range(g)], 1)
    out, n_emit = sampling.spec_accept(tlog, dlog, d, temps, seeds, [3] * n)
    got = np.bincount(out[:, 0].numpy(), minlength=v) / n
    want = torch.softmax(tlog[0, 0], -1).numpy()
    tv = 0.5 * np.abs(got - want).sum()
    assert tv < 0.04, (tv, got, want)
    # the proposals themselves follow the draft's distribution
    got_d = np.bincount(d[:, 0].numpy(), minlength=v) / n
    assert 0.5 * np.abs(got_d - torch.softmax(dlog[0, 0], -1).numpy()).sum() \
        < 0.04
    assert int(n_emit.min()) >= 1 and int(n_emit.max()) <= g + 1


# ------------------------------------------------------------------ engine
def test_spec_engine_greedy_matches_plain_and_jax(params, jax_spec_outputs):
    """Greedy speculative tokens equal the engine's without a draft and the
    JAX speculative engine's; every page comes back."""
    _, pt = params
    prompts = _prompts()
    spec, eng = _port(pt, prompts)
    plain, _ = _port(pt, prompts, spec=False)
    want, stats_j = jax_spec_outputs
    assert spec == plain == want
    s = eng.stats
    assert s["spec_steps"] > 0 and 0 <= s["spec_accepted"] <= \
        s["spec_proposed"]
    assert s["spec_proposed"] == stats_j["spec_proposed"]
    assert s["spec_accepted"] == stats_j["spec_accepted"]
    assert eng.rt.free_pages() == eng.rt.total_pages - 1


def test_spec_engine_draft_equals_target_accepts_all(params):
    """With the target as its own draft every proposal is accepted: a
    request of 1 + 2 (g + 1) tokens takes exactly two spec steps, sampled
    at temperature 0.7, and an identical engine replays it."""
    _, pt = params
    g = 3
    outs = []
    for _ in range(2):
        out, eng = _port(pt, [[5, 9, 2]], n_new=1 + 2 * (g + 1), spec=False,
                         draft_cfg=CFG_T, draft_params=pt, n_draft=g,
                         max_batch=2, req_kw=dict(temperature=0.7, seed=13))
        assert eng.stats["spec_steps"] == 2
        assert eng.stats["spec_accepted"] == 2 * g
        outs.append(out)
    assert outs[0] == outs[1] and len(outs[0][0]) == 1 + 2 * (g + 1)


def test_spec_engine_survives_preemption(params):
    """A pool too small for the three sequences preempts and re-admits;
    the sampled completions equal an unpressured run's (the spec draws are
    keyed by output position, and a re-admitted request resumes at its
    kept frontier)."""
    _, pt = params
    prompts = _prompts(2, (40, 37, 45))

    def run(total_pages):
        dcfg, dp = _draft(pt, CFG_T)
        eng = Engine(CFG_T, pt, total_pages=total_pages, page_size=16,
                     max_batch=4, max_seq_len=192, draft_cfg=dcfg,
                     draft_params=dp, n_draft=2)
        reqs = [eng.add_request(p, max_new_tokens=12, temperature=0.9,
                                seed=100 + i) for i, p in enumerate(prompts)]
        eng.run()
        assert all(r.error is None for r in reqs)
        return [r.output for r in reqs], eng
    ample, _ = run(64)
    tight, eng = run(16)
    assert tight == ample
    assert eng.rt.free_pages() == eng.rt.total_pages - 1


def test_spec_engine_eos_mid_acceptance(params):
    """An eos inside an accepted run ends the output at the eos token."""
    _, pt = params
    g = 4
    kw = dict(spec=False, draft_cfg=CFG_T, draft_params=pt, n_draft=g,
              max_batch=2)
    (probe,), _ = _port(pt, [[1, 2, 3]], n_new=g + 1, **kw)
    eos = probe[2]
    (out,), eng = _port(pt, [[1, 2, 3]], n_new=20, req_kw=dict(eos_id=eos),
                        **kw)
    assert out == probe[: probe.index(eos) + 1]
    assert eng.rt.free_pages() == eng.rt.total_pages - 1


def test_spec_engine_quantized_kv(params):
    """Over the int8 cache (the draft's pools int8 too) speculation runs end
    to end, and its greedy tokens equal the int8 engine's without a draft."""
    _, pt = params
    prompts = [list(range(10, 40))]
    kw = dict(total_pages=16, page_size=128, max_seq_len=512, kv_quant=True)
    spec, eng = _port(pt, prompts, n_new=6, **kw)
    plain, _ = _port(pt, prompts, n_new=6, spec=False, **kw)
    assert eng.k_pages_d.dtype == torch.int8 and eng.k_scales_d is not None
    assert spec == plain


# each JAX ValueError of speculative decoding, with its condition
BAD = {
    "filters": (dict(), dict(top_k=5), "top-k/top-p"),
    "together": (dict(draft_params=None), None, "come together"),
    "n_draft": (dict(n_draft=0), None, "n_draft"),
    "chunk_size": (dict(chunk_size=64), None, "chunked prefill"),
    "window": (dict(window=True), None, "sliding-window"),
    "vocab": (dict(vocab=128), None, "vocab"),
    "decode_block": (dict(decode_block=2), None, "decode_block"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_spec_engine_value_errors_as_jax(params, case):
    """Each raises the same ValueError in both packages."""
    pj, pt = params
    eng_kw, req_kw, match = BAD[case]
    for pkg, cfg, p in (("jax", CFG_J, pj), ("port", CFG_T, pt)):
        kw = dict(eng_kw)
        if kw.pop("window", False):
            cfg = dataclasses.replace(cfg, sliding_window=32)
        dcfg, dp = _draft(p, cfg)
        if "vocab" in kw:
            dcfg = dataclasses.replace(dcfg, vocab_size=kw.pop("vocab"))
        kw = dict(dict(draft_cfg=dcfg, draft_params=dp, n_draft=2), **kw)
        if pkg == "jax":
            kw["kv_dtype"] = jnp.float32
        make = JaxEngine if pkg == "jax" else Engine
        with pytest.raises(ValueError, match=match):
            eng = make(cfg, p, total_pages=32, page_size=16, max_batch=2,
                       max_seq_len=128, **kw)
            eng.add_request([1, 2], 4, temperature=0.5, **(req_kw or {}))
