"""Chunked prefill in the port's model and engine, against the JAX package's,
on the CPU.

``llama.prefill_chunk`` takes a chunk of each row's prompt whose prefix
already lies in the paged cache, and attends to [prefix pages || chunk]
through the segmented flash forward (the plain version here, the segmented
kernel on the card); the engine with ``chunk_size`` prefills long prompts
chunk by chunk. Both are held to the JAX package's on the same inputs: JAX's
parameters cross over with ``params_from_jax``, inputs come from numpy seeds,
both sides run fp32 (the JAX side's Pallas kernels in interpret mode).
Logits and K/V must agree to max abs 1e-4 (as ``tests/test_torch_llama.py``);
the engines must emit the same greedy tokens and hold the same number of
free pages after every step (as ``test_engine_reclaims_window_pages_as_jax``
compares them), and a chunked engine the same tokens as an unchunked one.
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
from flash_attention_tpu_torch.ops import quant

torch.set_num_threads(2)

ATOL = 1e-4
PS = 16  # page size of the function-level caches
# the JAX package's chunked-prefill configs (tests/test_chunked_prefill.py)
FAMILIES = {
    "llama": ("tiny", {}),
    "gemma2": ("tiny_gemma2", dict(n_layers=2, sliding_window=64)),
}


def _configs(ctor, **kw):
    return getattr(jl.LlamaConfig, ctor)(**kw), \
        getattr(tl.LlamaConfig, ctor)(**kw)


def _port_params(pj):
    return tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()},
                              "cpu", torch.float32)


def _close(a, b, what, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    err = float(np.max(np.abs(a - np.asarray(b))))
    assert err <= atol, f"{what}: max abs {err:.3e} > {atol}"


def _cache(cfg, ks, vs, done, npp):
    """Rows' prefill K/V (L, b, s, hk, hd), tokens [0, done_i) of row i,
    scattered into a fresh page cache: (k_pages, v_pages, tables), numpy.
    Pages past a row's prefix keep zeros (``done`` masks them)."""
    ks, vs = np.asarray(ks), np.asarray(vs)
    L, b, s, hk, hd = ks.shape
    kp = np.zeros((L, hk, b * npp + 1, PS, hd), np.float32)
    vp = np.zeros_like(kp)
    tables = np.arange(b * npp, dtype=np.int32).reshape(b, npp)
    for i in range(b):
        for p in range(npp):
            lo = p * PS
            n = min(PS, max(0, int(done[i]) - lo), s - lo)
            if n > 0:
                kp[:, :, tables[i, p], :n] = ks[:, i, lo:lo + n].transpose(
                    0, 2, 1, 3)
                vp[:, :, tables[i, p], :n] = vs[:, i, lo:lo + n].transpose(
                    0, 2, 1, 3)
    return kp, vp, tables


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    ctor, kw = FAMILIES[request.param]
    cfg_j, cfg_t = _configs(ctor, **kw)
    pj = jl.init_params(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    return cfg_j, cfg_t, pj, _port_params(pj)


def _chunk_inputs(cfg_j, pj):
    """The JAX test's chunk: row 0 the full chunk [64, 96) of a 96-token
    prompt, row 1 ragged (prefix 48, 16 live tokens), row 2 a pad row
    (chunk_len 0, as the engine's power-of-two batch adds); the prefix
    table covers 64 tokens, so row 1's last page is stale."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (3, 96)).astype(np.int32)
    full, ks, vs = jl.prefill(pj, jnp.asarray(tokens), cfg_j)
    done = np.array([64, 48, 0], np.int32)
    clen = np.array([32, 16, 0], np.int32)
    kp, vp, tables = _cache(cfg_j, ks, vs, done, 4)
    chunk = np.stack([tokens[0, 64:96], tokens[1, 48:80],
                      np.zeros(32, np.int32)])
    return full, ks, (chunk, done, clen, kp, vp, tables)


def test_prefill_chunk_matches_jax(family):
    """Logits and chunk K/V equal JAX's prefill_chunk on the same cache, and
    the full prefill's at the chunk's columns; the pad row is finite."""
    cfg_j, cfg_t, pj, pt = family
    full, ks, (chunk, done, clen, kp, vp, tables) = _chunk_inputs(cfg_j, pj)
    lj, kj, vj = jl.prefill_chunk(
        pj, jnp.asarray(chunk), jnp.asarray(done), jnp.asarray(clen),
        jnp.asarray(kp), jnp.asarray(vp), None, None, jnp.asarray(tables),
        cfg_j)
    lt, kt, vt = tl.prefill_chunk(
        pt, torch.from_numpy(chunk), torch.from_numpy(done),
        torch.from_numpy(clen), torch.from_numpy(kp), torch.from_numpy(vp),
        None, None, torch.from_numpy(tables), cfg_t)
    assert lt.shape == (3, 32, cfg_t.vocab_size)
    assert kt.shape == (cfg_t.n_layers, 3, 32, cfg_t.n_kv_heads,
                        cfg_t.head_dim)
    # the pad row's logits are JAX's too, and every value finite
    assert torch.isfinite(lt).all() and torch.isfinite(kt).all()
    _close(lt, lj, "prefill_chunk logits")
    _close(kt, kj, "chunk k")
    _close(vt, vj, "chunk v")
    for i in range(2):
        n, d0 = int(clen[i]), int(done[i])
        _close(lt[i, :n], np.asarray(full)[i, d0:d0 + n],
               f"row {i} against the full prefill", atol=5e-4)
        _close(kt[:, i, :n], np.asarray(ks)[:, i, d0:d0 + n],
               f"row {i} K against the full prefill")


def test_prefill_chunk_logit_rows(family):
    """``logit_rows`` (the port's extension, as in ``prefill``) gives the
    full logits' row at each given chunk position."""
    cfg_j, cfg_t, pj, pt = family
    _, _, (chunk, done, clen, kp, vp, tables) = _chunk_inputs(cfg_j, pj)
    args = (pt, torch.from_numpy(chunk), torch.from_numpy(done),
            torch.from_numpy(clen), torch.from_numpy(kp),
            torch.from_numpy(vp), None, None, torch.from_numpy(tables),
            cfg_t)
    rows = torch.tensor([31, 15, 0])
    full, _, _ = tl.prefill_chunk(*args)
    got, _, _ = tl.prefill_chunk(*args, logit_rows=rows)
    assert got.shape == (3, cfg_t.vocab_size)
    _close(got, full[torch.arange(3), rows], "logit_rows", atol=1e-5)


@pytest.mark.parametrize("option", ["k_scales", "v_scales", "lora_ids"])
def test_prefill_chunk_unported_options_raise(option):
    """The options that once raised, each ported. LoRA: with stacks the
    chunk on an adapter's slot gives the logits of the chunk over the
    merged model, and stacks without ``lora_ids`` raise JAX's ValueError.
    The quantized cache's scales: either alone raises ValueError, and with
    both (an int8 cache for ``k_scales``, fp8 for ``v_scales``) the chunk
    over the 8-bit prefix gives the logits of the chunk over its pages
    dequantized into a float cache."""
    cfg = tl.LlamaConfig.tiny(n_layers=1)
    pt = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    pages = torch.from_numpy(rng.standard_normal(
        (1, cfg.n_kv_heads, 2, PS, cfg.head_dim), dtype=np.float32))
    args = (pt, torch.from_numpy(rng.integers(0, 256, (1, PS))),
            torch.tensor([PS]), torch.tensor([PS]))
    tables = torch.zeros((1, 1), dtype=torch.int64)
    if option == "lora_ids":
        from flash_attention_tpu_torch.models import lora
        ad = lora.init_adapter(torch.Generator().manual_seed(0), cfg, 4,
                               ("wq", "wv", "w_up"))
        for _, b in ad.values():
            b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        stacks = lora.stack_adapters(cfg, [ad], 4, ("wq", "wv", "w_up"), 2,
                                     device="cpu")
        with pytest.raises(ValueError, match="no lora_ids"):
            tl.prefill_chunk({**pt, "lora": stacks}, *args[1:], pages, pages,
                             None, None, tables, cfg)
        got, _, _ = tl.prefill_chunk({**pt, "lora": stacks}, *args[1:],
                                     pages, pages, None, None, tables, cfg,
                                     lora_ids=[1])
        want, _, _ = tl.prefill_chunk(lora.merge_adapter(pt, ad), *args[1:],
                                      pages, pages, None, None, tables, cfg)
        base, _, _ = tl.prefill_chunk(*args, pages, pages, None, None,
                                      tables, cfg)
        _close(got, want, "chunk on slot 1 vs the merged model", atol=1e-4)
        assert float((got - base).abs().max()) > 1e-2
        return
    dtype = torch.int8 if option == "k_scales" else torch.float8_e4m3fn
    q, sc = quant.quantize_kv_pages(pages[0], dtype)
    q, sc = q[None], sc[None]
    kw = dict(k_scales=None, v_scales=None)
    kw[option] = sc
    with pytest.raises(ValueError, match="together"):
        tl.prefill_chunk(*args, q, q, kw["k_scales"], kw["v_scales"], tables,
                         cfg)
    got, _, _ = tl.prefill_chunk(*args, q, q, sc, sc, tables, cfg)
    deq = q.float() * sc[:, :, :, 0, :PS, None]
    want, _, _ = tl.prefill_chunk(*args, deq, deq, None, None, tables, cfg)
    assert torch.isfinite(got).all()
    _close(got, want, f"chunk over the {dtype} prefix", atol=1e-5)


# The engines: uneven prompts over 1 to 3 chunks of 64 (tiny), and a window
# of 96 on every layer with prompts past it (the JAX test's windowed
# engine), where admission holes only the pages dead to the second chunk
# and each chunk releases the pages behind its window.
ENGINES = {
    "tiny": (dict(), (40, 90, 150), dict(total_pages=64, page_size=16,
                                         max_batch=4, max_seq_len=256)),
    "tiny-window": (dict(sliding_window=96), (300, 130),
                    dict(total_pages=64, page_size=16, max_batch=2,
                         max_seq_len=512)),
}
CHUNK, NEW = 64, 4


def _engine_prompts(sizes):
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(0, 255, n))) for n in sizes]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_chunked_matches_jax(name):
    """The port's chunked engine against JAX's: the same greedy tokens, and
    the same free pages after every step (admission, each chunked prefill
    and every decode step)."""
    cfg_kw, sizes, eng_kw = ENGINES[name]
    cfg_j, cfg_t = _configs("tiny", **cfg_kw)
    pj = jl.init_params(jax.random.PRNGKey(4), cfg_j, dtype=jnp.float32)
    prompts = _engine_prompts(sizes)
    ej = JaxEngine(cfg_j, pj, kv_dtype=jnp.float32, chunk_size=CHUNK,
                   **eng_kw)
    et = Engine(cfg_t, _port_params(pj), chunk_size=CHUNK, **eng_kw)
    rj = [ej.add_request(p, max_new_tokens=NEW) for p in prompts]
    rt = [et.add_request(p, max_new_tokens=NEW) for p in prompts]
    steps = 0
    while ej.sched.has_work or et.sched.has_work:
        ej.step()
        et.step()
        steps += 1
        assert ej.rt.free_pages() == et.rt.free_pages(), steps
    for a, b in zip(rt, rj):
        assert a.error is None, a.error
        assert a.output == b.output, (a.output, b.output)
    assert et.stats["prefill_chunks"] == ej.stats["prefill_chunks"] >= 3


def test_engine_chunked_matches_unchunked():
    """Chunked engine == unchunked engine on uneven prompts over 1, 2 and 3
    chunks (the JAX package's test_engine_chunked_matches_unchunked)."""
    cfg = tl.LlamaConfig.tiny()
    pj = jl.init_params(jax.random.PRNGKey(4), jl.LlamaConfig.tiny(),
                        dtype=jnp.float32)
    pt = _port_params(pj)
    prompts = _engine_prompts((40, 90, 150))
    outs = []
    for chunk in (None, CHUNK):
        eng = Engine(cfg, pt, chunk_size=chunk, **ENGINES["tiny"][2])
        reqs = [eng.add_request(p, max_new_tokens=NEW) for p in prompts]
        eng.run()
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert eng.stats["prefill_chunks"] == 3


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=16, chunk_size=40), "multiple of page_size"),
    (dict(chunk_size=64, prefix_cache=True), "prefix caching"),
    (dict(chunk_size=64, draft_cfg="tiny", draft_params="tiny"),
     "speculative decoding"),
])
def test_engine_chunk_size_errors_as_jax(kw, match):
    """The JAX engine's errors for chunk_size: not a multiple of the page
    size, or with prefix caching or a draft model."""
    cfg_j, cfg_t = _configs("tiny", n_layers=1)
    pj = jl.init_params(jax.random.PRNGKey(7), cfg_j, dtype=jnp.float32)
    pt = _port_params(pj)
    kw_j, kw_t = dict(kw), dict(kw)
    if "draft_cfg" in kw:
        kw_j.update(draft_cfg=cfg_j, draft_params=pj)
        kw_t.update(draft_cfg=cfg_t, draft_params=pt)
    with pytest.raises(ValueError, match=match):
        JaxEngine(cfg_j, pj, total_pages=16, **kw_j)
    with pytest.raises(ValueError, match=match):
        Engine(cfg_t, pt, total_pages=16, **kw_t)
