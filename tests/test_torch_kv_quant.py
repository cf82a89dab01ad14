"""The port's quantized KV cache against the JAX package's, on the CPU.

int8 and fp8 (e4m3) pages with per-token scales in (8, 128) fp32 tiles
(lane t of a page's tile holds token t's scale, in all 8 rows). Inputs come
from numpy seeds and go to both packages; the JAX side runs its Pallas
kernels in interpret mode, the port its plain versions, both in fp32. JAX's
fp8 arrays cross as uint8 views, reinterpreted with
``.view(torch.float8_e4m3fn)``.

Tolerances: the quantizer, the quantized writes and the packing of the
scale tiles are bit-identical (the same fp32 operations in the same order,
int8 rounded half to even, e4m3 to nearest even). The paged attention takes
the repo's forward gates (atol 5e-3, mean_atol 2e-4, mean_rtol 1e-2), and
the model's logits and the chunk's K/V the other model tests' max abs 1e-4
where both sides quantize the same values. Where the values quantized come
out of fp32 matmuls summed in another order (decode's new K/V, the fake
quantization of prefill's K/V), a value within an ulp of a rounding boundary
can land one step apart: there the 8-bit values must be equal except at
most 1% of them, each one step off, and the logits agree to 2e-3 with int8
and 1e-2 with fp8 (one step of one element moves them by about the step's
size: amax / 127 for int8, up to 1/8 of the element itself for e4m3's
3-bit mantissa). The engines must emit the same greedy tokens. The kernels' cases against these plain versions are in
``tests/test_torch_kernels.py`` (marker ``gpu``).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu.ops.kv_update import write_token_kv as jax_write
from flash_attention_tpu.ops.paged_attention import \
    paged_attention as jax_paged
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu.utils.metrics import assert_metrics
import flash_attention_tpu_torch as fat
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops import kv_update
from flash_attention_tpu_torch.ops import quant

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
ATOL = 1e-4
LOGIT_ATOL = {"int8": 2e-3, "fp8": 1e-2}
FLIP_SHARE = 0.01
# (torch dtype, JAX dtype) of the two 8-bit caches
DTYPES = {"int8": (torch.int8, jnp.int8),
          "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
PS, NPAGES = 128, 6


def _bits(x) -> np.ndarray:
    """The bytes of an 8-bit array or tensor (JAX's or the port's)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy() if x.element_size() == 1 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _to_torch(x, dtype=None) -> torch.Tensor:
    """A JAX array on the port's side; an 8-bit one as its bytes, viewed as
    ``dtype``."""
    a = np.array(x)
    if a.dtype.itemsize == 1:
        return torch.from_numpy(a.view(np.uint8)).view(dtype)
    return torch.from_numpy(a)


def _values(rng, shape, torch_dtype):
    """fp32 values of unit scale with the quantizer's hard cases on the
    last axis: a zero row (scale 1e-8), and a row whose amax gives scale 1
    exactly (int8: 127; e4m3: 448) holding .5 ties (int8: n + 0.5) or
    values halfway between two e4m3 steps (odd integers in [17, 31])."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    d = shape[-1]
    flat[0] = 0.0
    if torch_dtype == torch.int8:
        flat[1] = np.arange(d) % 20 - 9.5
        flat[1, 0] = 127.0
    else:
        flat[1] = (17 + 2 * (np.arange(d) % 8)) * (-1.0) ** np.arange(d)
        flat[1, 0] = 448.0
    return x


def _assert_steps(got, want, dtype, what):
    """8-bit values equal but for at most FLIP_SHARE of them, each one
    quantization step apart (adjacent codes)."""
    g, w = _bits(got), _bits(want)
    if dtype == torch.int8:
        g, w = g.view(np.int8).astype(np.int32), w.view(np.int8).astype(
            np.int32)
        step = np.abs(g - w)
    else:  # e4m3 codes of one sign are ordered like their values
        gi, wi = g.astype(np.int32), w.astype(np.int32)
        step = np.where((gi ^ wi) & 0x80, 255, np.abs(gi - wi))
    share = float(np.mean(step != 0))
    assert step.max() <= 1 and share <= FLIP_SHARE, \
        f"{what}: {share:.2%} differ, by up to {step.max()} steps"


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("src", ["fp32", "bf16"])
def test_quantize_token_matches_jax(name, src):
    """``_quantize_token`` (JAX's ``models/llama.py``): the same bits and
    scales, zero rows and ties included."""
    td, jd = DTYPES[name]
    x = _values(np.random.default_rng(0), (3, 5, 128), td)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if src == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    qj, sj = jl._quantize_token(xj, jd)
    qt, st = quant._quantize_token(xt, td)
    assert qt.dtype == td and st.dtype == torch.float32
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0, 0]) == np.float32(1e-8)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("ps", [128, 48])
def test_quantize_kv_pages_matches_jax(name, ps):
    """``quantize_kv_pages`` (JAX ``ops/quant.py``): values and (8, 128)
    tiles bit-identical; lanes past the page size are 1.0."""
    td, jd = DTYPES[name]
    pages = _values(np.random.default_rng(1), (2, 3, ps, 64), td)
    qj, sj = jquant.quantize_kv_pages(jnp.asarray(pages), jd)
    qt, st = fat.quantize_kv_pages(torch.from_numpy(pages), td)
    assert st.shape == (2, 3, 8, 128) and st.is_contiguous()
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert bool((st[..., ps:] == 1.0).all())
    with pytest.raises(ValueError, match="unsupported"):
        fat.quantize_kv_pages(torch.from_numpy(pages), torch.float16)


def _quant_pool(rng, name, L, hk, total, d):
    """(k pages, v pages, k scales, v scales) as numpy, JAX's dtypes: pages
    of unit-scale values quantized per token by JAX's quantize_kv_pages."""
    _, jd = DTYPES[name]
    out = []
    for _ in range(2):
        x = rng.standard_normal((L * hk, total, PS, d)).astype(np.float32)
        x *= np.exp(rng.standard_normal((L * hk, total, PS, 1))).astype(
            np.float32)
        q, s = jquant.quantize_kv_pages(jnp.asarray(x), jd)
        out.append((np.asarray(q).reshape(L, hk, total, PS, d),
                    np.asarray(s).reshape(L, hk, total, 8, 128)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("window,softcap", [(None, None), (100, None),
                                            (None, 5.0), (100, 5.0)])
def test_paged_attention_quantized_matches_jax(name, window, softcap):
    """int8 and fp8 pages through JAX's Pallas kernel (the scales folded
    into its online softmax) and the port's plain version (K and V
    dequantized), with the window and the softcap, on a layer-stacked
    cache: lengths 1, a page edge, past it, and the table's width."""
    td, _ = DTYPES[name]
    rng = np.random.default_rng(7)
    L, hk, group, d, b, pps = 2, 2, 2, 64, 4, 2
    total = b * pps + 2
    kp, vp, ks, vs = _quant_pool(rng, name, L, hk, total, d)
    q = rng.standard_normal((b, hk * group, d)).astype(np.float32)
    tab = rng.permutation(total)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([1, 128, 129, 256], np.int32)
    kw = dict(window=window, softcap=softcap, layer=1)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab),
                   k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), **kw)
    ot = fat.paged_attention(
        torch.from_numpy(q), _to_torch(kp, td), _to_torch(vp, td),
        torch.from_numpy(lens), torch.from_numpy(tab),
        k_scales=_to_torch(ks), v_scales=_to_torch(vs), **kw)
    assert_metrics(f"paged[{name},w{window},cap{softcap}]", ot.numpy(),
                   np.asarray(oj), FWD_TOLS)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("how", ["quantized rows", "quantize in the write"])
def test_write_token_kv_quantized_matches_jax(name, how):
    """``write_token_kv`` with rows already quantized and their scales, and
    ``quantize_write_token_kv`` from the fp32 rows, against JAX's kernel
    after JAX's ``_quantize_token``: pools and scale tiles bit-identical
    everywhere but the trash page, which the padding rows share."""
    td, jd = DTYPES[name]
    rng = np.random.default_rng(11)
    L, hk, d, b = 2, 2, 128, 5
    kp, vp, ks, vs = _quant_pool(rng, name, L, hk, NPAGES, d)
    k = _values(rng, (b, hk, d), td)
    v = _values(rng, (b, hk, d), td)
    trash = NPAGES - 1
    wpage = np.asarray([3, 1, 3, trash, trash], np.int32)
    woff = np.asarray([0, 127, 64, 0, 0], np.int32)
    kq, ksc = jl._quantize_token(jnp.asarray(k), jd)
    vq, vsc = jl._quantize_token(jnp.asarray(v), jd)
    out_j = jax_write(*map(jnp.asarray, (kp, vp, ks, vs)), kq, vq, ksc, vsc,
                      jnp.asarray(wpage), jnp.asarray(woff),
                      layer=jnp.int32(1))
    pools = [_to_torch(x, td) for x in (kp, vp)] + [
        torch.from_numpy(x.copy()) for x in (ks, vs)]
    if how == "quantized rows":
        out_t = fat.write_token_kv(
            *pools, _to_torch(kq, td), _to_torch(vq, td), _to_torch(ksc),
            _to_torch(vsc), torch.from_numpy(wpage), torch.from_numpy(woff),
            layer=1)
    else:
        out_t = kv_update.quantize_write_token_kv(
            *pools, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(wpage), torch.from_numpy(woff), layer=1)
    assert all(a is b_ for a, b_ in zip(out_t, pools))  # in place
    keep = np.arange(NPAGES) != trash
    for got, want in zip(out_t, out_j):
        np.testing.assert_array_equal(_bits(got)[:, :, keep],
                                      _bits(want)[:, :, keep])
    assert not np.array_equal(_bits(out_t[0]), kp.view(np.uint8))


def _model():
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    pj = jl.init_params(jax.random.PRNGKey(2), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def model():
    return _model()


def _prefill_pages(model, name, lens):
    """Prompts of ``lens`` tokens prefilled by both packages and written to
    a quantized cache of NPAGES pages by each one's write_prefill_to_pages:
    (JAX cache as numpy, port cache, tables, tokens)."""
    cfg_j, cfg_t, pj, pt = model
    td, jd = DTYPES[name]
    rng = np.random.default_rng(5)
    bucket = 256
    toks = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    trash = NPAGES - 1
    tables = np.full((len(lens), 2), trash, np.int32)
    tables[0, :1] = [3]
    tables[1, :2] = [0, 2]
    dest = np.asarray([3, 0, 2, trash], np.int32)
    src_row = np.asarray([0, 1, 1, 0], np.int32)
    src_page = np.asarray([0, 0, 1, 0], np.int32)
    shape = (cfg_t.n_layers, cfg_t.n_kv_heads, NPAGES, PS, cfg_t.head_dim)
    sshape = shape[:3] + (8, 128)
    _, kj, vj = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    cache_j = jl.write_prefill_to_pages(
        jnp.zeros(shape, jd), jnp.zeros(shape, jd), (kj, vj),
        jnp.asarray(dest), jnp.asarray(src_row), jnp.asarray(src_page), PS,
        k_scales=jnp.ones(sshape), v_scales=jnp.ones(sshape))
    _, kt, vt = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    cache_t = (torch.zeros(shape, dtype=td), torch.zeros(shape, dtype=td),
               torch.ones(sshape), torch.ones(sshape))
    out = tl.write_prefill_to_pages(
        *cache_t[:2], (kt, vt), torch.from_numpy(dest),
        torch.from_numpy(src_row), torch.from_numpy(src_page), PS,
        k_scales=cache_t[2], v_scales=cache_t[3])
    assert all(a is b_ for a, b_ in zip(out, cache_t))  # in place
    # numpy copies: JAX's decode_step donates (deletes) its cache arrays
    return [np.array(x) for x in cache_j], cache_t, tables, toks


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_write_prefill_and_decode_quantized_match_jax(model, name):
    """Prefill two prompts (40 and 170 tokens) into a quantized cache with
    ``write_prefill_to_pages``, then one ``decode_step`` each on JAX's cache
    (the same input on both sides): the written pages are JAX's but for a
    few values one step apart (the prefill K/V come from fp32 matmuls in
    another order), the scale tiles agree to fp32 rounding, and the decode
    logits and the pages it writes match JAX's."""
    cfg_j, cfg_t, pj, pt = model
    td, _ = DTYPES[name]
    lens = [40, 170]
    cache_j, cache_t, tables, _ = _prefill_pages(model, name, lens)
    keep = np.arange(NPAGES) != NPAGES - 1
    for got, want, what in zip(cache_t, cache_j, ("k", "v", "ks", "vs")):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy()[:, :, keep],
                                       np.asarray(want)[:, :, keep],
                                       rtol=1e-5, err_msg=what)
        else:
            _assert_steps(got[:, :, keep], np.asarray(want)[:, :, keep], td,
                          f"{what} pages")
    feed = np.asarray([17, 200], np.int32)
    lengths = np.asarray([n + 1 for n in lens], np.int32)
    wpage = np.asarray([tables[i, n // PS] for i, n in enumerate(lens)],
                       np.int32)
    woff = np.asarray([n % PS for n in lens], np.int32)
    args = [feed, lengths, tables, wpage, woff]
    lj, *cache_j2 = jl.decode_step(pj, *map(jnp.asarray, cache_j),
                                   *map(jnp.asarray, args), cfg_j)
    cache_t = [_to_torch(x, td) for x in cache_j]
    lt, *cache_t2 = tl.decode_step(pt, *cache_t,
                                   *map(torch.from_numpy, args), cfg_t)
    assert all(a is b_ for a, b_ in zip(cache_t2, cache_t))  # in place
    err = float(np.max(np.abs(lt.numpy() - np.asarray(lj))))
    assert err <= LOGIT_ATOL[name], f"decode logits: max abs {err:.3e}"
    for got, want, what in zip(cache_t2, cache_j2, ("k", "v", "ks", "vs")):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy()[:, :, keep],
                                       np.asarray(want)[:, :, keep],
                                       rtol=1e-5, err_msg=what)
        else:
            _assert_steps(got[:, :, keep], np.asarray(want)[:, :, keep], td,
                          f"{what} pages after decode")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_prefill_kv_fake_quant_matches_jax(model, name):
    """``prefill(kv_fake_quant=)`` rounds K/V through the cache's quantizer
    before attention, as JAX's: logits agree to LOGIT_ATOL, and the K/V it
    returns are the rounded ones (on the quantizer's grid)."""
    cfg_j, cfg_t, pj, pt = model
    td, jd = DTYPES[name]
    toks = np.random.default_rng(6).integers(0, 256, (2, 40)).astype(
        np.int32)
    lj, kj, _ = jl.prefill(pj, jnp.asarray(toks), cfg_j, kv_fake_quant=jd)
    lt, kt, _ = tl.prefill(pt, torch.from_numpy(toks), cfg_t,
                           kv_fake_quant=td)
    l0, _, _ = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    err = float(np.max(np.abs(lt.numpy() - np.asarray(lj))))
    assert err <= LOGIT_ATOL[name], f"logits: max abs {err:.3e}"
    assert float((lt - l0).abs().max()) > 1e-4  # the rounding moved them
    # K on the quantizer's grid, JAX's codes but for a few one step off
    _assert_steps(quant._quantize_token(kt, td)[0],
                  quant._quantize_token(_to_torch(kj), td)[0], td, "K codes")
    # the returned K is its own quantization's round trip
    assert torch.equal(kt, tl._fake_quant(kt, td))
    with pytest.raises(ValueError, match="kv_fake_quant"):
        tl.prefill(pt, torch.from_numpy(toks), cfg_t,
                   kv_fake_quant=torch.float16)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_prefill_chunk_over_quantized_prefix_matches_jax(model, name):
    """A chunk whose prefix lies in a quantized cache (the same pages and
    scales on both sides): the prefix is dequantized with its tokens'
    scales, and the logits and chunk K/V match JAX's."""
    cfg_j, cfg_t, pj, pt = model
    td, _ = DTYPES[name]
    lens = [40, 170]
    cache_j, _, tables, toks = _prefill_pages(model, name, lens)
    # row 0: tokens [40, 72) after its 40; row 1: [128, 160) after 128
    done = np.asarray([40, 128], np.int32)
    clen = np.asarray([32, 32], np.int32)
    chunk = np.stack([toks[0, 40:72], toks[1, 128:160]])
    args = [chunk, done, clen]
    lj, kj, vj = jl.prefill_chunk(pj, *map(jnp.asarray, args),
                                  *map(jnp.asarray, cache_j),
                                  jnp.asarray(tables), cfg_j)
    lt, kt, vt = tl.prefill_chunk(
        pt, *map(torch.from_numpy, args),
        *[_to_torch(x, td) for x in cache_j], torch.from_numpy(tables),
        cfg_t)
    for got, want, what in ((lt, lj, "logits"), (kt, kj, "chunk k"),
                            (vt, vj, "chunk v")):
        err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
        assert err <= ATOL, f"{what}: max abs {err:.3e}"
    # the prefix matters: with the scales all ones the logits move
    ones = torch.ones(cache_j[2].shape)
    lo, _, _ = tl.prefill_chunk(
        pt, *map(torch.from_numpy, args),
        *[_to_torch(x, td) for x in cache_j[:2]], ones, ones,
        torch.from_numpy(tables), cfg_t)
    assert float((lo - lt).abs().max()) > 1e-2


def _jax_engine_tokens(pj, kv_dtype, prompt, n_new, **kw):
    eng = JaxEngine(jl.LlamaConfig.tiny(), pj, total_pages=16, page_size=128,
                    max_batch=2, max_seq_len=512, kv_dtype=kv_dtype,
                    kv_quant=True, **kw)
    reqs = [eng.add_request(p, max_new_tokens=n_new) for p in prompt]
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_engine_kv_quant_matches_jax_engine(model, name):
    """``Engine(kv_quant=True)`` (int8; ``kv_dtype=torch.float8_e4m3fn`` for
    fp8) emits the JAX engine's greedy tokens on the same weights, two
    prompts (19 and 150 tokens: past one page) and 5 new tokens each, as
    ``tests/test_serving.py``'s kv_quant engines; a float kv_dtype with
    kv_quant means int8, as in JAX."""
    _, cfg_t, pj, pt = _model_for_engine(model)
    td, jd = DTYPES[name]
    rng = np.random.default_rng(2)
    prompts = [list(map(int, rng.integers(0, 255, size=n))) for n in (19, 150)]
    want = _jax_engine_tokens(pj, jnp.float32 if name == "int8" else jd,
                              prompts, 5)
    eng = Engine(cfg_t, pt, total_pages=16, page_size=128, max_batch=2,
                 max_seq_len=512,
                 kv_dtype=torch.float32 if name == "int8" else td,
                 kv_quant=True)
    assert eng.k_pages.dtype == td and eng.k_scales.shape == (
        cfg_t.n_layers, cfg_t.n_kv_heads, 16, 8, 128)
    reqs = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    eng.run()
    for r, w in zip(reqs, want):
        assert r.error is None, r.error
        assert r.output == w, (r.output, w)


def _model_for_engine(model):
    """The engine test's weights: JAX's tiny config from PRNGKey(0), as
    ``tests/test_serving.py``."""
    cfg_j, cfg_t, _, _ = model
    pj = jl.init_params(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("case", ["int8 without kv_quant",
                                  "fp8 without kv_quant",
                                  "page_size 64 with kv_quant"])
def test_engine_kv_dtype_validation(model, case):
    """JAX's ValueErrors (``tests/test_serving.py``'s
    test_engine_kv_dtype_validation and the page-size rule): an 8-bit
    kv_dtype without kv_quant, and kv_quant with a page size other than
    128."""
    _, cfg_t, _, pt = model
    kw = {"int8 without kv_quant": dict(kv_dtype=torch.int8),
          "fp8 without kv_quant": dict(kv_dtype=torch.float8_e4m3fn),
          "page_size 64 with kv_quant": dict(kv_quant=True, page_size=64)}
    kw = {"page_size": 128, **kw[case]}
    with pytest.raises(ValueError, match="kv_quant"):
        Engine(cfg_t, pt, total_pages=16, max_batch=2, max_seq_len=256, **kw)
