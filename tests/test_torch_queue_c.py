"""Head dims the kernels pad, GQA groups above 8, and the package's exports,
against the JAX package, on the CPU.

* Decode at every head dim the prefill takes: ``paged_attention`` at d 80
  and 96 on an unpadded cache and on one allocated at the kernels' width
  (``kernel_head_dim``: 128, the engine's), and the kv write (float rows,
  and the int8 and fp8 quantizing write) of d-96 rows into both, against
  JAX's kernels in interpret mode on the unpadded cache. The padded
  columns stay zero. An engine of a d-96 config serves JAX's engine's
  greedy tokens, its cache 128 wide, with every decode-side option.
* GQA groups 12 and 16 (Mistral-Large-2's, Llama-3.1-405B's; the card's
  kernel splits them into sub-groups of 8 over its grid): the port's
  ``paged_attention`` against JAX's.
* The names that the JAX package's ``ops``, ``serving``, ``models`` and
  ``parallel`` packages export, and ``FAT_IDENTITY_INPUTS``.

Tolerances: the repo's fp32 forward gates for attention outputs (atol 5e-3,
mean_atol 2e-4, mean_rtol 1e-2, ``tests/test_torch_paged.py``); the kv
write bit for bit; engine tokens exactly.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.ops.kv_update import write_token_kv as jax_write
from flash_attention_tpu.ops.paged_attention import \
    paged_attention as jax_paged
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu.utils import debug_inputs as jax_debug
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops import kv_update
from flash_attention_tpu_torch.ops import paged_attention as pa_mod
from flash_attention_tpu_torch.ops.attention import kernel_head_dim
from flash_attention_tpu_torch.utils import debug_inputs

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
PAGE_SIZE, PAGES_PER_SEQ, TOTAL, LAYERS = 16, 8, 40, 2
LENS = [1, PAGES_PER_SEQ * PAGE_SIZE, 32, 77]


def _setup(seed, b, h, hk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    shape = (LAYERS, hk, TOTAL, PAGE_SIZE, d)
    kp = rng.standard_normal(shape, dtype=np.float32)
    vp = rng.standard_normal(shape, dtype=np.float32)
    tab = rng.permutation(TOTAL)[:b * PAGES_PER_SEQ].reshape(
        b, PAGES_PER_SEQ).astype(np.int32)
    return q, kp, vp, tab


def _pad(x, width):
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])


@pytest.mark.parametrize("cache", ["unpadded", "padded"])
@pytest.mark.parametrize("d", [80, 96])
def test_paged_head_dim_matches_jax(d, cache):
    """d 80 and 96 against JAX's kernel on the same unpadded cache; the
    port's cache either the same or zero-padded to kernel_head_dim(d)."""
    hk, group = 2, 4
    q, kp, vp, tab = _setup(d, 4, hk * group, hk, d)
    lens = np.asarray(LENS, np.int32)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab), layer=1)
    if cache == "padded":
        kp, vp = _pad(kp, kernel_head_dim(d)), _pad(vp, kernel_head_dim(d))
    o = pa_mod.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(lens),
                               torch.from_numpy(tab), layer=1)
    assert o.shape == (4, hk * group, d)
    assert_metrics(f"paged[d{d},{cache}]", o.numpy(), np.asarray(oj),
                   FWD_TOLS)


@pytest.mark.parametrize("group", [12, 16])
def test_paged_large_group_matches_jax(group):
    """GQA groups above 8, with the window and the softcap too."""
    hk = 2
    q, kp, vp, tab = _setup(group, 4, hk * group, hk, 128)
    lens = np.asarray(LENS, np.int32)
    for kw in ({}, dict(window=40, softcap=5.0)):
        oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(lens), jnp.asarray(tab), layer=0, **kw)
        o = pa_mod.paged_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(lens), torch.from_numpy(tab), layer=0, **kw)
        assert_metrics(f"paged[g{group},{kw}]", o.numpy(), np.asarray(oj),
                       FWD_TOLS)
    assert pa_mod.sub_groups(group, 128) == -(-group // pa_mod.MAX_GROUP)


def _jax_quantize(x, dtype):
    """JAX's per-token quantizer, as its decode step calls it."""
    return jl._quantize_token(jnp.asarray(x), dtype)


@pytest.mark.parametrize("mode", ["plain_unpadded", "plain_padded", "int8",
                                  "fp8"])
def test_kv_write_head_dim_96_matches_jax(mode):
    """d-96 rows written into a d-96 cache (JAX) and into the port's cache,
    unpadded or at the kernels' width 128 (the 8-bit ones always at 128):
    the written values and scales bit for bit, the padding still zero."""
    rng = np.random.default_rng(5)
    d, width, hk, b = 96, 128, 2, 3
    wpage = np.asarray([3, 11, 20], np.int32)
    woff = np.asarray([0, 15, 9], np.int32)
    rows = [rng.standard_normal((b, hk, d), dtype=np.float32)
            for _ in range(2)]
    shape = (LAYERS, hk, TOTAL, PAGE_SIZE, d)
    if mode.startswith("plain"):
        kj, vj, _, _ = jax_write(jnp.zeros(shape, jnp.float32),
                                 jnp.zeros(shape, jnp.float32), None, None,
                                 *map(jnp.asarray, rows),
                                 None, None, jnp.asarray(wpage),
                                 jnp.asarray(woff), layer=1)
        w = d if mode == "plain_unpadded" else width
        kp = torch.zeros(shape[:-1] + (w,))
        vp = torch.zeros_like(kp)
        kv_update.write_token_kv(kp, vp, None, None,
                                 *map(torch.from_numpy, rows), None, None,
                                 torch.from_numpy(wpage),
                                 torch.from_numpy(woff), layer=1)
        pairs = ((kp, kj), (vp, vj))
    else:
        tdtype = torch.int8 if mode == "int8" else torch.float8_e4m3fn
        jdtype = jnp.int8 if mode == "int8" else jnp.float8_e4m3fn
        (kq, ksc), (vq, vsc) = (_jax_quantize(r, jdtype) for r in rows)
        sshape = (LAYERS, hk, TOTAL, 8, 128)
        kj, vj, ksj, vsj = jax_write(jnp.zeros(shape, jdtype),
                                     jnp.zeros(shape, jdtype),
                                     jnp.ones(sshape, jnp.float32),
                                     jnp.ones(sshape, jnp.float32),
                                     kq, vq, ksc, vsc,
                                     jnp.asarray(wpage), jnp.asarray(woff),
                                     layer=1)
        kp = torch.zeros(shape[:-1] + (width,), dtype=tdtype)
        vp = torch.zeros_like(kp)
        ks = torch.ones((LAYERS, hk, TOTAL, 8, 128))
        vs = torch.ones_like(ks)
        kv_update.quantize_write_token_kv(
            kp, vp, ks, vs, *map(torch.from_numpy, rows),
            torch.from_numpy(wpage), torch.from_numpy(woff), layer=1)
        np.testing.assert_array_equal(ks.numpy(), np.asarray(ksj))
        np.testing.assert_array_equal(vs.numpy(), np.asarray(vsj))
        pairs = ((kp.view(torch.uint8), kj.view(jnp.uint8)),
                 (vp.view(torch.uint8), vj.view(jnp.uint8)))
    for got, want in pairs:
        np.testing.assert_array_equal(got[..., :d].numpy(), np.asarray(want))
        assert not got[..., d:].any()


# the d-96 engines: Llama's tiny config at head dim 96
D96 = dict(head_dim=96)
PROMPTS = ((3, 70), (4, 30))
VARIANTS = {"default": {}, "chunked": dict(chunk_size=32),
            "decode_block": dict(decode_block=2),
            "prefix_cache": dict(prefix_cache=True), "spec": "spec",
            "kv_quant": dict(kv_quant=True, page_size=128, total_pages=8)}
ENGINE = dict(total_pages=32, page_size=16, max_batch=2, max_seq_len=256)


def _prompts():
    return [list(map(int, np.random.default_rng(s).integers(0, 255, n)))
            for s, n in PROMPTS]


@pytest.fixture(scope="module")
def d96():
    """The JAX engine's greedy tokens for the d-96 config (and with its
    int8 cache), and the weights as the port's."""
    cfg = jl.LlamaConfig.tiny(**D96)
    pj = jl.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    out = {}
    for name in ("default", "kv_quant"):
        kw = {**ENGINE, **(VARIANTS[name] if name == "kv_quant" else {})}
        eng = JaxEngine(cfg, pj, kv_dtype=jnp.float32, **kw)
        reqs = [eng.add_request(p, 6) for p in _prompts()]
        while eng.sched.has_work:
            eng.step()
        out[name] = [r.output for r in reqs]
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return out, pt


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_head_dim_96_matches_jax(d96, variant):
    """A d-96 model prefills and decodes through a cache 128 wide: JAX's
    greedy tokens with each option (kv_quant against JAX's int8 engine;
    the others, exact for greedy requests, against its default)."""
    want, pt = d96
    cfg = tl.LlamaConfig.tiny(**D96)
    kw = VARIANTS[variant]
    if kw == "spec":
        draft = {k: v if k in ("embed", "lm_head", "norm_out") else v[:1]
                 for k, v in pt.items()}
        kw = dict(draft_cfg=tl.LlamaConfig.tiny(n_layers=1, **D96),
                  draft_params=draft, n_draft=2)
    eng = Engine(cfg, pt, **{**ENGINE, **kw})
    assert eng.k_pages.shape[-1] == kernel_head_dim(96) == 128
    reqs = [eng.add_request(p, 6) for p in _prompts()]
    eng.run()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert [r.output for r in reqs] == \
        want["kv_quant" if variant == "kv_quant" else "default"]
    assert not eng.k_pages.view(torch.uint8)[..., 96 * eng.k_pages
                                             .element_size():].any()


@pytest.mark.parametrize("package", ["ops", "serving", "models", "parallel"])
def test_exports_match_jax(package):
    """The names each JAX package exports, but for those the port lists as
    not ported (tests/test_torch_signatures.py's JAX_NOT_PORTED): the
    same objects its own modules define."""
    import importlib
    from test_torch_signatures import JAX_NOT_PORTED
    jm = importlib.import_module(f"flash_attention_tpu.{package}")
    pm = importlib.import_module(f"flash_attention_tpu_torch.{package}")
    want = {n for n in jm.__all__ if f"{package}.{n}" not in JAX_NOT_PORTED}
    assert want <= set(pm.__all__), sorted(want - set(pm.__all__))
    for n in pm.__all__:
        obj = getattr(pm, n)
        assert getattr(obj, "__module__", obj.__name__).startswith(
            "flash_attention_tpu_torch."), n
    from flash_attention_tpu_torch.ops import fwd  # noqa: F401
    from flash_attention_tpu_torch.serving import Engine as E
    assert E is Engine


@pytest.mark.parametrize("value", [None, "", "0", "1", " 1 ", "yes"])
def test_identity_inputs_switch_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(debug_inputs.IDENTITY_ENV, raising=False)
    else:
        monkeypatch.setenv(debug_inputs.IDENTITY_ENV, value)
    assert debug_inputs.IDENTITY_ENV == jax_debug.IDENTITY_ENV
    assert debug_inputs.identity_inputs_enabled() == \
        jax_debug.identity_inputs_enabled()
