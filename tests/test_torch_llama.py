"""The port's Llama model against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_params`` and cross over with
``params_from_jax``; prompts come from numpy seeds. Both sides run fp32 (the
JAX side's Pallas kernels in interpret mode), so prefill logits, K/V, the
paged cache after ``write_prefill_to_pages`` and ``decode_step`` logits and
caches must agree to max abs 1e-4.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu_torch.models import llama as tl

torch.set_num_threads(2)

ATOL = 1e-4
CONFIGS = {
    "llama3-tiny": dict(n_kv_heads=1, rope_theta=5e5),
    "qwen2-tiny": dict(attn_bias=True),
}
PS, NPAGES = 16, 24


def _pair(name):
    kw = CONFIGS[name]
    cfg_j, cfg_t = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    pj = jl.init_params(jax.random.PRNGKey(1), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return cfg_j, cfg_t, pj, pt


def _close(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    err = float(np.max(np.abs(a - np.asarray(b))))
    assert err <= ATOL, f"{what}: max abs {err:.3e} > {ATOL}"


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    return _pair(request.param)


def test_prefill_matches_jax(model):
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    lj, kj, vj = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    lt, kt, vt = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    assert lt.shape == (2, 40, 256) and kt.shape == (2, 2, 40, cfg_t.n_kv_heads, 128)
    _close(lt, lj, "logits")
    _close(kt, kj, "k")
    _close(vt, vj, "v")
    rows = np.asarray([39, 12], np.int32)
    lrj, _, _ = jl.prefill(pj, jnp.asarray(toks), cfg_j,
                           logit_rows=jnp.asarray(rows))
    lrt, _, _ = tl.prefill(pt, torch.from_numpy(toks), cfg_t,
                           logit_rows=torch.from_numpy(rows))
    assert lrt.shape == (2, 256)
    _close(lrt, lrj, "logit_rows")


def test_pages_and_decode_match_jax(model):
    """Prefill two prompts (lengths 21 and 33 in a 48 bucket), scatter to
    pages, then one decode step each: caches and logits match JAX's."""
    cfg_j, cfg_t, pj, pt = model
    L, hk = cfg_t.n_layers, cfg_t.n_kv_heads
    rng = np.random.default_rng(3)
    lens = [21, 33]
    toks = np.zeros((2, 48), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    trash = NPAGES - 1
    tables = np.full((2, 4), trash, np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [0, 7, 9]
    dest = np.asarray([5, 2, 0, 7, 9, trash, trash, trash], np.int32)
    src_row = np.asarray([0, 0, 1, 1, 1, 0, 0, 0], np.int32)
    src_page = np.asarray([0, 1, 0, 1, 2, 0, 0, 0], np.int32)
    shape = (L, hk, NPAGES, PS, 128)

    _, kj, vj = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    kpj, vpj, _, _ = jl.write_prefill_to_pages(
        jnp.zeros(shape), jnp.zeros(shape), (kj, vj), jnp.asarray(dest),
        jnp.asarray(src_row), jnp.asarray(src_page), PS)
    _, kt, vt = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    kpt, vpt = torch.zeros(shape), torch.zeros(shape)
    tl.write_prefill_to_pages(kpt, vpt, (kt, vt), torch.from_numpy(dest),
                              torch.from_numpy(src_row),
                              torch.from_numpy(src_page), PS)
    keep = np.arange(NPAGES) != trash
    _close(kpt[:, :, keep], np.asarray(kpj)[:, :, keep], "k pages")
    _close(vpt[:, :, keep], np.asarray(vpj)[:, :, keep], "v pages")

    # decode the next token of each row (its KV lands at slot len)
    feed = np.asarray([17, 200], np.int32)
    lengths = np.asarray([n + 1 for n in lens], np.int32)
    wpage = np.asarray([tables[i, n // PS] for i, n in enumerate(lens)],
                       np.int32)
    woff = np.asarray([n % PS for n in lens], np.int32)
    lj_, kpj, vpj, _, _ = jl.decode_step(
        pj, kpj, vpj, None, None, jnp.asarray(feed), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(wpage), jnp.asarray(woff), cfg_j)
    lt_, kpt2, vpt2, _, _ = tl.decode_step(
        pt, kpt, vpt, None, None, torch.from_numpy(feed),
        torch.from_numpy(lengths), torch.from_numpy(tables),
        torch.from_numpy(wpage), torch.from_numpy(woff), cfg_t)
    assert kpt2 is kpt and vpt2 is vpt  # the cache is updated in place
    _close(lt_, lj_, "decode logits")
    _close(kpt[:, :, keep], np.asarray(kpj)[:, :, keep], "k pages after decode")
    _close(vpt[:, :, keep], np.asarray(vpj)[:, :, keep], "v pages after decode")


def test_decode_matches_prefill_of_longer_prompt(model):
    """Decode on the pages equals the prefill logits of the prompt + token
    (the same identity chip_smoke.py checks on the card)."""
    _, cfg_t, _, pt = model
    rng = np.random.default_rng(5)
    p = rng.integers(0, 256, 30)
    want, _, _ = tl.prefill(pt, torch.from_numpy(p[None]), cfg_t)
    _, kt, vt = tl.prefill(pt, torch.from_numpy(p[None, :-1]), cfg_t)
    shape = (cfg_t.n_layers, cfg_t.n_kv_heads, 2, PS, 128)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    ids = torch.arange(2)
    tl.write_prefill_to_pages(kp, vp, (kt, vt), ids, torch.zeros_like(ids),
                              ids, PS)
    i32 = dict(dtype=torch.int32)
    got, *_ = tl.decode_step(pt, kp, vp, None, None, torch.tensor([p[-1]]),
                             torch.tensor([30], **i32),
                             torch.tensor([[0, 1]], **i32),
                             torch.tensor([1], **i32), torch.tensor([13], **i32),
                             cfg_t)
    _close(got[0], want[0, -1].numpy(), "decode vs prefill")


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 128), dtype=np.float32)
    pos = np.tile(np.arange(9000, 9009, dtype=np.int32), (2, 1))
    a = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, scaling)
    b = jl._rope(jnp.asarray(x), jnp.asarray(pos), 5e5, scaling)
    _close(a, b, f"rope {scaling}")


def test_init_params_layout_matches_jax():
    cfg_t = tl.LlamaConfig.tiny_qwen2()
    pt = tl.init_params(cfg_t, seed=0, device="cpu", dtype=torch.float32)
    pj = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny_qwen2(),
                        dtype=jnp.float32)
    assert sorted(pt) == sorted(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape, k
    # N(0, 1/in) like the JAX init (in = 256 for wq)
    assert abs(float(pt["wq"].std()) - 256**-0.5) < 5e-3
    again = tl.init_params(cfg_t, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(pt["w_down"], again["w_down"])


@pytest.mark.parametrize("cfg", [
    tl.LlamaConfig.tiny(attn_softcap=50.0), tl.LlamaConfig.tiny_gemma2(),
    tl.LlamaConfig.mistral_7b(),
])
def test_configs_outside_the_slice_raise(cfg):
    """Softcaps, sliding windows and the Gemma-2 extras are in the slice;
    what is outside it still raises with each of these configs: tensor
    parallelism, LoRA adapters and quantized MoE experts."""
    tl.check_supported(cfg)
    params = tl.init_params(tl.LlamaConfig.tiny(n_layers=1), device="cpu",
                            dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tl.check_supported(cfg, tp_axis="model")
    with pytest.raises(NotImplementedError):
        tl.check_supported(cfg, {**params, "lora": {}})
    qparams = tl.quantize_params(params)
    with pytest.raises(NotImplementedError):
        tl.check_supported(cfg, {**qparams, "w_router": params["wq"]})
