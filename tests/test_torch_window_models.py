"""Sliding windows, softcaps and the Gemma-2 extras in the port's model and
engine, against the JAX package's, on the CPU.

Four tiny configs: a Mistral-style window on every layer
(``tiny(sliding_window=32)``), and ``tiny_gemma2`` (window 64, attention
softcap 50, final softcap 30, GeGLU, sandwich norms, embed scale,
``query_scale``) with its window on every second layer and on every layer,
and at Gemma-2-9B's head dim 256 (2 layers).
JAX's parameters cross over with ``params_from_jax`` and inputs come from
numpy seeds; both sides run fp32 (the JAX side's Pallas kernels in
interpret mode, the port's plain versions). Prompts are longer than the
windows, so the windows bind. Prefill logits, K/V and decode logits must
agree to max abs 1e-4 (as ``tests/test_torch_llama.py``), the loss to 1e-5
and each gradient to max abs 1e-5 and relative L2 1e-4 (as
``tests/test_torch_train.py``). The engine, with a window on every layer,
frees the pages the window has passed: its greedy tokens and the pages it
holds after admission and after every step must equal the JAX engine's.
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

ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
GRAD_REL_L2 = 1e-4
PS, NPAGES = 16, 24
CONFIGS = {
    "mistral-tiny": ("tiny", dict(sliding_window=32)),
    "gemma2-tiny": ("tiny_gemma2", {}),
    "gemma2-tiny-every-layer": ("tiny_gemma2", dict(window_pattern=1)),
    "gemma2-tiny-d256": ("tiny_gemma2", dict(head_dim=256, n_layers=2)),
}


def _configs(name, **extra):
    ctor, kw = CONFIGS[name]
    kw = {**kw, **extra}
    return getattr(jl.LlamaConfig, ctor)(**kw), \
        getattr(tl.LlamaConfig, ctor)(**kw)


def _port_params(pj, grad=False):
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    for p in pt.values():
        p.requires_grad_(grad)
    return pt


def _close(a, b, what, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    err = float(np.max(np.abs(a - np.asarray(b))))
    assert err <= atol, f"{what}: max abs {err:.3e} > {atol}"


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    cfg_j, cfg_t = _configs(request.param)
    pj = jl.init_params(jax.random.PRNGKey(1), cfg_j, dtype=jnp.float32)
    return cfg_j, cfg_t, pj, _port_params(pj)


def test_init_params_carry_the_gemma2_norms(model):
    cfg_j, cfg_t, pj, _ = model
    pt = tl.init_params(cfg_t, device="cpu", dtype=torch.float32)
    assert sorted(pt) == sorted(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape, k


def test_prefill_and_decode_match_jax(model):
    """Prefill two prompts (100 and 70 tokens in a 112 bucket), scatter to
    pages, one decode step each: logits, K/V and decode logits match."""
    cfg_j, cfg_t, pj, pt = model
    L, hk = cfg_t.n_layers, cfg_t.n_kv_heads
    rng = np.random.default_rng(7)
    lens = [100, 70]
    toks = np.zeros((2, 112), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 256, n)
    lj, kj, vj = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    lt, kt, vt = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    _close(lt, lj, "prefill logits")
    _close(kt, kj, "k")
    _close(vt, vj, "v")

    trash = NPAGES - 1
    tables = np.full((2, 8), trash, np.int32)
    tables[0, :7] = np.arange(7)
    tables[1, :5] = np.arange(7, 12)
    dest = np.asarray([*range(12), trash, trash, trash, trash], np.int32)
    src_row = np.asarray([0] * 7 + [1] * 5 + [0] * 4, np.int32)
    src_page = np.asarray([*range(7), *range(5), 0, 0, 0, 0], np.int32)
    shape = (L, hk, NPAGES, PS, cfg_t.head_dim)
    kpj, vpj, _, _ = jl.write_prefill_to_pages(
        jnp.zeros(shape), jnp.zeros(shape), (kj, vj), jnp.asarray(dest),
        jnp.asarray(src_row), jnp.asarray(src_page), PS)
    kpt, vpt = torch.zeros(shape), torch.zeros(shape)
    tl.write_prefill_to_pages(kpt, vpt, (kt, vt), torch.from_numpy(dest),
                              torch.from_numpy(src_row),
                              torch.from_numpy(src_page), PS)
    feed = np.asarray([17, 200], np.int32)
    lengths = np.asarray([n + 1 for n in lens], np.int32)
    wpage = np.asarray([tables[i, n // PS] for i, n in enumerate(lens)],
                       np.int32)
    woff = np.asarray([n % PS for n in lens], np.int32)
    dj, *_ = jl.decode_step(
        pj, kpj, vpj, None, None, jnp.asarray(feed), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(wpage), jnp.asarray(woff), cfg_j)
    dt, *_ = tl.decode_step(
        pt, kpt, vpt, None, None, torch.from_numpy(feed),
        torch.from_numpy(lengths), torch.from_numpy(tables),
        torch.from_numpy(wpage), torch.from_numpy(woff), cfg_t)
    _close(dt, dj, "decode logits")


def test_train_loss_and_grads_match_jax(model):
    cfg_j, cfg_t, pj, _ = model
    pt = _port_params(pj, grad=True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 80)).astype(np.int32)
    tgt = rng.integers(0, 256, (2, 80)).astype(np.int32)
    tgt[1, 60:] = -100
    loss_j, g_j = jax.value_and_grad(lambda p: jl.train_loss(
        p, jnp.asarray(toks), jnp.asarray(tgt), cfg_j, remat=True))(pj)
    loss_t = tl.train_loss(pt, torch.from_numpy(toks), torch.from_numpy(tgt),
                           cfg_t, remat=True)
    grads = dict(zip(pt, torch.autograd.grad(loss_t, list(pt.values()))))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_ATOL
    assert sorted(grads) == sorted(g_j)
    for name, g in grads.items():
        ref = np.asarray(g_j[name])
        err = np.abs(g.numpy() - ref)
        rel = float(np.linalg.norm(err) / np.linalg.norm(ref))
        assert err.max() <= GRAD_ATOL and rel <= GRAD_REL_L2, (
            f"{name}: max abs {err.max():.3e}, rel L2 {rel:.3e}")


def test_window_pattern_must_divide_the_layers():
    cfg = tl.LlamaConfig.tiny_gemma2(n_layers=3)
    with pytest.raises(ValueError, match="window_pattern"):
        tl.check_supported(cfg)


# The engine: pages of 8 tokens and a window of 16, so the JAX rule's blocks
# of 8 pages (64 tokens) fall behind the window. The 100-token prompt is
# admitted with 8 hole pages; the 70-token one frees a block at length 80,
# during decode; the 40-token one crosses the window in its prefill.
ENGINE_KW = dict(total_pages=64, page_size=8, max_batch=4, max_seq_len=128)
ENGINE_PROMPTS = (100, 70, 40)
ENGINE_NEW = 12


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_reclaims_window_pages_as_jax(name):
    cfg_j, cfg_t = _configs(name, sliding_window=16)
    pj = jl.init_params(jax.random.PRNGKey(2), cfg_j, dtype=jnp.float32)
    pt = _port_params(pj)
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(0, 255, n)))
               for n in ENGINE_PROMPTS]
    ej = JaxEngine(cfg_j, pj, kv_dtype=jnp.float32, **ENGINE_KW)
    et = Engine(cfg_t, pt, **ENGINE_KW)
    rj = [ej.add_request(p, max_new_tokens=ENGINE_NEW) for p in prompts]
    rt = [et.add_request(p, max_new_tokens=ENGINE_NEW) for p in prompts]
    held = []
    while ej.sched.has_work or et.sched.has_work:
        ej.step()
        et.step()
        free = (ej.rt.free_pages(), et.rt.free_pages())
        assert free[0] == free[1], (len(held), free)
        held.append(ENGINE_KW["total_pages"] - free[1])
    for a, b in zip(rt, rj):
        assert a.error is None
        assert a.output == b.output, (a.output, b.output)
    if cfg_t.window_pattern == 1:  # the window frees pages during decode
        assert held[0] < sum(-(-(n + 1) // 8) for n in ENGINE_PROMPTS) + 1
        assert any(b < a for a, b in zip(held[:-2], held[1:-1]))


def test_deleting_the_engine_frees_its_cache():
    """The engine's window rule lives in the scheduler without a reference
    back to the engine: ``del engine`` frees the KV cache at once, with no
    garbage-collector pass (a cycle would keep it alive, and a caller that
    frees one model's engine before loading the next would hold both)."""
    import gc
    import weakref
    cfg = tl.LlamaConfig.tiny(sliding_window=16, n_layers=1)
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    gc.disable()
    try:
        eng = Engine(cfg, params, total_pages=16, page_size=8, max_batch=2,
                     max_seq_len=64)
        eng.add_request([1, 2, 3], max_new_tokens=2)
        eng.run()
        cache = weakref.ref(eng.k_pages)
        del eng
        assert cache() is None
    finally:
        gc.enable()
