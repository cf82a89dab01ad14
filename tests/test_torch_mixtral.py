"""The port's Mixtral (MoE) model against the JAX package's, on the CPU.

``LlamaConfig.tiny_moe()`` (2 layers, dim 256, 4 experts, top-2) in fp32:
JAX's parameters cross over with ``params_from_jax``, tokens come from numpy
seeds, the JAX side's Pallas kernels run in interpret mode and the port's
plain versions. Prefill logits and K/V and a decode step agree to max abs
1e-4; the engine emits the JAX engine's greedy tokens on
``tests/test_moe.py``'s prompts; ``train_loss`` agrees to 1e-5 and every
gradient, the router's included, to max abs 1e-4.
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
PS, NPAGES = 16, 16


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jl.LlamaConfig.tiny_moe(), tl.LlamaConfig.tiny_moe()
    pj = jl.init_params(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return cfg_j, cfg_t, pj, pt


def _close(a, b, what, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    err = float(np.max(np.abs(a - np.asarray(b))))
    assert err <= atol, f"{what}: max abs {err:.3e} > {atol}"


def test_params_carry_across(model):
    _, cfg_t, pj, pt = model
    assert sorted(pt) == sorted(pj)
    L, E, D, F = 2, cfg_t.n_experts, cfg_t.dim, cfg_t.hidden_dim
    assert pt["w_gate"].shape == (L, E, D, F)
    assert pt["w_down"].shape == (L, E, F, D)
    assert pt["w_router"].shape == (L, D, E)
    for k in pj:
        assert np.array_equal(pt[k].numpy(), np.asarray(pj[k])), k


def test_prefill_and_decode_match_jax(model):
    """Prefill logits and K/V of a (2, 40) batch, then one decode step of
    row 0 on pages written from the prefill of its first 39 tokens."""
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    lj, kj, vj = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    lt, kt, vt = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    _close(lt, lj, "logits")
    _close(kt, kj, "k")
    _close(vt, vj, "v")

    L, hk = cfg_t.n_layers, cfg_t.n_kv_heads
    shape = (L, hk, NPAGES, PS, 128)
    p = toks[:1, :39]
    _, kj, vj = jl.prefill(pj, jnp.asarray(p), cfg_j)
    _, kt, vt = tl.prefill(pt, torch.from_numpy(p), cfg_t)
    dest = np.asarray([3, 7, 1], np.int32)
    zeros = np.zeros(3, np.int32)
    src_page = np.arange(3, dtype=np.int32)
    kpj, vpj, _, _ = jl.write_prefill_to_pages(
        jnp.zeros(shape), jnp.zeros(shape), (kj, vj), jnp.asarray(dest),
        jnp.asarray(zeros), jnp.asarray(src_page), PS)
    kpt, vpt = torch.zeros(shape), torch.zeros(shape)
    tl.write_prefill_to_pages(kpt, vpt, (kt, vt), torch.from_numpy(dest),
                              torch.from_numpy(zeros),
                              torch.from_numpy(src_page), PS)
    args = (np.asarray([toks[0, 39]], np.int32), np.asarray([40], np.int32),
            dest[None], np.asarray([dest[2]], np.int32),
            np.asarray([39 - 2 * PS], np.int32))
    dj, *_ = jl.decode_step(pj, kpj, vpj, None, None,
                            *map(jnp.asarray, args), cfg_j)
    dt, *_ = tl.decode_step(pt, kpt, vpt, None, None,
                            *map(torch.from_numpy, args), cfg_t)
    _close(dt, dj, "decode logits")
    _close(dt[0], lt[0, -1], "decode vs prefill")


def test_engine_matches_jax_engine(model):
    """tests/test_moe.py:136-148's prompts and engine settings."""
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(0, 255, size=n)))
               for n in (5, 23, 17)]
    kw = dict(total_pages=96, page_size=16, max_batch=4, max_seq_len=256)
    je = JaxEngine(cfg_j, pj, kv_dtype=jnp.float32, **kw)
    want = [je.add_request(p, max_new_tokens=6) for p in prompts]
    je.run()
    eng = Engine(cfg_t, pt, **kw)
    got = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for r, w in zip(got, want):
        assert r.error is None
        assert r.output == w.output, (r.output, w.output)


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 255, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, 255, (2, 32)).astype(np.int32)
    tgt[1, 20:] = -100
    return toks, tgt


def _grads(params, toks, tgt, cfg, remat):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = tl.train_loss(leaves, torch.from_numpy(toks),
                         torch.from_numpy(tgt), cfg, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_train_loss_and_grads_match_jax(model):
    cfg_j, cfg_t, pj, pt = model
    toks, tgt = _batch()
    loss_j, g_j = jax.value_and_grad(lambda p: jl.train_loss(
        p, jnp.asarray(toks), jnp.asarray(tgt), cfg_j, remat=True))(pj)
    loss_t, g_t = _grads(pt, toks, tgt, cfg_t, remat=True)
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_ATOL
    assert sorted(g_t) == sorted(g_j)
    for name, g in g_t.items():
        ref = np.asarray(g_j[name])
        assert np.all(np.isfinite(ref)), name
        _close(g, ref, f"grad {name}")
    assert float(g_t["w_router"].abs().max()) > 0
    # every expert of every layer got rows, and so a gradient
    assert bool(g_t["w_gate"].flatten(2).abs().amax(-1).gt(0).all())


def test_remat_gives_the_same_gradients(model):
    """Remat recomputes the routing in the backward; it must pick the same
    experts, so remat on and off give the same loss and gradients."""
    _, cfg_t, _, pt = model
    toks, tgt = _batch(seed=7)
    loss_r, g_r = _grads(pt, toks, tgt, cfg_t, remat=True)
    loss_n, g_n = _grads(pt, toks, tgt, cfg_t, remat=False)
    assert float(loss_r) == float(loss_n)
    for name in g_r:
        torch.testing.assert_close(g_r[name], g_n[name], rtol=1e-5,
                                   atol=1e-6, msg=name)


def test_init_params_matches_jax_layout():
    cfg_t = tl.LlamaConfig.tiny_moe()
    pt = tl.init_params(cfg_t, seed=0, device="cpu", dtype=torch.float32)
    pj = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny_moe(),
                        dtype=jnp.float32)
    assert sorted(pt) == sorted(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape, k
    D, F = cfg_t.dim, cfg_t.hidden_dim
    for name, scale in (("w_gate", D**-0.5), ("w_up", D**-0.5),
                        ("w_down", F**-0.5), ("w_router", 0.02)):
        assert abs(float(pt[name].std()) - scale) < 0.03 * scale, name
    # each (layer, expert) slice is its own draw
    assert not torch.equal(pt["w_up"][0, 0], pt["w_up"][0, 1])


def test_moe_outside_the_slice_raises(model):
    """MoE with LoRA raises the JAX package's ValueError (stacks without
    ids raise its other one first); a bare tp_axis name (JAX's shard_map
    form; expert parallelism takes (mesh, axis), tests/test_torch_tp.py)
    raises NotImplementedError."""
    _, cfg_t, _, pt = model
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="MoE expert weights"):
        tl.train_loss({**pt, "lora": {}}, toks, toks, cfg_t,
                      lora_ids=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="no lora_ids given"):
        tl.prefill({**pt, "lora": {}}, toks, cfg_t)
    with pytest.raises(NotImplementedError):
        tl.prefill(pt, toks, cfg_t, tp_axis="model")
