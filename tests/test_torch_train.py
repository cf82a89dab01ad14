"""The port's training entry point against the JAX package's, on the CPU.

``train_loss`` and its gradients for ``tiny()`` and ``tiny_qwen2()``: JAX's
parameters cross over with ``params_from_jax``, tokens and targets come from
numpy seeds, and both sides run fp32 (the JAX side's Pallas kernels in
interpret mode, the port's plain versions), with remat on both. The sums
run in other orders on the two sides, so the loss must agree to 1e-5
absolute and each gradient to max abs 1e-5 and relative L2 1e-4 (both
measured near 1e-6). As in ``tests/test_train.py``: the train forward equals
the inference forward, remat changes no gradient (rtol 1e-5, atol 1e-6), and
every negative target is ignored.
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

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
GRAD_REL_L2 = 1e-4
CONFIGS = ("tiny", "tiny_qwen2")


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 33)).astype(np.int32)
    tgt = rng.integers(0, vocab, (2, 33)).astype(np.int32)
    tgt[1, 20:] = -100   # ignored positions
    tgt[0, 5] = -7       # another ignored marker
    return toks, tgt


def _port_params(pj):
    params = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()},
                                "cpu", torch.float32)
    for p in params.values():
        p.requires_grad_()
    return params


def _grads(params, toks, tgt, cfg, remat):
    loss = tl.train_loss(params, torch.from_numpy(toks),
                         torch.from_numpy(tgt), cfg, remat=remat)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    cfg_j = getattr(jl.LlamaConfig, request.param)()
    cfg_t = getattr(tl.LlamaConfig, request.param)()
    pj = jl.init_params(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    return cfg_j, cfg_t, pj, _port_params(pj)


def test_train_loss_and_grads_match_jax(model):
    cfg_j, cfg_t, pj, pt = model
    toks, tgt = _batch(cfg_t.vocab_size)
    loss_j, g_j = jax.value_and_grad(lambda p: jl.train_loss(
        p, jnp.asarray(toks), jnp.asarray(tgt), cfg_j, remat=True))(pj)
    loss_t, g_t = _grads(pt, toks, tgt, cfg_t, remat=True)
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_ATOL
    assert sorted(g_t) == sorted(g_j)
    for name, g in g_t.items():
        ref = np.asarray(g_j[name])
        assert g.shape == ref.shape, name
        err = np.abs(g.numpy() - ref)
        rel = float(np.linalg.norm(err) / np.linalg.norm(ref))
        assert err.max() <= GRAD_ATOL and rel <= GRAD_REL_L2, (
            f"{name}: max abs {err.max():.3e}, rel L2 {rel:.3e}")


def test_train_forward_matches_prefill_and_remat_grads(model):
    _, cfg_t, _, pt = model
    toks, tgt = _batch(cfg_t.vocab_size, seed=1)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        lg_inf, _, _ = tl.prefill(pt, tt, cfg_t)
    lg_train, ks, vs = tl.prefill(pt, tt, cfg_t, return_kv=False, remat=True)
    assert ks is None and vs is None and lg_train.requires_grad
    torch.testing.assert_close(lg_train.detach(), lg_inf, rtol=1e-5,
                               atol=1e-6)
    loss_r, g_r = _grads(pt, toks, tgt, cfg_t, remat=True)
    loss_n, g_n = _grads(pt, toks, tgt, cfg_t, remat=False)
    assert float(loss_r) == float(loss_n)
    for name in g_r:
        torch.testing.assert_close(g_r[name], g_n[name], rtol=1e-5,
                                   atol=1e-6, msg=name)
    assert 0.0 < float(loss_r) < 20.0


def test_every_negative_target_is_ignored(model):
    """-100 and -7 mark ignored positions alike: changing one to the other
    changes neither the loss nor any gradient."""
    _, cfg_t, _, pt = model
    toks, tgt = _batch(cfg_t.vocab_size, seed=2)
    tgt2 = tgt.copy()
    tgt2[1, 25] = -7
    tgt2[0, 5] = -100
    loss, g = _grads(pt, toks, tgt, cfg_t, remat=False)
    loss2, g2 = _grads(pt, toks, tgt2, cfg_t, remat=False)
    assert float(loss) == float(loss2)
    assert all(torch.equal(g[n], g2[n]) for n in g)
    everything = torch.full(tgt.shape, -3)
    with torch.no_grad():
        assert float(tl.train_loss(pt, torch.from_numpy(toks), everything,
                                   cfg_t)) == 0.0


def test_layer_weights_are_views_with_stacked_grads():
    """``_layer_weights`` hands each layer views of the stacked weights
    (one unbind per weight), so each stacked weight gets one gradient of
    its own stacked shape."""
    cfg = tl.LlamaConfig.tiny_qwen2(n_layers=3, vocab_size=64, dim=128,
                                    hidden_dim=256)
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    layers = tl._layer_weights(params)
    assert len(layers) == 3 and set(layers[1]) >= {"wq", "bq", "norm_mlp"}
    assert layers[2]["w_up"].data_ptr() == params["w_up"][2].data_ptr()
    for p in params.values():
        p.requires_grad_()
    toks = torch.arange(16).reshape(2, 8) % 64
    tl.train_loss(params, toks, toks.roll(-1, 1), cfg).backward()
    for name, p in params.items():
        assert p.grad is not None and p.grad.shape == p.shape, name


@pytest.mark.parametrize("cfg,kw", [
    (tl.LlamaConfig.tiny_gemma2(), {"tp_axis": "model"}),
    (tl.LlamaConfig.tiny(), {"tp_axis": "model"}),
    (tl.LlamaConfig.tiny(), {"lora_ids": torch.zeros(2, dtype=torch.int32)}),
], ids=["gemma2", "tp_axis", "lora"])
def test_outside_the_slice_raises(cfg, kw):
    params = tl.init_params(tl.LlamaConfig.tiny(n_layers=1), device="cpu",
                            dtype=torch.float32)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        tl.train_loss(params, toks, toks, cfg, **kw)
