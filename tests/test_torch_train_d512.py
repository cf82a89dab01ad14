"""Training at head dims 384 and 512 (and d 320, run at 384): the port's
backward against the JAX package's on the CPU, at DeepSeek-V4-Flash's
attention geometry cut to size (8 query heads on one kv head).

Inputs come from numpy seeds and go to both packages. The JAX side runs its
Pallas kernels in interpret mode (it pads d 320 to 384 itself), the port its
plain versions (the CUDA kernels' d-384 and 512 instances are held against
the same plain versions on the card, in ``test_torch_kernels.py``). Both
sides are fp32, so the repo's backward gates apply
(``tests/test_flash_bwd.py:19``, as ``test_torch_flash_bwd.py::
test_bwd_matches_jax`` uses them: atol 5e-3, mean_atol 2e-4, mean_rtol
1e-2). Two SGD steps of Llama's tiny config at the d-512 geometry (the
config of ``test_torch_head_dim_512.py``) follow JAX's to 1e-4 relative in
the loss, as ``test_torch_window_training.py`` holds four steps of a
windowed model.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

import flash_attention_tpu as fat
from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import (bwd, flash_attention, varlen_bwd,
                                       varlen_fwd)
from flash_attention_tpu_torch.models import llama as tl

torch.set_num_threads(2)

BWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LOSS_RTOL = 1e-4
H, HK = 8, 1  # a GQA group of 8 on one kv head
# (causal, window_size, softcap): V4-Flash's window (128 there, 15 here so
# that it binds at these lengths) and a softcap of 5, which binds at
# unit-scale scores
CASES = {"causal": (True, None, None), "window": (True, (15, 0), None),
         "softcap": (True, None, 5.0)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _hold(tag, got, want):
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == ref.shape
        assert_metrics(f"{name}[{tag}]", x.detach().numpy(), np.asarray(ref),
                       BWD_TOLS)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [320, 384, 512])
def test_bwd_wide_matches_jax(d, case):
    """bwd at b1 sq 48 sk 80 (the band lower-right aligned) on JAX's
    forward outputs: dq, dk and dv against JAX's."""
    causal, window, cap = CASES[case]
    q, k, v, do = _arrays(d + 3 * len(case), (1, 48, H, d), (1, 80, HK, d),
                          (1, 80, HK, d), (1, 48, H, d))
    kw = dict(window_size=window, softcap=cap)

    @jax.jit  # one compile of both calls: half the interpret-mode time
    def jax_side(qj, kj, vj, doj):
        o, lse = fat.fwd(qj, kj, vj, is_causal=causal, **kw)
        return o, lse, fat.bwd(qj, kj, vj, o, lse, doj, is_causal=causal,
                               **kw)

    o, lse, want = jax_side(*map(jnp.asarray, (q, k, v, do)))
    got = bwd(*(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
              causal, **kw)
    _hold(f"d{d},{case}", got, want)


def test_varlen_bwd_d512_matches_jax():
    """varlen_bwd over three packed sequences (len_k >= len_q in each, so
    causal is lower-right aligned per sequence), causal with the window, on
    JAX's varlen forward outputs."""
    d = 512
    cu_q = np.array([0, 20, 31, 56], np.int32)
    cu_k = np.array([0, 28, 45, 80], np.int32)
    q, k, v, do = _arrays(11, (56, H, d), (80, HK, d), (80, HK, d),
                          (56, H, d))
    kw = dict(is_causal=True, window_size=(15, 0))

    @jax.jit
    def jax_side(qj, kj, vj, doj, cqj, ckj):
        o, lse = fat.varlen_fwd(qj, kj, vj, cqj, ckj, **kw)
        return o, fat.varlen_bwd(qj, kj, vj, o, lse, doj, cqj, ckj, **kw)

    o, want = jax_side(*map(jnp.asarray, (q, k, v, do, cu_q, cu_k)))
    # the port's forward gives the same (o, lse) layouts; its own are fed
    # to its backward (a packed row of one package's LSE is the other's)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    cqt, ckt = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    ot, lset = varlen_fwd(qt, kt, vt, cqt, ckt, **kw)
    assert_metrics("varlen o[d512]", ot.numpy(), np.asarray(o), BWD_TOLS)
    got = varlen_bwd(qt, kt, vt, ot, lset, dot, cqt, ckt, **kw)
    _hold("varlen d512", got, want)


def test_flash_attention_grads_d512_match_jax():
    """Autograd through the port's ``flash_attention`` against jax.grad
    through ``fat.flash_attention``, causal with the window (d 320 and 384
    are held through ``bwd``, which the autograd backward calls, above)."""
    d = 512
    q, k, v, do = _arrays(d, (1, 64, H, d), (1, 64, HK, d), (1, 64, HK, d),
                          (1, 64, H, d))
    kw = dict(causal=True, window_size=(15, 0))

    def loss(q_, k_, v_):
        return jnp.sum(fat.flash_attention(q_, k_, v_, **kw)
                       * jnp.asarray(do))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    _hold(f"vjp d{d}", [x.grad for x in leaves], want)


# Llama's tiny config at V4-Flash's attention geometry (8 heads on 1 kv
# head, d 512, a window on every second layer), as test_torch_head_dim_512
D512 = dict(n_heads=H, n_kv_heads=HK, head_dim=512, sliding_window=24,
            window_pattern=2)
STEPS = 2
LR = 1.0


def test_sgd_steps_d512_match_jax():
    """Two SGD steps (p -= lr g, lr 1.0, remat) on one fixed 2 x 32 batch
    (the window of 24 binds for the last rows), both sides from JAX's
    weights: each step's loss within 1e-4 relative of JAX's, and the
    port's loss falls."""
    cfg_j, cfg_t = jl.LlamaConfig.tiny(**D512), tl.LlamaConfig.tiny(**D512)
    pj = jl.init_params(jax.random.PRNGKey(5), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    for p in pt.values():
        p.requires_grad_()
    rng = np.random.default_rng(17)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, cfg_t.vocab_size, (2, 32)).astype(np.int32)
    grad_j = jax.jit(jax.value_and_grad(lambda p: jl.train_loss(
        p, jnp.asarray(toks), jnp.asarray(tgt), cfg_j, remat=True)))
    losses = []
    for step in range(STEPS):
        loss_j, g_j = grad_j(pj)
        pj = {k: pj[k] - LR * g_j[k] for k in pj}
        loss_t = tl.train_loss(pt, torch.from_numpy(toks),
                               torch.from_numpy(tgt), cfg_t, remat=True)
        grads = torch.autograd.grad(loss_t, list(pt.values()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        with torch.no_grad():
            for p, g in zip(pt.values(), grads):
                p -= LR * g
        lt, lj = float(loss_t.detach()), float(loss_j)
        losses.append((lt, lj))
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (step, losses)
    assert losses[1][0] < losses[0][0], losses
