"""Several SGD steps of a windowed model: the port against the JAX package.

A tiny config with a 64-token window on every layer (``tiny`` with
``sliding_window=64``, 2 layers, d 128), trained on one fixed 2 x 256 batch
(the window binds for three quarters of the rows) by four steps of plain
SGD at lr 1.0, p -= lr * g, on both sides from the same weights (JAX's,
carried over by ``params_from_jax``). Both run fp32 on the CPU (JAX's
Pallas kernels in interpret mode, the port's plain versions), so each
step's loss must agree to 1e-4 relative: the two follow the same
trajectory, and a loss that does not fall at some step is the optimizer's
at this rate, not a fault of either side's attention.
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

STEPS = 4
LR = 1.0
LOSS_RTOL = 1e-4


def test_sgd_steps_match_jax():
    cfg_j = jl.LlamaConfig.tiny(sliding_window=64)
    cfg_t = tl.LlamaConfig.tiny(sliding_window=64)
    pj = jl.init_params(jax.random.PRNGKey(5), cfg_j, dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    for p in pt.values():
        p.requires_grad_()
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 256)).astype(np.int32)
    tgt = rng.integers(0, cfg_t.vocab_size, (2, 256)).astype(np.int32)
    grad_j = jax.value_and_grad(lambda p: jl.train_loss(
        p, jnp.asarray(toks), jnp.asarray(tgt), cfg_j, remat=True))
    losses = []
    for step in range(STEPS):
        loss_j, g_j = grad_j(pj)
        pj = {k: pj[k] - LR * g_j[k] for k in pj}
        loss_t = tl.train_loss(pt, torch.from_numpy(toks),
                               torch.from_numpy(tgt), cfg_t, remat=True)
        grads = torch.autograd.grad(loss_t, list(pt.values()))
        with torch.no_grad():
            for p, g in zip(pt.values(), grads):
                p -= LR * g
        lt, lj = float(loss_t.detach()), float(loss_j)
        losses.append((lt, lj))
        assert abs(lt - lj) <= LOSS_RTOL * abs(lj), (step, losses)
    assert all(np.isfinite(losses).ravel()), losses
