"""The port's backward against the JAX package's on the CPU.

Inputs come from numpy seeds and go to both packages. The JAX side runs
``fat.bwd`` with its Pallas kernels in interpret mode, as its own tests do;
the port runs its plain versions (the CUDA kernels are held against those
same plain versions on the card, in ``test_torch_kernels.py``). Both sides
are fp32, so the repo's backward gates apply (``tests/test_flash_bwd.py:19``:
atol 5e-3, mean_atol 2e-4, mean_rtol 1e-2); D takes the LSE gates of
``tests/test_flash_fwd.py:21`` (an fp32 row statistic).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

import flash_attention_tpu as fat
from flash_attention_tpu.ops.reference import (
    reference_attention_bwd as jax_ref_bwd)
from flash_attention_tpu.utils import debug_inputs as jax_debug
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import bwd, flash_attention, fwd
from flash_attention_tpu_torch.ops.reference import reference_attention_bwd
from flash_attention_tpu_torch.utils import debug_inputs

torch.set_num_threads(2)

BWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
DI_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
HEADS = [(4, 4), (4, 2), (4, 1)]
SEQ_PAIRS = [(64, 64), (97, 130), (130, 97), (1, 1), (64, 1)]
# every seq pair x causal x head dim, the head pairs taken in turn
CASES = [(sq, sk, *HEADS[i % 3], d, causal)
         for i, (sq, sk, d, causal) in enumerate(
             (sq, sk, d, c) for sq, sk in SEQ_PAIRS for d in (64, 128)
             for c in (False, True))]


def _inputs(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32),
            rng.standard_normal((b, sq, h, d), dtype=np.float32))


def _both(q, k, v, do, causal, **kw):
    """JAX fwd + bwd and the port's bwd on JAX's (o, lse): the same
    forward outputs on both sides, so the backward alone is compared."""
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    o, lse = fat.fwd(qj, kj, vj, is_causal=causal)
    want = fat.bwd(qj, kj, vj, o, lse, doj, is_causal=causal, **kw)
    got = bwd(*(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
              causal, **kw)
    return got, want


@pytest.mark.parametrize("sq,sk,h,hk,d,causal", CASES)
def test_bwd_matches_jax(sq, sk, h, hk, d, causal):
    q, k, v, do = _inputs(sq * 1000 + sk + d + h * 10 + hk, 2, sq, sk, h, hk,
                          d)
    (dq, dk, dv), want = _both(q, k, v, do, causal)
    assert dq.shape == (2, sq, h, d) and dk.shape == dv.shape == (2, sk, hk, d)
    assert dq.dtype == dk.dtype == torch.float32
    tag = f"{sq},{sk},{h}/{hk},d={d},causal={causal}"
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_metrics(f"{name}[{tag}]", got.numpy(), np.asarray(ref),
                       BWD_TOLS)


def test_bwd_parts_match_jax():
    """``parts="di"`` returns D (b, h, sq) fp32 (JAX: its raw (b, h, 8,
    sq_pad) layout), ``parts="dq"`` returns dq alone."""
    q, k, v, do = _inputs(7, 2, 97, 130, 4, 2, 64)
    di, di_j = _both(q, k, v, do, True, parts="di")
    assert di.shape == (2, 4, 97) and di.dtype == torch.float32
    assert_metrics("di", di.numpy(), np.asarray(di_j)[:, :, 0, :97], DI_TOLS)
    dq, dq_j = _both(q, k, v, do, True, parts="dq")
    assert_metrics("dq[parts]", dq.numpy(), np.asarray(dq_j), BWD_TOLS)
    t = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError):
        bwd(t, t, t, t, torch.zeros((1, 2, 4)), t, parts="dk")


def test_bwd_fully_masked_rows():
    """Causal sq > sk: rows with no live key get dq == 0 exactly and add
    nothing to dk/dv, as in the JAX package."""
    q, k, v, do = _inputs(4, 1, 200, 64, 2, 2, 64)
    (dq, dk, dv), want = _both(q, k, v, do, True)
    assert torch.all(dq[:, :136] == 0)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_metrics(f"masked {name}", got.numpy(), np.asarray(ref),
                       BWD_TOLS)


@pytest.mark.parametrize("window,softcap", [((16, 0), None), ((8, 4), None),
                                            (None, 5.0), ((32, 0), 20.0)])
def test_window_softcap_match_jax_oracle(window, softcap):
    """Window and softcap run in the plain versions on the CPU: ``bwd``
    (on the port's own forward) and the port's autograd oracle, each
    against JAX's ``reference_attention_bwd``."""
    q, k, v, do = _inputs(9, 2, 70, 90, 4, 2, 64)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = fwd(qt, kt, vt, True, window_size=window, softcap=softcap)
    got = bwd(qt, kt, vt, o, lse, dot, True, window_size=window,
              softcap=softcap)
    oracle = reference_attention_bwd(qt, kt, vt, dot, causal=True,
                                     window=window, softcap=softcap)
    want = jax_ref_bwd(*map(jnp.asarray, (q, k, v, do)), causal=True,
                       window=window, softcap=softcap)
    for name, a, b, ref in zip(("dq", "dk", "dv"), got, oracle, want):
        assert_metrics(f"{name}[band]", a.numpy(), np.asarray(ref), BWD_TOLS)
        assert_metrics(f"{name}[oracle]", b.numpy(), np.asarray(ref),
                       BWD_TOLS)


def test_flash_attention_grads_match_jax():
    """Autograd through the port's ``flash_attention`` against jax.grad
    through ``fat.flash_attention`` (the counterpart of the JAX suite's
    ``test_custom_vjp_end_to_end``)."""
    q, k, v, do = _inputs(3, 1, 256, 256, 4, 2, 64)

    def loss(q_, k_, v_):
        return jnp.sum(fat.flash_attention(q_, k_, v_, causal=True)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention(*leaves, causal=True, return_lse=True)
    assert not lse.requires_grad
    o.backward(torch.from_numpy(do))
    for name, x, ref in zip(("dq", "dk", "dv"), leaves, want):
        assert_metrics(f"vjp {name}", x.grad.numpy(), np.asarray(ref),
                       BWD_TOLS)


def test_identity_inputs_match_jax():
    """The identity-pattern inputs are the JAX package's, and the backward
    on them (one-hot rows: exact 0/1 score blocks) matches JAX's."""
    b, s, h, d = 2, 96, 2, 64
    x = debug_inputs.identity_batch(b, s, h, d, torch.float32,
                                   device="cpu")
    x_j = np.asarray(jax_debug.identity_batch(b, s, h, d, jnp.float32))
    assert x.shape == x_j.shape and np.array_equal(x.numpy(), x_j)
    packed = debug_inputs.identity_packed([5, 0, 70], h, d, torch.float32,
                                           device="cpu")
    assert np.array_equal(packed.numpy(), np.asarray(
        jax_debug.identity_packed([5, 0, 70], h, d, jnp.float32)))
    (dq, dk, dv), want = _both(x.numpy(), x.numpy(), x.numpy(),
                               x.numpy(), True)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert_metrics(f"identity {name}", got.numpy(), np.asarray(ref),
                       BWD_TOLS)
