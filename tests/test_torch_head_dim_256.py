"""Head dim 256 (Gemma-2-9B's) and the head-dim routing of the port's
attention, against the JAX package's on the CPU.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
Pallas kernels in interpret mode, the port its plain versions (the CUDA
kernels' d-256 instances are held against the same plain versions on the
card, in ``test_torch_kernels.py``). fp32 on both sides, so the repo's
forward gates (atol 5e-3, mean_atol 2e-4, mean_rtol 1e-2) hold for O, the
gradients and paged decode, and the LSE gates of
``tests/test_flash_fwd.py:21`` for the LSE. The kernels take d 64, 128 and
256 as they are and any other d up to 256 zero-padded to the next of the
three (``kernel_head_dim``): d 192 runs at 256, as JAX pads it to a
multiple of 128. d 384 and 512 raise on the card.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax.numpy as jnp

import flash_attention_tpu as fat
from flash_attention_tpu.ops.paged_attention import \
    paged_attention as jax_paged
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import bwd, fwd, paged_attention
from flash_attention_tpu_torch.ops import flash_bwd as bwd_mod
from flash_attention_tpu_torch.ops import flash_fwd as fwd_mod
from flash_attention_tpu_torch.ops import paged_attention as pa_mod
from flash_attention_tpu_torch.ops.attention import (kernel_head_dim,
                                                     padded_head_dim)
from flash_attention_tpu_torch.ops.flash_bwd import flash_bwd_reference
from flash_attention_tpu_torch.ops.reference import reference_attention

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
BWD_TOLS = FWD_TOLS
# (causal, window_size, softcap): Gemma-2-9B's layers take all four of
# {window, global} x {cap}; the cap of 5 binds at unit-scale scores
CASES = {
    "causal": (True, None, None),
    "causal-cap": (True, None, 5.0),
    "window": (True, (63, 0), None),
    "window-cap": (True, (63, 0), 5.0),
    "two-sided": (False, (40, 20), None),
}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_bwd_d256_match_jax(case):
    """fwd and bwd at d 256, b1 s256 h2/1 (s 200 against 256 for the
    two-sided band): O, LSE, dq, dk and dv against JAX's."""
    causal, window, cap = CASES[case]
    sq = 200 if case == "two-sided" else 256
    q, k, v, do = _arrays(len(case), (1, sq, 2, 256), (1, 256, 1, 256),
                          (1, 256, 1, 256), (1, sq, 2, 256))
    kw = dict(window_size=window, softcap=cap)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = fwd(qt, kt, vt, causal, **kw)
    grads = bwd(qt, kt, vt, o, lse, dot, causal, **kw)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    oj, lsej = fat.fwd(qj, kj, vj, is_causal=causal, **kw)
    want = fat.bwd(qj, kj, vj, oj, lsej, doj, is_causal=causal, **kw)
    assert o.shape == q.shape and lse.shape == (1, 2, sq)
    assert_metrics(f"o[{case}]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics(f"lse[{case}]", lse.numpy(), np.asarray(lsej), LSE_TOLS)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.shape == ref.shape
        assert_metrics(f"{name}[{case}]", got.numpy(), np.asarray(ref),
                       BWD_TOLS)


@pytest.mark.parametrize("window,softcap", [(None, None), (40, None),
                                            (None, 5.0), (40, 5.0)])
def test_paged_attention_d256_matches_jax(window, softcap):
    """Paged decode at d 256 (h 4/2, pages of 16, a 3-layer pool): length
    1, a full table, a page edge and a ragged row."""
    ps, pps, total, layers, b, h, hk = 16, 8, 40, 3, 4, 4, 2
    q, kp, vp = _arrays(41, (b, h, 256), (layers, hk, total, ps, 256),
                        (layers, hk, total, ps, 256))
    tab = np.random.default_rng(42).permutation(total)[:b * pps].reshape(
        b, pps).astype(np.int32)
    lens = np.asarray([1, pps * ps, 32, 77], np.int32)
    o = paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                        torch.from_numpy(vp), torch.from_numpy(lens),
                        torch.from_numpy(tab), window=window, softcap=softcap,
                        layer=1)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab), window=window,
                   softcap=softcap, layer=1)
    assert o.shape == (b, h, 256)
    assert_metrics(f"paged[d256,w{window},c{softcap}]", o.numpy(),
                   np.asarray(oj), FWD_TOLS)


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_192_runs_padded_to_256(causal):
    """d 192 runs on the card zero-padded to 256: the helper around the
    plain versions, at the real d's scale, against JAX's fwd and bwd (which
    pad 192 to 256 too)."""
    d = 192
    q, k, v, do = _arrays(192, (1, 64, 2, d), (1, 80, 1, d), (1, 80, 1, d),
                          (1, 64, 2, d))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, sm_scale=d**-0.5)
    o, lse = padded_head_dim(lambda *x: reference_attention(*x, **kw),
                             kernel_head_dim(d), qt, kt, vt)
    grads = padded_head_dim(lambda *x: flash_bwd_reference(*x, **kw),
                            kernel_head_dim(d), qt, kt, vt, o, lse, dot)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    oj, lsej = fat.fwd(qj, kj, vj, is_causal=causal)
    want = fat.bwd(qj, kj, vj, oj, lsej, doj, is_causal=causal)
    assert o.shape == q.shape
    assert_metrics("o[d192]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics("lse[d192]", lse.numpy(), np.asarray(lsej), LSE_TOLS)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.shape == ref.shape
        assert_metrics(f"{name}[d192]", got.numpy(), np.asarray(ref),
                       BWD_TOLS)


@pytest.mark.parametrize("d,want", [(32, 64), (64, 64), (80, 128),
                                    (128, 128), (129, 256), (192, 256),
                                    (256, 256)])
def test_kernel_head_dim_routes_to_the_next_instance(d, want):
    assert kernel_head_dim(d) == want


@pytest.mark.parametrize("d", [257, 384, 512])
def test_head_dims_above_256_raise(d):
    """JAX runs 384 and 512; the card's kernels stop at 256, and the
    message names the d and where it is queued."""
    with pytest.raises(NotImplementedError, match=f"{d}.*ROADMAP"):
        kernel_head_dim(d)


def test_head_dim_lists_agree():
    """The forward, the backward and paged decode take the same head dims,
    and the routing returns only those."""
    assert fwd_mod.HEAD_DIMS == (64, 128, 256)
    assert bwd_mod.HEAD_DIMS == fwd_mod.HEAD_DIMS
    assert pa_mod.HEAD_DIMS == fwd_mod.HEAD_DIMS
    assert {kernel_head_dim(d) for d in range(1, 257)} == set(
        fwd_mod.HEAD_DIMS)
