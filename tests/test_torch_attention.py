"""The port's ``fwd`` against the JAX package's ``fwd`` on the CPU.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
Pallas kernel in interpret mode, the port its plain fp32 version (the CUDA
kernel is held against that same plain version on the card, in
``test_torch_kernels.py``). Tolerances: fp32 on both sides, so the repo's
forward gates (atol 5e-3, mean_atol 2e-4, mean_rtol 1e-2) for O and the LSE
gates of ``tests/test_flash_fwd.py:21``. A head dim the kernels do not take
(96) runs the plain versions through the kernels' zero-pad helper against
JAX's ``fwd``/``bwd``, which pad it too; the gradients take the backward
gates (the same values as the forward's).
"""

import inspect

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax.numpy as jnp

import flash_attention_tpu as fat
from flash_attention_tpu.ops.reference import reference_attention as jax_ref
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import SegmentIds, flash_attention, fwd
from flash_attention_tpu_torch.ops import flash_fwd as fwd_mod
from flash_attention_tpu_torch.ops.attention import (kernel_head_dim,
                                                     padded_head_dim)
from flash_attention_tpu_torch.ops.flash_bwd import (flash_bwd_dkv,
                                                     flash_bwd_dq,
                                                     flash_bwd_reference)
from flash_attention_tpu_torch.ops.reference import (
    reference_attention, reference_attention_bwd)

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
BWD_TOLS = FWD_TOLS


def _qkv(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (97, 130), (130, 97)])
def test_fwd_matches_jax(sq, sk, h, hk, d, causal):
    q, k, v = _qkv(sq * 1000 + sk + h * 10 + hk, 2, sq, sk, h, hk, d)
    o, lse = fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 causal)
    oj, lsej = fat.fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       is_causal=causal)
    tag = f"{sq},{sk},{h}/{hk},d={d},causal={causal}"
    assert o.shape == (2, sq, h, d) and lse.shape == (2, h, sq)
    assert lse.dtype == torch.float32
    assert_metrics(f"o[{tag}]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics(f"lse[{tag}]", lse.numpy(), np.asarray(lsej), LSE_TOLS)


def test_fully_masked_rows_are_zero():
    """Causal with sq > sk: the first sq - sk rows see no key; O = 0 and
    LSE = 0 in both packages."""
    q, k, v = _qkv(4, 1, 200, 64, 2, 2, 64)
    o, lse = fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 True)
    oj, lsej = fat.fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       is_causal=True)
    assert torch.all(o[:, :136] == 0) and torch.all(lse[:, :, :136] == 0)
    assert_metrics("o[masked]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics("lse[masked]", lse.numpy(), np.asarray(lsej), LSE_TOLS)


@pytest.mark.parametrize("window,softcap", [((16, 0), None), ((8, 4), None),
                                            (None, 5.0), ((32, 0), 20.0)])
def test_plain_window_softcap_match_jax_oracle(window, softcap):
    """Sliding window and softcap run in the plain version on the CPU."""
    q, k, v = _qkv(9, 2, 70, 90, 4, 2, 64)
    o, lse = fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 True, window_size=window, softcap=softcap)
    oj, lsej = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, softcap=softcap)
    assert_metrics("o[band]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics("lse[band]", lse.numpy(), np.asarray(lsej), LSE_TOLS)


def test_sm_scale_and_gqa_check():
    q, k, v = _qkv(3, 1, 33, 33, 4, 2, 64)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o, _ = fwd(qt, kt, vt, sm_scale=0.05)
    oj, _ = fat.fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    sm_scale=0.05)
    assert_metrics("o[scale]", o.numpy(), np.asarray(oj), FWD_TOLS)
    with pytest.raises(ValueError):
        fwd(qt, kt[:, :, :1].expand(1, 33, 3, 64), vt[:, :, :1].expand(1, 33, 3, 64))


def test_flash_attention_forward_only():
    """Without autograd ``flash_attention`` is ``fwd``; with it, gradients
    reach q, k and v (the port's autograd oracle, backward gates of
    tests/test_flash_bwd.py:19) and LSE carries none."""
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 16, 16, 2, 2, 64))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = reference_attention(q, k, v, causal=True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = flash_attention(*leaves, causal=True, return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    do = torch.from_numpy(_qkv(6, 1, 16, 16, 2, 2, 64)[0])
    o.backward(do)
    want = reference_attention_bwd(q, k, v, do, causal=True)
    for x, ref in zip(leaves, want):
        assert_metrics("grad", x.grad.numpy(), ref.numpy(), BWD_TOLS)


def test_kernel_wrapper_never_falls_back():
    """The CUDA wrappers take no CPU tensor: the plain path is chosen by
    ``fwd`` and ``bwd`` from the device, and the kernel wrappers raise
    instead, the forward's dense and segmented, and the segmented dq and
    dkv."""
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 16, 16, 2, 2, 64))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        fwd_mod.flash_fwd(q, k, v, causal=True, sm_scale=0.125)
    segs = tuple(torch.zeros((1, 16), dtype=torch.int32) for _ in range(4))
    lse = torch.zeros((1, 2, 16))
    kw = dict(causal=True, sm_scale=0.125, segs=segs)
    with pytest.raises(ValueError, match="CUDA"):
        fwd_mod.flash_fwd(q, k, v, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq(q, k, v, q, lse, lse, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv(q, k, v, q, lse, lse, **kw)


@pytest.mark.parametrize("causal,window,want", [
    (False, None, None), (True, None, (None, 0)), (True, (4, 2), (4, 0)),
    (False, (-1, 3), (None, 3)), (False, (-1, -1), None),
])
def test_normalize_band_matches_jax(causal, window, want):
    from flash_attention_tpu.ops.flash_fwd import normalize_band as jax_nb
    assert fwd_mod.normalize_band(causal, window) == want
    assert jax_nb(causal, window) == want


@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_jax(causal):
    """d 96 runs on the card zero-padded to 128: the helper around the plain
    versions, at the real d's scale, against JAX's fwd and bwd (interpret
    mode). d 256 (Gemma-2-9B's) runs as it is; above 256 raises on the card
    (``test_torch_head_dim_256.py``)."""
    assert [kernel_head_dim(d) for d in (32, 64, 80, 96, 128, 256)] == [
        64, 64, 128, 128, 128, 256]
    with pytest.raises(NotImplementedError, match="512"):
        kernel_head_dim(512)
    q, k, v = _qkv(96, 1, 16, 16, 2, 1, 96)
    do = _qkv(97, 1, 16, 16, 2, 1, 96)[0]
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, sm_scale=96**-0.5)
    o, lse = padded_head_dim(lambda *x: reference_attention(*x, **kw), 128,
                             qt, kt, vt)
    grads = padded_head_dim(lambda *x: flash_bwd_reference(*x, **kw), 128,
                            qt, kt, vt, o, lse, dot)
    qj, kj, vj, doj = map(jnp.asarray, (q, k, v, do))
    oj, lsej = fat.fwd(qj, kj, vj, is_causal=causal)
    want = fat.bwd(qj, kj, vj, oj, lsej, doj, is_causal=causal)
    assert o.shape == q.shape and lse.shape == (1, 2, 16)
    assert_metrics("o[d96]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics("lse[d96]", lse.numpy(), np.asarray(lsej), LSE_TOLS)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.shape == ref.shape
        assert_metrics(f"{name}[d96]", got.numpy(), np.asarray(ref), BWD_TOLS)


@pytest.mark.parametrize("option", ["signature", "segment_ids",
                                    "block_sizes", "interpret"])
def test_flash_attention_takes_jax_arguments(option):
    """flash_attention's arguments are JAX's, in JAX's order (window_size is
    the ninth, segment_ids the sixth); an unported one at a value other
    than None raises NotImplementedError naming it."""
    q, k, v = map(torch.from_numpy, _qkv(8, 1, 16, 16, 2, 1, 64))
    if option == "signature":
        assert list(inspect.signature(flash_attention).parameters) == list(
            inspect.signature(fat.flash_attention).parameters)
        o = flash_attention(q, k, v, True, None, None, None, None, (4, 0))
        want, _ = reference_attention(q, k, v, causal=True, window=(4, 0))
        assert torch.equal(o, want)
        return
    if option == "segment_ids":
        # two packed segments: each attends causally within itself
        seg = torch.tensor([[0] * 6 + [1] * 10])
        o = flash_attention(q, k, v, True, None,
                            SegmentIds(seg, seg))
        pos = torch.tensor([list(range(6)) + list(range(10))])
        want, _ = reference_attention(q, k, v, causal=True,
                                      q_segment_ids=seg, kv_segment_ids=seg,
                                      q_positions=pos, kv_positions=pos)
        assert torch.equal(o, want)
        return
    with pytest.raises(NotImplementedError, match=option):
        flash_attention(q, k, v, **{option: True})
