"""The d-384/512 dQ kernel's order of summation, on the CPU: no card and no
CUDA call.

The wide dQ kernel (``csrc/flash_bwd_dq_pair.cu``, where the band's left
side is open and there is no softcap; ``ops/flash_bwd.py::dq_wide_pair``
routes the rest to ``csrc/flash_bwd_dq_wide.cu``) runs a pair of CTAs a
(batch, head, 64-row query block): the S-CTA forms S and P from Q and K,
the dP-CTA dP from dO and V, the S-CTA dS = P (dP - D), rounded once to
the input type, and each CTA accumulates one column half of dQ, tile by
32-row kv tile, from dS and that half of K's columns. A plain model of
that order of summation is held here to the port's plain ``dq_reference``
and to the JAX package's ``bwd`` (Pallas in interpret mode) at the repo's
fp32 backward gates (``tests/test_flash_bwd.py:19``: atol 5e-3, mean_atol
2e-4, mean_rtol 1e-2).
"""

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.ops import flash_bwd as fb
from flash_attention_tpu_torch.ops import flash_fwd as fm
from flash_attention_tpu_torch.ops.reference import _build_mask

BWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
# the dQ pair's tiles (csrc/flash_bwd_dq_pair.cu, fat_flash_bwd_dq_pair_seg_
# tiles): query rows a pair owns, kv rows a streamed tile holds
DQ_ROWS, DQ_KEYS = 64, 32


@pytest.mark.parametrize("causal,window,softcap,pair", [
    (True, None, None, True), (False, None, None, True),
    (True, (-1, 0), None, True), (False, (-1, -1), None, True),
    (True, (127, 0), None, False), (False, (40, 7), None, False),
    (True, None, 5.0, False), (False, None, 30.0, False),
    (True, (4095, 0), 50.0, False)])
def test_dq_wide_pair_routing(causal, window, softcap, pair):
    """A d-384/512 dq launch takes the pair where the band's left side is
    open and there is no softcap (rows of many kv tiles, P cheap), else the
    one-CTA kernel: a function of the band and the softcap alone."""
    assert fb.dq_wide_pair(causal, window, softcap) is pair
    want = "fat_flash_bwd_dq_" + ("pair" if pair else "wide")
    assert fb._entry(fb.DQ_KERNEL, 512, pair) == want
    assert fb._entry(fb.DQ_KERNEL, 128, pair) == "fat_flash_bwd_dq"
    assert want in fb.DQ_KERNEL.argtypes
    assert want + "_seg_tiles" in fb.DQ_KERNEL.argtypes


def _dq_pair(q, k, v, do, lse, di, *, causal, sm_scale, window):
    """dQ as the pair computes it, in float32: P on the S-CTA's side
    (masked), dP on the dP-CTA's, dS = P (dP - D) formed once on the
    S-CTA's side and rounded to the input type, and each column half of dQ
    summed over the 32-row kv tiles in order, then scaled. q, do (b, sq, h,
    d); k, v (b, sk, hk, d); lse, di (b, h, sq)."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    qf, dof = (x.float().transpose(1, 2) for x in (q, do))
    kf, vf = (x.float().repeat_interleave(group, 2).transpose(1, 2)
              for x in (k, v))
    mask = _build_mask(sq, sk, causal, window, device=q.device)
    halves = (slice(0, d // 2), slice(d // 2, d))
    acc = [torch.zeros((b, h, sq, d // 2)) for _ in halves]
    for n0 in range(0, sk, DQ_KEYS):
        keys = slice(n0, min(n0 + DQ_KEYS, sk))
        s = qf @ kf[:, :, keys].transpose(-1, -2) * sm_scale
        p = torch.exp(s - lse.float()[..., None])
        if mask is not None:
            p = p.masked_fill(~mask[:, keys], 0.0)
        dp = dof @ vf[:, :, keys].transpose(-1, -2)
        ds = (p * (dp - di.float()[..., None])).to(q.dtype).float()
        for a, cols in zip(acc, halves):
            a += ds @ kf[:, :, keys, cols]
    return (torch.cat(acc, -1) * sm_scale).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_pair_order_matches_the_plain_version(causal, dtype):
    """b1 sq200 sk170 h4/1 d384 (a ragged last kv tile and query block, the
    band's lower-right offset): the pair's order against the plain
    dq_reference (one float64 product). fp32 inputs agree to fp32
    rounding; bf16 inputs, where both round dS to bf16 (from fp32 and
    float64 sums, so a few elements round the other way), meet the bf16
    backward gates the card tests hold the kernel to."""
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    b, sq, sk, h, d = 1, 200, 170, 4, 384
    rng = np.random.default_rng(7 + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(x, dtype=np.float32))
                   .to(dtype)
                   for x in ((b, sq, h, d), (b, sk, 1, d), (b, sk, 1, d),
                             (b, sq, h, d)))
    kw = dict(causal=causal, sm_scale=d**-0.5, window=None)
    o, lse = fm.flash_fwd_segmented_reference(
        q, k, v, (torch.zeros((b, sq)), torch.zeros((b, sk)),
                  torch.arange(sq)[None], torch.arange(sk)[None] + sq - sk),
        causal=causal, sm_scale=d**-0.5)
    di = fb.di_reference(o, do)
    got = _dq_pair(q, k, v, do, lse, di, **kw)
    want = fb.dq_reference(q, k, v, do, lse, di, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert_metrics(f"dq[pair order, causal={causal}]", got, want,
                       {"atol": 4e-2, "mean_atol": 2e-3, "mean_rtol": 2e-1})


@pytest.mark.parametrize("window", [None, (127, 0)], ids=["causal", "window"])
def test_dq_pair_order_matches_jax(window):
    """b1 s256 h8/1 d384, causal and windowed (127, 0): dQ summed in the
    pair's order (two column halves, 32-row kv tiles, dS formed once)
    against JAX's bwd, and against the port's plain dq_reference (float64,
    one product) to the fp32 rounding of the order."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import flash_attention_tpu as fat
    from flash_attention_tpu.utils.metrics import assert_metrics

    b, s, h, hk, d = 1, 256, 8, 1, 384
    rng = np.random.default_rng(386 + (window is None))
    q, k, v, do = (rng.standard_normal(x, dtype=np.float32)
                   for x in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                             (b, s, h, d)))

    @jax.jit
    def jax_side(qj, kj, vj, doj):
        o, lse = fat.fwd(qj, kj, vj, is_causal=True, window_size=window)
        return o, lse, fat.bwd(qj, kj, vj, o, lse, doj, is_causal=True,
                               window_size=window)

    o, lse, want = jax_side(*map(jnp.asarray, (q, k, v, do)))
    qt, kt, vt, ot, dot = (torch.from_numpy(np.array(x))
                           for x in (q, k, v, o, do))
    lse_t = torch.from_numpy(np.array(lse))
    di = fb.di_reference(ot, dot)
    kw = dict(causal=True, sm_scale=d**-0.5, window=window)
    dq = _dq_pair(qt, kt, vt, dot, lse_t, di, **kw)
    assert_metrics(f"dq[pair, window={window}]", dq.numpy(),
                   np.asarray(want[0]), BWD_TOLS)
    plain = fb.dq_reference(qt, kt, vt, dot, lse_t, di, **kw)
    torch.testing.assert_close(dq, plain, atol=2e-5, rtol=1e-4)
