"""Long K/V in the port: ``merge_partials`` and the KV split of ``fwd`` and
``flash_attention``, against the JAX package's on the CPU.

Above ``KV_SPLIT`` keys a dense forward (causal, a right window, or none)
runs one launch per chunk of keys and merges the chunks' (O, LSE); a left
window bound never splits. ``kv_split`` (and, for ``flash_attention``, the
module's ``KV_SPLIT``) is forced down to 64 so four chunks run at 256 keys.
The JAX side runs its Pallas kernel in interpret mode, the port its plain
version per chunk (each chunk is a kernel launch on the card).

Gates: fp32 on both sides, the repo's forward gates (atol 5e-3, mean_atol
2e-4, mean_rtol 1e-2) for O and the gradients, the LSE gates of
``tests/test_flash_fwd.py:21``. The port holds the running O in fp32 across
the merges where JAX rounds it to the input dtype after each: in bf16 its
error against the float64 oracle must be no larger than JAX's, in max and
in mean (``test_split_meets_the_oracle_as_jax``).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

import flash_attention_tpu as jfat
from flash_attention_tpu.ops import attention as jattn
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import flash_attention, fwd, merge_partials
from flash_attention_tpu_torch.ops import attention as tattn
from flash_attention_tpu_torch.ops.reference import reference_attention

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}
SPLIT = 64


def _qkv(seed, sq, sk, h=2, hk=1, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, sq, h, d), dtype=np.float32),
            rng.standard_normal((1, sk, hk, d), dtype=np.float32),
            rng.standard_normal((1, sk, hk, d), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_partials_matches_jax(dtype):
    """Rows dead in one partial weigh it 0; rows dead in both keep LSE
    -inf and O 0, with no NaN; the rest equal JAX's merge (O in the forward
    gates, LSE to 1e-6 relative)."""
    rng = np.random.default_rng(1)
    b, sq, h, d = 2, 8, 3, 16
    o1, o2 = (rng.standard_normal((b, sq, h, d), dtype=np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((b, h, sq), dtype=np.float32)
              for _ in range(2))
    l1[:, :, :2] = -np.inf          # rows 0-1 dead in the first partial
    l2[:, :, 1:4] = -np.inf         # rows 1-3 dead in the second: row 1 both
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    o, lse = merge_partials(torch.from_numpy(o1).to(tt), torch.from_numpy(l1),
                            torch.from_numpy(o2).to(tt), torch.from_numpy(l2))
    oj, lj = jattn.merge_partials(jnp.asarray(o1, jt), jnp.asarray(l1),
                                  jnp.asarray(o2, jt), jnp.asarray(l2))
    assert o.dtype == tt and lse.dtype == torch.float32
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    assert torch.all(torch.isneginf(lse[:, :, 1]))
    assert torch.all(o[:, 1] == 0)
    # the same dead rows; live LSEs to fp32 rounding (log and exp differ
    # by an ulp between the libraries)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(np.asarray(lj)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lj), rtol=1e-6)
    assert_metrics(f"merge o[{dtype}]", o.float().numpy(),
                   np.asarray(oj, np.float32), FWD_TOLS)
    # a row dead in one partial is the other partial as it was
    np.testing.assert_array_equal(o[:, 0].float().numpy(),
                                  torch.from_numpy(o2).to(tt)[:, 0]
                                  .float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_merge_in_place_equals_merge_partials(dtype):
    """The split's in-place merge of the running fp32 O with a chunk's O
    (fp32 or bf16, as the kernel gives it) is ``merge_partials`` bit for
    bit, dead rows included."""
    rng = np.random.default_rng(2)
    b, sq, h, d = 2, 8, 3, 16
    o1 = torch.from_numpy(rng.standard_normal((b, sq, h, d),
                                              dtype=np.float32))
    o2 = torch.from_numpy(rng.standard_normal((b, sq, h, d),
                                              dtype=np.float32)).to(
        getattr(torch, dtype))
    l1, l2 = (rng.standard_normal((b, h, sq), dtype=np.float32)
              for _ in range(2))
    l1[:, :, :2] = -np.inf
    l2[:, :, 1:4] = -np.inf
    l1, l2 = torch.from_numpy(l1), torch.from_numpy(l2)
    want = merge_partials(o1, l1, o2, l2)
    o2_before = o2.clone()
    running = o1.clone()
    got = tattn._merge_into(running, l1, o2, l2)
    assert got[0] is running  # updated in place
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if dtype == "bfloat16":
        assert torch.equal(o2, o2_before)  # the chunk's bf16 O is untouched


# (sq, sk, causal, window): square causal (four chunks, the first three
# non-causal with chunk-local right bounds), a right window, sq > sk causal
# (the top rows dead in every chunk: O = 0, LSE = empty_lse), and a left
# window, which never splits
CASES = {
    "causal": (256, 256, True, None),
    "right_window": (200, 256, False, (-1, 32)),
    "causal_sq_gt_sk": (320, 256, True, None),
    "left_window": (256, 256, True, (32, 0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fwd_kv_split_matches_jax(name):
    sq, sk, causal, window = CASES[name]
    q, k, v = _qkv(sq + sk, sq, sk)
    calls = []
    orig = tattn._fwd_split

    def logged(*a, **kw):
        calls.append(a[3])
        return orig(*a, **kw)
    tattn._fwd_split = logged
    try:
        o, lse = fwd(*map(torch.from_numpy, (q, k, v)), causal,
                     window_size=window, kv_split=SPLIT, empty_lse=0.5)
    finally:
        tattn._fwd_split = orig
    oj, lj = jfat.fwd(*map(jnp.asarray, (q, k, v)), causal,
                      window_size=window, kv_split=SPLIT, empty_lse=0.5)
    assert_metrics(f"o[{name}]", o.numpy(), np.asarray(oj), FWD_TOLS)
    assert_metrics(f"lse[{name}]", lse.numpy(), np.asarray(lj), LSE_TOLS)
    one_o, one_lse = fwd(*map(torch.from_numpy, (q, k, v)), causal,
                         window_size=window, empty_lse=0.5)
    if name == "left_window":
        assert calls == []  # no split: the one call as it was
        assert torch.equal(o, one_o) and torch.equal(lse, one_lse)
        return
    assert calls == [SPLIT]
    assert_metrics(f"o[{name} vs one launch]", o.numpy(), one_o.numpy(),
                   FWD_TOLS)
    if name == "causal_sq_gt_sk":
        dead = sq - sk
        assert torch.all(o[:, :dead] == 0) and torch.all(lse[:, :, :dead]
                                                          == 0.5)
    assert torch.isfinite(lse).all() and torch.isfinite(o).all()


def test_split_meets_the_oracle_as_jax():
    """bf16, causal, four chunks: each chunk's O is rounded to bf16 (the
    kernel's output) on both sides; the port's fp32 running merge must be
    at least as close to the float64 oracle as JAX's merge, which rounds O
    to bf16 after every merge."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(7, 256, 256))
    o, _ = fwd(q, k, v, True, kv_split=SPLIT)
    oj, _ = jfat.fwd(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v)), True, kv_split=SPLIT)
    ref, _ = reference_attention(q.double(), k.double(), v.double(),
                                 causal=True)
    err = (o.double() - ref).abs()
    err_j = (torch.from_numpy(np.asarray(oj, np.float32)).double()
             - ref).abs()
    assert err.max() <= err_j.max(), (float(err.max()), float(err_j.max()))
    assert err.mean() <= err_j.mean(), (float(err.mean()),
                                        float(err_j.mean()))


def test_flash_attention_grads_with_split(monkeypatch):
    """``flash_attention`` above the split (both packages' KV_SPLIT set to
    64): the autograd forward runs the chunks, the backward consumes (o,
    lse) as they are, and O and the gradients equal JAX's."""
    monkeypatch.setattr(tattn, "KV_SPLIT", SPLIT)
    monkeypatch.setattr(jattn, "KV_SPLIT", SPLIT)
    q, k, v = _qkv(3, 192, 256)
    do = np.random.default_rng(4).standard_normal(q.shape, dtype=np.float32)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    merges = []
    orig = tattn._merge_into  # the split's in-place merge_partials
    monkeypatch.setattr(tattn, "_merge_into",
                        lambda *a: merges.append(1) or orig(*a))
    o = flash_attention(qt, kt, vt, causal=True)
    o.backward(torch.from_numpy(do))
    assert len(merges) == 3  # four chunks

    def loss(q, k, v):
        return jnp.sum(jfat.flash_attention(q, k, v, causal=True)
                       * jnp.asarray(do))
    oj = jfat.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert_metrics("o[grad split]", o.detach().numpy(), np.asarray(oj),
                   FWD_TOLS)
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        assert_metrics(f"d{name}[split]", got.numpy(), np.asarray(want),
                       FWD_TOLS)
