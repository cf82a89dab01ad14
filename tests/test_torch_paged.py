"""The port's paged attention and in-place KV write against the JAX
package's, on the CPU, on a layer-stacked 5D cache.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
Pallas kernels in interpret mode, the port its plain versions. Tolerances:
fp32 on both sides, the repo's forward gates (atol 5e-3, mean_atol 2e-4,
mean_rtol 1e-2); the KV write must match exactly on every page but the trash
page, which the engine's padding rows share.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax.numpy as jnp

from flash_attention_tpu.ops.kv_update import write_token_kv as jax_write
from flash_attention_tpu.ops.paged_attention import \
    paged_attention as jax_paged
from flash_attention_tpu.utils.metrics import assert_metrics
from flash_attention_tpu_torch import paged_attention, write_token_kv
from flash_attention_tpu_torch.ops import kv_update
from flash_attention_tpu_torch.ops import paged_attention as pa_mod

torch.set_num_threads(2)

FWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
PAGE_SIZE, PAGES_PER_SEQ, TOTAL, LAYERS = 16, 8, 40, 3


def _setup(seed, b, h, hk, d=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    shape = (LAYERS, hk, TOTAL, PAGE_SIZE, d)
    kp = rng.standard_normal(shape, dtype=np.float32)
    vp = rng.standard_normal(shape, dtype=np.float32)
    tab = rng.permutation(TOTAL)[:b * PAGES_PER_SEQ].reshape(
        b, PAGES_PER_SEQ).astype(np.int32)
    return q, kp, vp, tab


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("layer", [0, 2])
def test_paged_attention_matches_jax(group, layer):
    hk = 2
    q, kp, vp, tab = _setup(group * 10 + layer, 4, hk * group, hk)
    # length 1, a full table (8 pages x 16), a page edge, and a ragged row
    lens = np.asarray([1, PAGES_PER_SEQ * PAGE_SIZE, 32, 77], np.int32)
    o = paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                        torch.from_numpy(vp), torch.from_numpy(lens),
                        torch.from_numpy(tab), layer=layer)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab), layer=layer)
    assert o.shape == (4, hk * group, 128)
    assert_metrics(f"paged[g{group},L{layer}]", o.numpy(), np.asarray(oj),
                   FWD_TOLS)


def test_paged_attention_zero_length_rows_are_zero():
    q, kp, vp, tab = _setup(7, 3, 4, 2)
    lens = np.asarray([0, 64, 128], np.int32)
    o = paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                        torch.from_numpy(vp), torch.from_numpy(lens),
                        torch.from_numpy(tab), layer=1)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab), layer=1)
    assert torch.all(o[0] == 0)
    assert_metrics("paged[zero-len]", o.numpy(), np.asarray(oj), FWD_TOLS)


def test_paged_attention_rejects_bad_layer_use():
    q, kp, vp, tab = map(torch.from_numpy, _setup(8, 2, 4, 2))
    lens = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, lens, tab)            # 5D needs a layer
    with pytest.raises(ValueError):
        paged_attention(q, kp[0], vp[0], lens, tab, layer=0)


def test_kernel_paths_never_fall_back():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device goes to the kernel wrapper, which raises where it cannot launch
    (here a ``meta`` tensor stands in for a device without the kernel)."""
    q, kp, vp, tab = (torch.from_numpy(x).bfloat16().to("meta")
                      for x in _setup(8, 2, 4, 2))
    lens = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_attention(q, kp, vp, lens, tab.int(), layer=0)
    with pytest.raises(ValueError, match="CUDA"):
        kv_update.write_token_kv(kp, vp, None, None, q[:, :2], q[:, :2], None,
                                 None, lens, lens, layer=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_write_token_kv_matches_jax(quantized):
    rng = np.random.default_rng(int(quantized))
    L, hk, d, b = LAYERS, 2, 128, 5
    trash = TOTAL - 1
    wpage = np.asarray([3, 11, 3, trash, trash], np.int32)
    woff = np.asarray([0, 15, 9, 0, 0], np.int32)
    shape = (L, hk, TOTAL, PAGE_SIZE, d)
    if quantized:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        kval = rng.integers(-127, 128, (b, hk, d)).astype(np.int8)
        vval = rng.integers(-127, 128, (b, hk, d)).astype(np.int8)
        ks = rng.random((L, hk, TOTAL, 8, 128), dtype=np.float32)
        vs = rng.random((L, hk, TOTAL, 8, 128), dtype=np.float32)
        ksc = rng.random((b, hk), dtype=np.float32)
        vsc = rng.random((b, hk), dtype=np.float32)
    else:
        kp = rng.standard_normal(shape, dtype=np.float32)
        vp = rng.standard_normal(shape, dtype=np.float32)
        kval = rng.standard_normal((b, hk, d), dtype=np.float32)
        vval = rng.standard_normal((b, hk, d), dtype=np.float32)
        ks = vs = ksc = vsc = None

    def t(x):
        return None if x is None else torch.from_numpy(x.copy())

    def j(x):
        return None if x is None else jnp.asarray(x)

    args_t = [t(x) for x in (kp, vp, ks, vs, kval, vval, ksc, vsc, wpage, woff)]
    out_t = write_token_kv(*args_t, layer=1)
    assert out_t[0] is args_t[0] and out_t[1] is args_t[1]  # in place
    out_j = jax_write(*[j(x) for x in (kp, vp, ks, vs, kval, vval, ksc, vsc,
                                       wpage, woff)],
                      layer=jnp.int32(1))
    keep = np.arange(TOTAL) != trash
    for a, bj in zip(out_t, out_j):
        if a is None:
            assert bj is None
            continue
        np.testing.assert_array_equal(a.numpy()[:, :, keep],
                                      np.asarray(bj)[:, :, keep])
    assert not np.array_equal(out_t[0].numpy(), kp)  # something was written
