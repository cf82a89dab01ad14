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


@pytest.mark.parametrize("window,softcap", [(40, None), (40, 50.0),
                                            (None, 50.0)])
def test_paged_window_and_softcap_match_jax(window, softcap):
    """The window and the softcap against JAX's kernel. On the port's side
    every page that holds no token a row reads is NaN, and the entries of
    pages wholly behind a row's window are holes (-1): masked tokens must
    contribute exactly 0, so the output is finite and equal to JAX's on the
    real pages."""
    hk, group = 2, 2
    q, kp, vp, tab = _setup(31, 4, hk * group, hk)
    lens = np.asarray([1, PAGES_PER_SEQ * PAGE_SIZE, 41, 77], np.int32)
    oj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(lens), jnp.asarray(tab), window=window,
                   softcap=softcap, layer=1)
    read = np.zeros(TOTAL, bool)
    tab_t = tab.copy()
    for i, n in enumerate(lens):
        start = max(n - window, 0) if window else 0
        for j in range(PAGES_PER_SEQ):
            if (j + 1) * PAGE_SIZE <= start:
                tab_t[i, j] = -1
            elif j * PAGE_SIZE < n:
                read[tab[i, j]] = True
    kp_t, vp_t = kp.copy(), vp.copy()
    kp_t[:, :, ~read] = np.nan
    vp_t[:, :, ~read] = np.nan
    assert (tab_t < 0).any() == (window is not None)
    o = paged_attention(torch.from_numpy(q), torch.from_numpy(kp_t),
                        torch.from_numpy(vp_t), torch.from_numpy(lens),
                        torch.from_numpy(tab_t), window=window,
                        softcap=softcap, layer=1)
    assert_metrics(f"paged[w{window},cap{softcap}]", o.numpy(),
                   np.asarray(oj), FWD_TOLS)


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


def _chunk_tokens(length, pps, ps, chunk_tiles, n_chunks, window=None):
    """The tokens each chunk of the kernel reads for a row of ``length``
    (csrc/paged_attention.cu: the chunks start at the tile of the window's
    first token, or at 0; a chunk starting past the length exits; the
    others take min(chunk_tiles, the tiles left) 64-token tiles, masked by
    the window and the length), and the number of chunks that run."""
    tile = pa_mod.TILE
    n = min(length, pps * ps)
    if n <= 0:
        return [], 0
    start = max(n - window, 0) if window else 0
    tile0 = start // tile
    seen, live = [], 0
    for c in range(n_chunks):
        t0 = (tile0 + c * chunk_tiles) * tile
        if t0 >= n:
            continue
        live += 1
        tiles = min(chunk_tiles, -(-(n - t0) // tile))
        seen += [t for t in range(t0, t0 + tiles * tile) if start <= t < n]
    # the kernel's n_live
    assert live == -(-(-(-n // tile) - tile0) // chunk_tiles)
    return seen, live


@pytest.mark.parametrize("pps,ps", [(64, 64), (256, 16), (32, 128), (1, 8),
                                    (7, 24), (2048, 64), (0, 64), (3, 1)])
@pytest.mark.parametrize("b,hk", [(1, 1), (8, 8), (64, 8), (1, 32)])
@pytest.mark.parametrize("n_sms", [132, 114, 1])
def test_paged_plan_covers_every_page(pps, ps, b, hk, n_sms):
    """The chunks cover the table's every token, none starts past a full
    row, and there are at most MAX_CHUNKS a pair."""
    chunk_tiles, n_chunks = pa_mod.plan(pps, ps, b, hk, n_sms)
    span = chunk_tiles * pa_mod.TILE
    assert chunk_tiles >= 1 and 1 <= n_chunks <= pa_mod.MAX_CHUNKS
    assert n_chunks * span >= pps * ps
    assert (n_chunks - 1) * span < max(1, pps * ps)
    if pps * ps >= pa_mod.MIN_CHUNK_TILES * pa_mod.TILE:
        assert chunk_tiles >= pa_mod.MIN_CHUNK_TILES or n_chunks == 1


def test_paged_plan_reads_shapes_only():
    """The plan takes the shapes and the SM count, as Python ints, and no
    tensor: the same plan serves every set of lengths, each token of each
    row read exactly once and lengths past the table clamped."""
    import inspect
    assert list(inspect.signature(pa_mod.plan).parameters) == [
        "pages_per_seq", "page_size", "b", "hk", "n_sms", "window"]
    pps, ps = 64, 64
    plan = pa_mod.plan(pps, ps, 8, 8, 132)
    assert plan == (4, 16)  # Llama-3-8B's decode at b 8 on an H100
    rng = np.random.default_rng(0)
    lengths = [0, -3, 1, 63, 64, 65, 255, 256, 257, 4095, 4096, 4097, 10**6]
    for n in lengths + rng.integers(1, 4200, 50).tolist():
        seen, live = _chunk_tokens(n, pps, ps, *plan)
        assert seen == list(range(min(max(n, 0), pps * ps)))
        assert live <= plan[1]


@pytest.mark.parametrize("window", [1, 63, 64, 65, 100, 4096])
@pytest.mark.parametrize("pps,ps", [(128, 64), (64, 16), (3, 8)])
def test_paged_plan_covers_the_window(window, pps, ps):
    """With a sliding window the chunks start at the tile of the window's
    first token and cover ceil(W / 64) + 1 tiles (or the table): every row
    reads exactly its window's tokens, and the plan depends on W, never on
    the lengths."""
    plan = pa_mod.plan(pps, ps, 8, 8, 132, window)
    tiles = min(-(-pps * ps // pa_mod.TILE), -(-window // pa_mod.TILE) + 1)
    assert plan[0] * plan[1] >= tiles
    rng = np.random.default_rng(window)
    for n in [1, window - 1, window, window + 1, pps * ps, pps * ps + 5] + \
            rng.integers(1, pps * ps + 1, 30).tolist():
        seen, live = _chunk_tokens(n, pps, ps, *plan, window=window)
        m = min(max(n, 0), pps * ps)
        assert seen == list(range(max(m - window, 0), m)), n
        assert live <= plan[1]
