"""Packed variable-length batches and segment ids in the port, against the
JAX package's, on the CPU.

``varlen_fwd``/``varlen_bwd``, ``fwd``/``bwd`` with ``segs`` and
``flash_attention`` with ``segment_ids`` run the plain segmented versions
here (the segmented kernels on the card, held to the same plain versions in
``test_torch_kernels.py``); the JAX side runs its segmented Pallas kernels
in interpret mode. Inputs come from numpy seeds, fp32 on both sides, so the
repo's forward and backward gates (atol 5e-3, mean_atol 2e-4, mean_rtol
1e-2) hold for O and the gradients, and ``tests/test_flash_fwd.py:21``'s
gates for the LSE. The block ranges must equal JAX's exactly, at the tiles
of the three segmented kernels. Cases mirror ``tests/test_varlen.py``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

import flash_attention_tpu as fj
from flash_attention_tpu.ops import segments as jseg
from flash_attention_tpu.ops.attention import _varlen_segs as jax_varlen_segs
from flash_attention_tpu.utils.metrics import assert_metrics
import flash_attention_tpu_torch as ft
from flash_attention_tpu_torch.ops import segments as tseg
from flash_attention_tpu_torch.ops.attention import _varlen_segs

torch.set_num_threads(2)

TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
LSE_TOLS = {"atol": 1e-2, "mean_atol": 1e-3, "mean_rtol": 1e-2}

# (owned, streamed) block rows of the segmented kernels' CTAs, as their
# fat_*_seg_tiles report them: the forward (d <= 128, d 256), dq (d <= 128,
# d 256) and dkv (d <= 128, d 256; owned = keys, streamed = query tiles)
FWD_TILES = [(128, 128), (128, 64)]
DQ_TILES = [(128, 64), (64, 64)]
DKV_TILES = [(128, 64), (64, 64)]


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _layouts():
    """name -> (q_seg, kv_seg, q_pos, kv_pos) numpy (1, 512): packed equal
    sequences; ragged ones with cu_q != cu_k (a length-1 sequence, len_q <
    len_k) and tail tokens past cu[-1]; an unsorted kv key (the full-range
    fallback); and a layout whose last query block holds only pads (an
    empty range)."""
    out = {}
    cu = _cu([128] * 4)
    out["packed"] = jax_varlen_segs(jnp.asarray(cu), jnp.asarray(cu), 512, 512)
    cu_q, cu_k = _cu([1, 200, 77, 130, 40]), _cu([5, 250, 77, 140, 39])
    out["ragged"] = jax_varlen_segs(jnp.asarray(cu_q), jnp.asarray(cu_k), 512,
                                    512)
    # a chunked-prefill kv layout: live prefix, dead prefix slots (pad id),
    # then the chunk: the key is not sorted
    pos = np.arange(512, dtype=np.int32)
    kv_seg = np.where(pos < 200, 0, -1)
    kv_seg[384:] = 0
    kv_pos = np.where(pos < 384, pos, 200 + pos - 384)
    q_pos = 200 + np.arange(512, dtype=np.int32) % 128
    q_seg = np.where(np.arange(512) < 128, 0, -2)
    out["unsorted"] = (q_seg[None], kv_seg[None], q_pos[None], kv_pos[None])
    cu = _cu([100, 60])
    out["pad-only block"] = jax_varlen_segs(jnp.asarray(cu), jnp.asarray(cu),
                                            512, 512)
    return {k: tuple(np.array(x, np.int32) for x in v)
            for k, v in out.items()}


LAYOUTS = _layouts()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_block_ranges_match_jax(layout, causal):
    """The port's ranges equal JAX's, int for int, at every segmented
    kernel's tiles, in both directions; the unsorted layout falls back to
    the full range and the pad-only block's range is empty."""
    q_seg, kv_seg, q_pos, kv_pos = LAYOUTS[layout]
    t = [torch.from_numpy(x) for x in (q_seg, kv_seg, q_pos, kv_pos)]
    cases = [(a, o, "kv_le_q") for a, o in FWD_TILES + DQ_TILES] + \
        [(a, o, "q_ge_kv") for a, o in DKV_TILES]
    for block_a, block_o, direction in cases:
        if direction == "kv_le_q":
            j_args, t_args = (q_seg, q_pos, kv_seg, kv_pos), \
                (t[0], t[2], t[1], t[3])
        else:
            j_args, t_args = (kv_seg, kv_pos, q_seg, q_pos), \
                (t[1], t[3], t[0], t[2])
        want = jseg.block_ranges(*map(jnp.asarray, j_args), block_a, block_o,
                                 causal=causal, causal_dir=direction)
        got = tseg.block_ranges(*t_args, block_a, block_o, causal=causal,
                                causal_dir=direction)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          f"{layout} {block_a}/{block_o}")
    lo, hi = tseg.block_ranges(t[0], t[2], t[1], t[3], 128, 64,
                               causal=causal, causal_dir="kv_le_q")
    if layout == "unsorted":
        assert lo.tolist() == [[0] * 4] and hi.tolist() == [[7] * 4]
    if layout == "pad-only block":
        assert int(lo[0, -1]) > int(hi[0, -1])


def test_block_ranges_of_a_partial_block():
    """A length that is not a multiple of the block counts its last partial
    block: the same ranges as JAX's on the layout padded with the pad
    sentinels, as JAX's callers pad it."""
    cu_q, cu_k = _cu([1, 200, 77]), _cu([5, 250, 77])
    segs = [np.array(x) for x in jax_varlen_segs(
        jnp.asarray(cu_q), jnp.asarray(cu_k), 278, 332)]
    padded = [np.pad(x, ((0, 0), (0, n - x.shape[1])), constant_values=v)
              for x, n, v in zip(segs, (384, 384, 384, 384),
                                 (tseg.Q_PAD_SEG, tseg.KV_PAD_SEG, 0, 0))]
    for causal in (False, True):
        want = jseg.block_ranges(*(jnp.asarray(padded[i]) for i in (0, 2, 1,
                                                                    3)),
                                 128, 64, causal=causal, causal_dir="kv_le_q")
        got = tseg.block_ranges(*(torch.from_numpy(segs[i]) for i in (0, 2, 1,
                                                                      3)),
                                128, 64, causal=causal, causal_dir="kv_le_q")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        # JAX's padded kv axis has 6 blocks, the port's 332 keys too
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _varlen_inputs(seed, lens_q, lens_k, h, hk, d):
    rng = np.random.default_rng(seed)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in
            ((tq, h, d), (tk, hk, d), (tk, hk, d), (tq, h, d))]
    return arrs, cu_q, cu_k


# ragged lengths straddling the kernels' 64- and 128-row tiles, with a
# length-1 sequence and len_q < len_k (the per-sequence lower-right shift)
RAGGED = ([1, 70, 130, 33], [1, 90, 130, 64])
SAME = ([1, 70, 130, 33], [1, 70, 130, 33])


def _check_varlen(tag, arrs, cu_q, cu_k, **kw):
    q, k, v, do = arrs
    tq = [torch.from_numpy(x) for x in arrs]
    o, lse = ft.varlen_fwd(*tq[:3], torch.from_numpy(cu_q),
                           torch.from_numpy(cu_k), **kw)
    grads = ft.varlen_bwd(*tq[:3], o, lse, tq[3], torch.from_numpy(cu_q),
                          torch.from_numpy(cu_k), **kw)
    jq = [jnp.asarray(x) for x in arrs]
    oj, lsej = fj.varlen_fwd(*jq[:3], jnp.asarray(cu_q), jnp.asarray(cu_k),
                             **kw)
    gj = fj.varlen_bwd(*jq[:3], oj, lsej, jq[3], jnp.asarray(cu_q),
                       jnp.asarray(cu_k), **kw)
    assert o.shape == q.shape and lse.shape == (q.shape[1], q.shape[0])
    assert_metrics(f"o[{tag}]", o.numpy(), np.asarray(oj), TOLS)
    assert_metrics(f"lse[{tag}]", lse.numpy(), np.asarray(lsej), LSE_TOLS)
    for name, g, w in zip(("dq", "dk", "dv"), grads, gj):
        assert_metrics(f"{name}[{tag}]", g.numpy(), np.asarray(w), TOLS)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lens", ["same", "ragged"])
@pytest.mark.parametrize("h,hk", [(2, 1), (6, 3), (6, 1)])
def test_varlen_matches_jax(h, hk, lens, causal):
    lens_q, lens_k = SAME if lens == "same" else RAGGED
    arrs, cu_q, cu_k = _varlen_inputs(h * 10 + hk, lens_q, lens_k, h, hk, 64)
    _check_varlen(f"{h}/{hk} {lens} causal={causal}", arrs, cu_q, cu_k,
                  is_causal=causal)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, (15, 0), None), (False, (8, 4), None), (True, None, 5.0),
    (True, (31, 0), 20.0)])
def test_varlen_window_softcap_match_jax(causal, window, softcap):
    """The window over within-sequence positions, the softcap, and both,
    composed with the segment mask."""
    arrs, cu_q, cu_k = _varlen_inputs(3, *RAGGED, 4, 2, 64)
    _check_varlen(f"window={window} softcap={softcap}", arrs, cu_q, cu_k,
                  is_causal=causal, window_size=window, softcap=softcap)


def test_flash_attention_segment_ids_matches_jax():
    """flash_attention(segment_ids=...) at b 2: outputs, and gradients
    through .backward() against jax.grad of JAX's flash_attention."""
    rng = np.random.default_rng(5)
    b, s, h, hk, d = 2, 150, 4, 2, 64
    q, k, v, do = (rng.standard_normal(sh, dtype=np.float32) for sh in
                   ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)))
    seg = np.zeros((b, s), np.int32)
    seg[0, 40:] = 1
    seg[0, 110:] = 2
    seg[1, 1:] = 1  # a one-token segment first
    for causal in (False, True):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        ids = ft.SegmentIds(torch.from_numpy(seg), torch.from_numpy(seg))
        o = ft.flash_attention(*leaves, causal=causal, segment_ids=ids)
        o.backward(torch.from_numpy(do))
        jids = fj.SegmentIds(jnp.asarray(seg), jnp.asarray(seg))

        def loss(a, b_, c):
            return jnp.sum(fj.flash_attention(a, b_, c, causal=causal,
                                              segment_ids=jids)
                           * jnp.asarray(do))
        oj = fj.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                segment_ids=jids)
        gj = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        assert_metrics(f"o[causal={causal}]", o.detach().numpy(),
                       np.asarray(oj), TOLS)
        for name, x, w in zip(("dq", "dk", "dv"), leaves, gj):
            assert_metrics(f"{name}[causal={causal}]", x.grad.numpy(),
                           np.asarray(w), TOLS)


def test_fwd_segs_rows_without_keys():
    """fwd(segs=...) with query rows whose segment has no key (and pad
    ids): O = 0 and LSE = empty_lse there, the rest as JAX's; bwd gives
    dq = 0 there and dk = dv = 0 for keys no query sees."""
    rng = np.random.default_rng(9)
    b, sq, sk, h, hk, d = 2, 96, 80, 4, 2, 64
    q, do = (rng.standard_normal((b, sq, h, d), dtype=np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hk, d), dtype=np.float32)
            for _ in range(2))
    q_seg = np.repeat(np.array([[0, 1, 2]]), 32, axis=1).repeat(b, 0)
    kv_seg = np.repeat(np.array([[0, 1, 3, 4]]), 20, axis=1).repeat(b, 0)
    q_seg[1, -10:] = tseg.Q_PAD_SEG
    q_pos = np.tile(np.arange(32), 3)[None].repeat(b, 0) + 10
    kv_pos = np.tile(np.arange(20), 4)[None].repeat(b, 0)
    segs = [x.astype(np.int32) for x in (q_seg, kv_seg, q_pos, kv_pos)]
    tq = [torch.from_numpy(x) for x in (q, k, v, do)]
    for causal in (False, True):
        o, lse = ft.fwd(*tq[:3], causal, segs=tuple(map(torch.from_numpy,
                                                        segs)),
                        empty_lse=-1.0)
        oj, lsej = fj.fwd(*map(jnp.asarray, (q, k, v)), is_causal=causal,
                          segs=tuple(map(jnp.asarray, segs)), empty_lse=-1.0)
        dead = torch.from_numpy((q_seg == 2) | (q_seg < 0))
        assert torch.all(o[dead] == 0)
        assert torch.all(lse.transpose(1, 2)[dead] == -1.0)
        assert_metrics("o[no key]", o.numpy(), np.asarray(oj), TOLS)
        assert_metrics("lse[no key]", lse.numpy(), np.asarray(lsej), LSE_TOLS)
        dq, dk, dv = ft.bwd(*tq[:3], o, lse, tq[3], causal,
                            segs=tuple(map(torch.from_numpy, segs)))
        gj = fj.bwd(*map(jnp.asarray, (q, k, v)), oj, lsej, jnp.asarray(do),
                    is_causal=causal, segs=tuple(map(jnp.asarray, segs)))
        assert torch.all(dq[dead] == 0)
        unseen = torch.from_numpy(kv_seg >= 3)
        assert torch.all(dk[unseen] == 0) and torch.all(dv[unseen] == 0)
        for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), gj):
            assert_metrics(f"{name}[no key]", g.numpy(), np.asarray(w), TOLS)


def test_varlen_tail_tokens():
    """Tokens past cu_seqlens[-1] in the packed buffers: the port gives the
    query tail the query pad id (-2), so a tail row sees no key (O = 0, LSE
    = 0) and the key tail gets dK = dV = 0; every row before the tail
    equals JAX's (whose tail rows depend on its tiling and are not
    compared)."""
    lens_q, lens_k = [30, 50], [40, 50]
    arrs, cu_q, cu_k = _varlen_inputs(12, lens_q + [20], lens_k + [25], 4, 2,
                                      64)
    cu_q, cu_k = cu_q[:-1], cu_k[:-1]  # the last 20 / 25 tokens are a tail
    q_seg, kv_seg, _, _ = _varlen_segs(torch.from_numpy(cu_q),
                                       torch.from_numpy(cu_k), 100, 115)
    assert q_seg[0, 80:].eq(tseg.Q_PAD_SEG).all()
    assert kv_seg[0, 90:].eq(tseg.KV_PAD_SEG).all()
    tq = [torch.from_numpy(x) for x in arrs]
    for causal in (False, True):
        kw = dict(is_causal=causal)
        o, lse = ft.varlen_fwd(*tq[:3], cu_q, cu_k, **kw)
        dq, dk, dv = ft.varlen_bwd(*tq[:3], o, lse, tq[3], cu_q, cu_k, **kw)
        assert torch.all(o[80:] == 0) and torch.all(lse[:, 80:] == 0)
        assert torch.all(dq[80:] == 0)
        assert torch.all(dk[90:] == 0) and torch.all(dv[90:] == 0)
        jq = [jnp.asarray(x) for x in arrs]
        oj, lsej = fj.varlen_fwd(*jq[:3], jnp.asarray(cu_q),
                                 jnp.asarray(cu_k), **kw)
        gj = fj.varlen_bwd(*jq[:3], oj, lsej, jq[3], jnp.asarray(cu_q),
                           jnp.asarray(cu_k), **kw)
        assert_metrics("o[before the tail]", o[:80].numpy(),
                       np.asarray(oj)[:80], TOLS)
        assert_metrics("lse[before the tail]", lse[:, :80].numpy(),
                       np.asarray(lsej)[:, :80], LSE_TOLS)
        assert_metrics("dq[before the tail]", dq[:80].numpy(),
                       np.asarray(gj[0])[:80], TOLS)

