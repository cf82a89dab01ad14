"""The wide dK/dV kernel's grid plan (``ops/flash_bwd.py::dkv_wide_plan``),
on the CPU: no card and no CUDA call.

At d 384 and 512 the dK/dV kernel (``csrc/flash_bwd_dkv_wide.cu``) runs one
cluster of two CTAs a unit, a block of 64 keys of one kv head and a range
of that head's query heads; a key block split into several ranges writes
fp32 partials that a second kernel sums in head-range order. The kernels
decode their unit from the cluster index and the shapes; the plan is the
model of that decode. These tests hold it to that contract: every (batch,
key block, query head) in exactly one unit, ranges ascending, the units in
the kernel's order, tiles counted as the kernel counts them, the balance at
the d-512 training shapes, window-128 blocks left whole. The
last test assembles dK and dV from per-range partials of the plain
``dkv_reference``, in the plan's order, and holds them to the JAX package's
``bwd`` (Pallas in interpret mode) at the repo's fp32 backward gates
(``tests/test_flash_bwd.py:19``: atol 5e-3, mean_atol 2e-4, mean_rtol
1e-2).
"""

import collections

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.ops import flash_bwd as fb
from flash_attention_tpu_torch.ops.reference import _build_mask

# the H100 SXM's co-resident two-CTA clusters of the kernel (132 SMs, one
# CTA each)
H100_CLUSTERS = 66
BWD_TOLS = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
# (b, sq, sk, hk, group, causal, window)
SHAPES = [
    (2, 2048, 2048, 1, 64, True, None),
    (1, 4096, 4096, 1, 64, True, None),
    (1, 2048, 2048, 1, 64, False, None),
    (1, 4096, 4096, 1, 64, True, (127, 0)),
    (2, 300, 513, 2, 8, True, None),
    (3, 513, 300, 4, 4, False, (40, 7)),
    (1, 1, 1, 1, 1, False, None),
]


def _plan(shape):
    return fb.dkv_wide_plan(*shape)


@pytest.mark.parametrize("ranges", [1, 3, fb.SPLIT_RANGES, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_head_once(shape, ranges, monkeypatch):
    """Every (batch, kv head, key block, query head) lies in exactly one
    unit; each block's ranges ascend and tile its group; a split block's
    slots run in head-range order and each slot is one unit's."""
    b, sq, sk, hk, group, causal, window = shape
    monkeypatch.setattr(fb, "SPLIT_RANGES", ranges)
    plan = _plan(shape)
    seen = collections.Counter()
    for bi, kv, n, h0, h1, _ in plan.units:
        seen.update((bi, kv, n, hd) for hd in range(h0, h1))
    blocks = -(-sk // fb.DKV_WIDE_KEYS)
    want = {(bi, kv, n, hd) for bi in range(b) for kv in range(hk)
            for n in range(blocks) for hd in range(group)}
    assert set(seen) == want and set(seen.values()) == {1}
    for bi in range(b):
        for kv in range(hk):
            for n, ranges in plan.head_ranges(bi, kv).items():
                assert ranges[0][0] == 0 and ranges[-1][1] == group
                assert all(a[1] == c[0] and a[0] < a[1]
                           for a, c in zip(ranges, ranges[1:]))
    # a split block's units are consecutive, in head-range order, each
    # with its index as its slot (the reduce kernel's split block x takes
    # slots x * ranges on)
    r = plan.ranges
    for i, (bi, kv, n, h0, h1, slot) in enumerate(plan.units):
        assert slot == (i if r > 1 else -1)
        assert plan.units[i - i % r][:3] == (bi, kv, n)
    assert plan.n_slots == (len(plan.units) if r > 1 else 0)
    # block-major; where the left side is open and the ranges are equal,
    # the tiles never grow along the order (the units run longest first)
    assert list(plan.units) == sorted(plan.units,
                                      key=lambda u: (u[2], u[0], u[1], u[3]))
    if r > 1 and group % r == 0:
        assert list(plan.tiles) == sorted(plan.tiles, reverse=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_is_the_kernels_decode(shape):
    """Unit i of the plan is what the kernel decodes from cluster i
    (csrc/flash_bwd_dkv_wide.cu: key block, then batch, kv head and head
    range j, heads j * group / ranges on), and the grid is one cluster a
    unit: b x hk x key blocks x ranges."""
    b, sq, sk, hk, group, causal, window = shape
    plan = _plan(shape)
    r = fb.dkv_wide_ranges(group, causal, window)
    assert plan.ranges == r
    assert len(plan.units) == b * hk * -(-sk // fb.DKV_WIDE_KEYS) * r
    for unit, got in enumerate(plan.units):
        j = unit % r
        want = (unit // (hk * r) % b, unit // r % hk, unit // (b * hk * r),
                j * group // r, (j + 1) * group // r, unit if r > 1 else -1)
        assert got == want


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_counts_the_kernels_tiles(shape):
    """A unit's tiles are its heads times the 32-row tiles from the first
    to the last query row that sees a key of its block (the band's live
    pairs, counted from the mask), as the kernel walks them."""
    b, sq, sk, hk, group, causal, window = shape
    if sq * sk > 1 << 24:
        sq, sk = sq // 4, sk // 4
        shape = (b, sq, sk, hk, group, causal, window)
    plan = _plan(shape)
    mask = _build_mask(sq, sk, causal, window, device="cpu")
    if mask is None:
        mask = torch.ones((sq, sk), dtype=torch.bool)
    rows = fb.DKV_WIDE_ROWS
    for (bi, kv, n, h0, h1, _), tiles in zip(plan.units, plan.tiles):
        live = mask[:, n * 64:(n + 1) * 64].any(1).nonzero()
        want = 0
        if len(live):
            first = int(live[0]) // rows * rows
            want = -(-(int(live[-1]) + 1 - first) // rows)
        assert tiles == want * (h1 - h0), (n, tiles, want)


def test_plan_depends_on_shapes_only():
    """The plan is a function of ints: the same shapes give the same plan,
    it takes no tensor and no card's count, and an open window's left side
    plans as causal. The card's clusters enter only the balance report."""
    a = _plan(SHAPES[0])
    assert _plan(SHAPES[0]) == a
    assert fb.dkv_wide_plan(2, 2048, 2048, 1, 64, True, [-1, 0]) == a
    assert a.balance(H100_CLUSTERS) != a.balance(60)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plan_balances_the_training_shapes(shape):
    """At the d-512 training shapes (h64/1 causal) the units fill the
    card's clusters, and the busiest cluster walks at most 1.25x the mean
    tiles when they take the units longest first."""
    plan = _plan(shape)
    assert len(plan.units) >= H100_CLUSTERS
    longest, mean = plan.balance(H100_CLUSTERS)
    assert longest <= 1.25 * mean, (longest, mean)
    # for scale, a grid of one unit a key block (no split): the cluster of
    # the first block walks every row of all 64 heads, twice the mean
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fb, "SPLIT_RANGES", 1)
        whole = _plan(shape)
    longest, mean = whole.balance(H100_CLUSTERS)
    assert not whole.n_slots and longest >= 1.9 * mean


def test_plan_cuts_packed_rows_as_dense():
    """The training shape's two rows packed into one (a segmented launch
    over b1 s4096) cut every key block's group into the dense call's head
    ranges, so each key block is summed in the same order."""
    dense = _plan(SHAPES[0])
    packed = fb.dkv_wide_plan(1, 4096, 4096, 1, 64, True, None)
    blocks = 2048 // fb.DKV_WIDE_KEYS
    for bi in range(2):
        for n, ranges in dense.head_ranges(bi).items():
            assert packed.head_ranges()[bi * blocks + n] == ranges


def test_plan_leaves_window_blocks_whole_and_reports_workspace():
    """A 128-token window's key blocks see few rows: no block is split and
    no workspace is needed. The training shape's split blocks need their
    partials' workspace: 2 x 64 x d fp32 a slot."""
    win = _plan(SHAPES[3])
    assert win.ranges == 1 and all(u[5] == -1 for u in win.units)
    assert win.workspace_bytes(512) == 0
    train = _plan(SHAPES[0])
    assert train.n_slots > 0
    assert train.workspace_bytes(512) == train.n_slots * 2 * 64 * 512 * 4
    assert train.workspace_bytes(384) == train.n_slots * 2 * 64 * 384 * 4


def _assemble(plan, q, k, v, do, lse, di, kw):
    """dK and dV from each unit's plain partial (``dkv_reference`` over its
    head range, its key block's rows), summed in fp32 in head-range order."""
    hk, sk = k.shape[2], k.shape[1]
    group = q.shape[2] // hk
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi, kv, n, h0, h1, _ in sorted(plan.units,
                                       key=lambda u: (u[0], u[1], u[2], u[3])):
        hs = slice(kv * group + h0, kv * group + h1)
        bs, ks = slice(bi, bi + 1), slice(kv, kv + 1)
        pk, pv = fb.dkv_reference(q[bs, :, hs], k[bs, :, ks], v[bs, :, ks],
                                  do[bs, :, hs], lse[bs, hs], di[bs, hs],
                                  **kw)
        rows = slice(n * fb.DKV_WIDE_KEYS, (n + 1) * fb.DKV_WIDE_KEYS)
        dk[bs, rows, ks] += pk[:, rows]
        dv[bs, rows, ks] += pv[:, rows]
    return dk, dv


@pytest.mark.parametrize("window", [None, (127, 0)], ids=["causal", "window"])
def test_partials_in_plan_order_match_jax(window):
    """b1 s256 h8/1 d384, causal (every key block cut into 4 ranges of 2
    heads) and windowed (blocks whole): dK and dV assembled from per-range
    partials against JAX's bwd."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import flash_attention_tpu as fat
    from flash_attention_tpu.utils.metrics import assert_metrics

    b, s, h, hk, d = 1, 256, 8, 1, 384
    rng = np.random.default_rng(384 + (window is None))
    q, k, v, do = (rng.standard_normal(x, dtype=np.float32)
                   for x in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                             (b, s, h, d)))

    @jax.jit
    def jax_side(qj, kj, vj, doj):
        o, lse = fat.fwd(qj, kj, vj, is_causal=True, window_size=window)
        return o, lse, fat.bwd(qj, kj, vj, o, lse, doj, is_causal=True,
                               window_size=window)

    o, lse, want = jax_side(*map(jnp.asarray, (q, k, v, do)))
    plan = fb.dkv_wide_plan(b, s, s, hk, h // hk, True, window)
    assert len(plan.head_ranges()[0]) == (1 if window else fb.SPLIT_RANGES)
    qt, kt, vt, ot, dot = (torch.from_numpy(np.array(x))
                           for x in (q, k, v, o, do))
    lse_t = torch.from_numpy(np.array(lse))
    di = fb.di_reference(ot, dot)
    dk, dv = _assemble(plan, qt, kt, vt, dot, lse_t, di,
                       dict(causal=True, sm_scale=d**-0.5, window=window))
    for name, x, ref in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert_metrics(f"{name}[plan, window={window}]", x.numpy(),
                       np.asarray(ref), BWD_TOLS)
