"""The port's MoE ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides in fp32; the JAX grouped
matmul runs its Pallas kernels in interpret mode, the port its plain
versions. Tolerances are ``tests/test_moe.py``'s: the grouped matmul rtol
1e-5 / atol 1e-4, ``moe_ffn`` rtol 1e-4 / atol 1e-5, gradients 1e-4; the
router logits and weights 1e-6 (rtol and atol: the fp32 router product sums
in another order on the two sides, about 2e-6 on logits near 4). Routing
must be identical, so each seed's gap between the k-th and (k+1)-th router
logit is asserted above 1e-4: a tie could pick different experts on the two
sides and move a token's output by far more than any tolerance.

An expert that receives no rows must get dW = 0 from the port; the JAX
kernel never writes that slot (NaN in interpret mode), so a dense
compute-all-experts torch autograd oracle is the reference there.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.ops import moe as jm
from flash_attention_tpu_torch.ops import moe as tm

torch.set_num_threads(2)

TIE_MARGIN = 1e-4


def _jact(a):
    return jax.nn.silu(a.astype(jnp.float32))


def _tact(a):
    return torch.nn.functional.silu(a.float())


def _weights(seed, t, d, f, e):
    """tests/test_moe.py's inputs: x, router, gate, up, down."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    rw = (rng.normal(size=(d, e)) * 0.1).astype(np.float32)
    wg = (rng.normal(size=(e, d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(e, d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    return x, rw, wg, wu, wd


def _assert_no_tie(x, rw, k):
    top = np.sort(x @ rw, axis=-1)[:, ::-1]
    gap = float(np.min(top[:, k - 1] - top[:, k]))
    assert gap > TIE_MARGIN, f"routing tie: k-th minus (k+1)-th logit {gap}"


def test_grouped_matmul_matches_jax():
    """tests/test_moe.py:43-58's case; dead blocks exactly 0."""
    rng = np.random.default_rng(0)
    e, k_dim, n_dim, br = 4, 256, 384, 128
    be = np.asarray([2, 0, 0, 3, -1, 1], np.int32)
    x = rng.normal(size=(len(be) * br, k_dim)).astype(np.float32)
    w = rng.normal(size=(e, k_dim, n_dim)).astype(np.float32)
    want = np.asarray(jm.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(be)))
    got = tm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(be)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.all(got[4 * br:5 * br] == 0)


def test_grouped_matmul_strided_transpose():
    """The strided view w.transpose(1, 2) (the backward's w^T) gives what a
    contiguous copy of it gives."""
    rng = np.random.default_rng(1)
    be = torch.tensor([1, -1, 0, 2], dtype=torch.int32)
    dy = torch.from_numpy(rng.normal(size=(4 * 128, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 64, 96)).astype(np.float32))
    view = w.transpose(1, 2)
    assert view.stride(1) == 1
    got = tm.grouped_matmul(dy, view, be)
    want = tm.grouped_matmul(dy, view.contiguous(), be)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [1, 3])
def test_route_matches_jax(seed):
    x, rw, *_ = _weights(seed, 37, 256, 512, 8)
    _assert_no_tie(x, rw, 2)
    wj, ij, lj = jm.route(jnp.asarray(x), jnp.asarray(rw), 2)
    wt, it, lt = tm.route(torch.from_numpy(x), torch.from_numpy(rw), 2)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-6)


def test_moe_ffn_and_dispatch_match_jax(monkeypatch):
    """t 53, d 256, f 512, e 8, k 2 (tests/test_moe.py:61-71): the output,
    the logits, and the padded row count and block_expert JAX's
    grouped_matmul receives."""
    x, rw, wg, wu, wd = _weights(1, 53, 256, 512, 8)
    _assert_no_tie(x, rw, 2)
    seen = []
    jax_gmm = jm.grouped_matmul

    def recording(xs, w, be, **kw):
        seen.append((xs.shape[0], np.asarray(be)))
        return jax_gmm(xs, w, be, **kw)

    monkeypatch.setattr(jm, "grouped_matmul", recording)
    oj, lj = jm.moe_ffn(*map(jnp.asarray, (x, rw, wg, wu, wd)), n_top=2,
                        act=_jact)
    ot, lt = tm.moe_ffn(*map(torch.from_numpy, (x, rw, wg, wu, wd)), n_top=2,
                        act=_tact)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-6)
    _, ids, _ = tm.route(torch.from_numpy(x), torch.from_numpy(rw), 2)
    _, _, bexp, n_pad = tm.dispatch(ids, 8)
    assert len(seen) == 3
    for rows, be in seen:
        assert rows == n_pad == (1 + 8 + 1) * 128
        np.testing.assert_array_equal(bexp.numpy(), be)


def test_moe_ffn_grads_match_jax():
    """d/d(x, w_gate, w_up, w_down, router) of sum(sin(out)) against
    jax.grad (tests/test_moe.py:93-124's case), every expert live."""
    x, rw, wg, wu, wd = _weights(3, 37, 256, 512, 8)
    _assert_no_tie(x, rw, 2)

    def loss_j(x, rw, wg, wu, wd):
        o, _ = jm.moe_ffn(x, rw, wg, wu, wd, n_top=2, act=_jact)
        return jnp.sum(jnp.sin(o))

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, rw, wg, wu, wd)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (x, rw, wg, wu, wd)]
    out, _ = tm.moe_ffn(*leaves, n_top=2, act=_tact)
    gt = torch.autograd.grad(torch.sin(out).sum(), leaves)
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), gt,
                          gj):
        assert np.all(np.isfinite(np.asarray(b))), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def _dense_moe(x, rw, wg, wu, wd, k):
    """Every expert on every token, combined with the routed weights."""
    w, ids, _ = tm.route(x, rw, k)
    h = torch.einsum("td,edf->tef", x, wg)
    u = torch.einsum("td,edf->tef", x, wu)
    y = torch.einsum("tef,efd->ted", _tact(h) * u, wd)
    cw = (torch.nn.functional.one_hot(ids.long(), wg.shape[0]).float()
          * w[..., None]).sum(1)
    return (y * cw[..., None]).sum(1)


def test_empty_expert_gets_zero_gradient():
    """Expert 2 is never routed to (its router column is far below the
    others): the port's dW[2] is exactly 0, as the dense oracle's is, and
    every other gradient matches the oracle."""
    x, rw, wg, wu, wd = _weights(5, 29, 256, 512, 4)
    x[:, 0] = np.abs(x[:, 0]) + 3.0  # a positive feature ...
    rw[:, 2] = 0.0
    rw[0, 2] = -50.0                 # ... that drives expert 2's logit down
    x_t, rw_t = torch.from_numpy(x), torch.from_numpy(rw)
    assert bool((x_t @ rw_t)[:, 2].max() < -100)
    _assert_no_tie(x, rw, 2)
    _, ids, _ = tm.route(x_t, rw_t, 2)
    assert not bool((ids == 2).any())
    _, _, bexp, _ = tm.dispatch(ids, 4)
    assert not bool((bexp == 2).any())
    grads = []
    for fn in (lambda *a: tm.moe_ffn(*a, n_top=2, act=_tact)[0],
               lambda *a: _dense_moe(*a, 2)):
        leaves = [t.clone().requires_grad_() for t in
                  (x_t, rw_t, *map(torch.from_numpy, (wg, wu, wd)))]
        grads.append(torch.autograd.grad(torch.sin(fn(*leaves)).sum(),
                                         leaves))
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          *grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    for g in grads[0][2:]:
        assert bool((g[2] == 0).all())
        assert all(bool(g[e].abs().max() > 0) for e in (0, 1, 3))


def test_gmm_dw_reference_matches_jax_on_live_experts():
    """The plain dW against the JAX kernel (interpret mode) on blocks that
    cover experts 0, 1 and 3 out of 5; JAX's empty slots (2 and 4) are
    unwritten there, the port's are 0."""
    rng = np.random.default_rng(7)
    be = np.asarray([0, 0, 3, -1, 1], np.int32)
    x = rng.normal(size=(5 * 128, 128)).astype(np.float32)
    dy = rng.normal(size=(5 * 128, 256)).astype(np.float32)
    want = np.asarray(jm._gmm_dw_impl(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(be), 5, block_n=512,
        block_k=512, interpret=True, out_dtype=jnp.float32))
    got = tm.gmm_dw(torch.from_numpy(x), torch.from_numpy(dy),
                    torch.from_numpy(be), 5).numpy()
    for e in (0, 1, 3):
        np.testing.assert_allclose(got[e], want[e], rtol=1e-5, atol=1e-3)
    assert np.all(got[2] == 0) and np.all(got[4] == 0)


def test_expert_offset_raises():
    """``expert_offset`` (expert parallelism), which raised before tensor
    parallelism was ported, now runs: the partial outputs of two ranks of
    4 experts each (offsets 0 and 4) sum to the single call over all 8,
    and each equals JAX's partial output on the same shard."""
    x, rw, wg, wu, wd = map(torch.from_numpy, _weights(2, 8, 256, 512, 8))
    full, logits = tm.moe_ffn(x, rw, wg, wu, wd, n_top=2, act=_tact)
    parts = []
    for off in (0, 4):
        part, lg = tm.moe_ffn(x, rw, wg[off:off + 4], wu[off:off + 4],
                              wd[off:off + 4], n_top=2, act=_tact,
                              expert_offset=off)
        want, _ = jm.moe_ffn(*(jnp.asarray(a.numpy()) for a in (
            x, rw, wg[off:off + 4], wu[off:off + 4], wd[off:off + 4])),
            n_top=2, act=jax.nn.silu, expert_offset=off)
        np.testing.assert_allclose(part.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lg, logits, rtol=0, atol=0)
        parts.append(part)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
