"""Ring and sharded attention in the port against the JAX package's, on the
CPU.

The JAX side runs ``ring_flash_attention`` and ``shard_flash_attention``
under ``jax.shard_map`` on the conftest's virtual 8-device CPU mesh, as
``tests/test_parallel.py`` does (the Pallas kernels in interpret mode).
The port side runs the same calls in 4 ranks spawned ONCE by
``parallel.mesh.spawn`` (gloo over the CPU): the ring at cp=4 over a
(context=4) mesh and at cp=2 over a (data=2, context=2) one, where both
data groups run the same ring; the analogue of
``__graft_entry__.dryrun_multichip`` at every (dp, tp, cp) factorisation of
4 ranks (one training step of an attention layer: batch on data, heads on
model, the sequence on context, against the same step on one device at
dryrun's gates); and ``ppermute`` with a partial permutation.

Inputs come from numpy seeds. Both sides run fp32, so o, lse and the
gradients agree to rtol/atol 2e-4. Each rank returns its own sequence
chunk (and head block); the tests gather them before comparing.

This module imports JAX only inside its fixtures: the spawned ranks import
it afresh and must not pay for (or depend on) JAX.
"""

from __future__ import annotations

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.ops.attention import flash_attention
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import sharded_attention as sa

WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-4)
# the ring's inputs: GQA, b1 s256 h4/2 d64
RING = dict(b=1, s=256, h=4, hk=2, d=64)
RING_CASES = [(cp, causal) for cp in (2, 4) for causal in (True, False)]
# shard_flash_attention: (data, model, context) meshes of 4 ranks, q
# b2 s256 h4/2 d64
SHARD_CASES = {"no_context": (2, 2, 1), "context": (1, 2, 2)}
# the dryrun analogue: b4 s512 h8 d64, causal, every (dp, tp, cp) of 4
DRY = dict(b=4, s=512, h=8, d=64)
DRY_FACTS = [(dp, tp, cp) for dp in (1, 2, 4) for tp in (1, 2, 4)
             for cp in (1, 2, 4) if dp * tp * cp == WORLD]
DRY_LR = 1e-3
# a partial permutation over the 4 ranks of a context dim
PERM = [(0, 2), (1, 0)]


def _qkvo(seed, b, s, h, hk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                          (b, s, h, d))]


def _dry_inputs():
    rng = np.random.default_rng(7)
    b, s, h, d = DRY["b"], DRY["s"], DRY["h"], DRY["d"]
    x = rng.standard_normal((b, s, h * d), dtype=np.float32)
    w = {n: (rng.standard_normal(shape, dtype=np.float32) * 0.02)
         for n, shape in (("wq", (h * d, h, d)), ("wk", (h * d, h, d)),
                          ("wv", (h * d, h, d)), ("wo", (h, d, h * d)))}
    return x, w


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


# ---------------------------------------------------------------- the ranks


def _ring_case(mesh, cp, causal):
    """The ring on this rank's chunk: (o, lse, dq, dk, dv) of its chunk,
    the gradient that of sum(o * do)."""
    q, k, v, do = _qkvo(cp * 10 + causal, **RING)
    c = pmesh.axis_index(mesh, "context")
    n = RING["s"] // cp
    q, k, v = (_t(x[:, c * n:(c + 1) * n], grad=True) for x in (q, k, v))
    o, lse = sa.ring_flash_attention(q, k, v, (mesh, "context"),
                                     causal=causal, axis_size=cp)
    (o * _t(do[:, c * n:(c + 1) * n])).sum().backward()
    return [t.detach().numpy() for t in (o, lse, q.grad, k.grad, v.grad)]


def _dry_loss(mesh, cp, x, w):
    """The attention layer's loss, mean((o wo - x)^2), on this rank's block
    (batch on data, heads on model, the sequence on context), and its
    weights' blocks (requiring grad)."""
    blk = {n: pmesh.copy_to(pmesh.copy_to(w[n], mesh, "data"), mesh,
                            "context") for n in w}
    xb = sa._block(sa._block(x, mesh, "data", 0), mesh, "context", 1)
    q, k, v = (torch.einsum("bse,ehd->bshd", xb, blk[n])
               for n in ("wq", "wk", "wv"))
    o = sa.shard_flash_attention(q, k, v, mesh, causal=True,
                                 context_axis="context" if cp > 1 else None,
                                 local=True)
    y = pmesh.reduce_from(torch.einsum("bshd,hde->bse", o, blk["wo"]), mesh,
                          "model")
    loss = ((y - xb) ** 2).sum() / x.numel()
    for dim in ("data", "context"):
        loss = pmesh.reduce_from(loss, mesh, dim)
    return loss


def _dry_case(dp, tp, cp):
    """One SGD step of the attention layer at this factorisation: the
    loss, this rank's weight blocks' gradients and stepped weights."""
    mesh = pmesh.make_mesh(data=dp, model=tp, context=cp, device_type="cpu")
    x, w = _dry_inputs()
    m = pmesh.axis_index(mesh, "model")
    hl = DRY["h"] // tp
    cut = {n: (a[:, m * hl:(m + 1) * hl] if n != "wo"
               else a[m * hl:(m + 1) * hl]) for n, a in w.items()}
    w = {n: _t(a, grad=True) for n, a in cut.items()}
    loss = _dry_loss(mesh, cp, _t(x), w)
    loss.backward()
    with torch.no_grad():
        new = {n: (a - DRY_LR * a.grad).numpy() for n, a in w.items()}
    return dict(loss=float(loss), grads={n: a.grad.numpy()
                                         for n, a in w.items()}, new=new)


def _rank(rank, world):
    torch.set_num_threads(1)
    out = {"ring": {}, "dry": {}, "shard": {}}
    cp4 = pmesh.make_mesh(context=world, device_type="cpu")
    cp2 = pmesh.make_mesh(data=2, context=2, device_type="cpu")
    for cp, causal in RING_CASES:
        out["ring"][cp, causal] = _ring_case(cp4 if cp == 4 else cp2, cp,
                                             causal)
    x = torch.full((3,), float(rank + 1))
    out["ppermute"] = pmesh.ppermute(x, cp4, "context", PERM)
    out["ppermute_pair"] = pmesh.ppermute((x, 2 * x), cp4, "context", PERM)
    for name, (dp, tp, cp) in SHARD_CASES.items():
        mesh = pmesh.make_mesh(data=dp, model=tp, context=cp,
                               device_type="cpu")
        q, k, v, _ = _qkvo(5, 2, 256, 4, 2, 64)
        ctx = "context" if cp > 1 else None
        full = sa.shard_flash_attention(_t(q), _t(k), _t(v), mesh,
                                        causal=True, context_axis=ctx)
        blocks = [sa._block(sa._block(sa._block(_t(a), mesh, "data", 0),
                                      mesh, "model", 2), mesh, "context", 1)
                  for a in (q, k, v)]
        local = sa.shard_flash_attention(*blocks, mesh, causal=True,
                                         context_axis=ctx, local=True)
        try:
            sa.shard_flash_attention(_t(q[:, :, :3]), _t(k[:, :, :1]),
                                     _t(v[:, :, :1]), mesh)
            bad = None
        except ValueError as e:
            bad = str(e)
        out["shard"][name] = dict(
            o=full.numpy(), local=local.numpy(), bad=bad,
            at=[pmesh.axis_index(mesh, n) for n in pmesh.AXES])
    for fact in DRY_FACTS:
        out["dry"][fact] = _dry_case(*fact)
    out["at"] = [pmesh.axis_index(cp4, "context"),
                 [pmesh.axis_index(cp2, n) for n in pmesh.AXES]]
    return out


# ------------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jax_side():
    """The JAX ring's (o, lse, dq, dk, dv) at each case and
    shard_flash_attention's O, on the virtual mesh, and every rank's
    results from one spawn of WORLD ranks, which runs while JAX
    compiles."""
    pytest.importorskip("jax")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    spawned = pool.submit(pmesh.spawn, _rank, WORLD)
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from flash_attention_tpu.parallel import make_mesh
    from flash_attention_tpu.parallel import (ring_flash_attention,
                                              shard_flash_attention)
    out = {"ring": {}, "shard": {}}
    for cp, causal in RING_CASES:
        q, k, v, do = (jnp.asarray(a) for a in _qkvo(cp * 10 + causal,
                                                      **RING))
        mesh = Mesh(np.asarray(jax.devices()[:cp]), axis_names=("context",))
        seq = P(None, "context")

        def ring(q, k, v, mesh=mesh, cp=cp, causal=causal):
            return jax.shard_map(
                lambda a, b, c: ring_flash_attention(
                    a, b, c, "context", causal=causal, axis_size=cp),
                mesh=mesh, in_specs=(seq,) * 3,
                out_specs=(seq, P(None, None, "context")),
                check_vma=False)(q, k, v)

        @jax.jit  # one program: eager shard_map and grad take minutes
        def both(q, k, v, do=do, ring=ring):
            grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v)[0] * do),
                             (0, 1, 2))(q, k, v)
            return (*ring(q, k, v), *grads)

        out["ring"][cp, causal] = [np.asarray(a) for a in both(q, k, v)]
    for name, (dp, tp, cp) in SHARD_CASES.items():
        q, k, v, _ = (jnp.asarray(a) for a in _qkvo(5, 2, 256, 4, 2, 64))
        mesh = make_mesh(data=dp, model=tp, context=cp)
        out["shard"][name] = np.asarray(jax.jit(
            lambda q, k, v, mesh=mesh, cp=cp: shard_flash_attention(
                q, k, v, mesh, causal=True,
                context_axis="context" if cp > 1 else None))(q, k, v))
    out["ranks"] = spawned.result()
    pool.shutdown()
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's results."""
    return jax_side["ranks"]


@functools.lru_cache(maxsize=None)
def _dry_baseline():
    """The one-device step: (loss, grads) of the same layer through the
    port's ``flash_attention``."""
    x, w = _dry_inputs()
    x = _t(x)
    w = {n: _t(a, grad=True) for n, a in w.items()}
    q, k, v = (torch.einsum("bse,ehd->bshd", x, w[n])
               for n in ("wq", "wk", "wv"))
    o = flash_attention(q, k, v, causal=True)
    y = torch.einsum("bshd,hde->bse", o, w["wo"])
    loss = ((y - x) ** 2).mean()
    loss.backward()
    return float(loss.detach()), {n: a.grad.numpy() for n, a in w.items()}


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("cp,causal", RING_CASES)
def test_ring_matches_jax(ranks, jax_side, cp, causal):
    """o, lse and dq/dk/dv of the ring, each rank's chunk at its place,
    against JAX's ring under shard_map; at cp=2 both data groups of the
    (2, 1, 2) mesh give the same chunks bit for bit."""
    want = jax_side["ring"][cp, causal]
    n = RING["s"] // cp
    for i, name in enumerate(("o", "lse", "dq", "dk", "dv")):
        axis = 2 if name == "lse" else 1
        got = np.concatenate([r["ring"][cp, causal][i]
                              for r in ranks[:cp]], axis=axis)
        np.testing.assert_allclose(got, want[i], err_msg=name, **TOL)
        assert got.shape == want[i].shape
        assert ranks[0]["ring"][cp, causal][i].shape[axis] == n
        if cp == 2:
            for r, twin in zip(ranks[:2], ranks[2:]):
                np.testing.assert_array_equal(r["ring"][cp, causal][i],
                                              twin["ring"][cp, causal][i])


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_shard_flash_attention_matches_jax(ranks, jax_side, name):
    """Each rank's block of O, from the full tensors and from its own
    blocks alike, is its block of JAX's O; heads that do not divide the
    model dim raise JAX's ValueError."""
    dp, tp, cp = SHARD_CASES[name]
    want = jax_side["shard"][name]
    b, s, h = want.shape[0] // dp, want.shape[1] // cp, want.shape[2] // tp
    for r in ranks:
        res = r["shard"][name]
        di, mi, ci = res["at"]
        block = want[di * b:(di + 1) * b, ci * s:(ci + 1) * s,
                     mi * h:(mi + 1) * h]
        np.testing.assert_allclose(res["o"], block, **TOL)
        np.testing.assert_array_equal(res["local"], res["o"])
        assert res["bad"] == f"heads (3, 1) must divide model axis {tp}"


@pytest.mark.parametrize("fact", DRY_FACTS, ids=lambda f: "dp%d_tp%d_cp%d" % f)
def test_dryrun_factorisation(ranks, fact):
    """One SGD step of the attention layer on a (dp, tp, cp) mesh of 4
    ranks against one device, at dryrun_multichip's gates: loss rel <
    1e-4 and grad rel (sum over the weights of the max abs error over the
    largest reference value) < 5e-3. The ranks' losses are equal; the
    gathered head blocks and the stepped weights follow."""
    dp, tp, cp = fact
    ref_loss, ref = _dry_baseline()
    losses = [r["dry"][fact]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    assert abs(losses[0] - ref_loss) / abs(ref_loss) < 1e-4
    hl = DRY["h"] // tp
    num = 0.0
    for n, want in ref.items():
        parts = []
        for mi in range(tp):
            # a rank with model index mi (and data, context index 0)
            r = ranks[mi * cp]
            parts.append(r["dry"][fact]["grads"][n])
        got = np.concatenate(parts, axis=0 if n == "wo" else 1)
        num += float(np.max(np.abs(got - want)))
        new = np.concatenate([ranks[mi * cp]["dry"][fact]["new"][n]
                              for mi in range(tp)], axis=0 if n == "wo" else 1)
        w0 = _dry_inputs()[1][n]
        np.testing.assert_allclose(new, w0 - DRY_LR * want, rtol=0,
                                   atol=1e-6)
        assert parts[0].shape[0 if n == "wo" else 1] == hl
    den = max(float(np.max(np.abs(g))) for g in ref.values())
    assert num / den < 5e-3, num / den


def test_ppermute_partial_permutation(ranks):
    """ppermute over a context dim of 4 with perm [(0, 2), (1, 0)]: index 2
    gets index 0's tensor, index 0 index 1's, and indices 1 and 3 (no
    destination) zeros; a tuple travels whole."""
    assert [r["at"][0] for r in ranks] == list(range(WORLD))
    want = {0: 2.0, 1: 0.0, 2: 1.0, 3: 0.0}
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["ppermute"].numpy(),
                                      np.full(3, want[i], np.float32))
        a, b = r["ppermute_pair"]
        assert isinstance(r["ppermute_pair"], tuple)
        np.testing.assert_array_equal(a.numpy(), np.full(3, want[i]))
        np.testing.assert_array_equal(b.numpy(), np.full(3, 2 * want[i]))


def test_ring_without_a_pair_raises():
    """The port names the ring's axis as (mesh, dim name): a bare name,
    JAX's form under shard_map, raises."""
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(TypeError, match="pair"):
        sa.ring_flash_attention(q, q, q, "context")
    assert sa.EMPTY_LSE == -1e37
