"""Tensor-parallel serving in the port against the JAX package's, on the CPU.

The JAX side runs ``tp_prefill``, ``tp_prefill_chunk`` and
``tp_decode_step`` (Llama, Gemma-2, Qwen-2 biases, int8 and int4 weights,
Mixtral under expert parallelism) on the conftest's virtual 8-device CPU
mesh (``make_mesh(model=2)``: its first two devices), as
``tests/test_tp_inference.py`` does. The port side runs the same calls in
2 ranks spawned by ``parallel.mesh.spawn`` (gloo over the CPU), all cases
in one spawn. ``tests/test_torch_tp_engine.py`` holds the int8 KV cache,
the rollouts and ``Engine(mesh=)`` the same way, with this module's
helpers. Weights come from the JAX package's ``init_params``
(and ``quantize_params``) and cross over as numpy arrays through
``params_from_jax``; inputs come from numpy seeds. Both sides run fp32,
so logits and K/V agree to rtol/atol 2e-4 (``tests/test_tp_inference.py``'s
gate against one device).

The port returns each rank's own kv heads of the K/V and the pages where
JAX returns global arrays sharded over the mesh: the tests gather the
ranks' parts on the kv-head axis before comparing, and the ranks' logits
and tokens must be identical bit for bit (the SPMD engine's premise).

This module imports JAX only inside its fixtures: the spawned ranks import
it afresh and must not pay for (or depend on) JAX.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import tp_inference as tpi

TP = 2
TOL = dict(rtol=2e-4, atol=2e-4)
# model case -> (LlamaConfig constructor, its kwargs, weight bits or None)
MODELS = {
    "llama": ("tiny", {}, None),
    "gemma2": ("tiny_gemma2", dict(n_layers=2, sliding_window=40), None),
    "qwen2": ("tiny_qwen2", {}, None),
    "int8": ("tiny", {}, 8),
    "int4": ("tiny", {}, 4),
    "mixtral": ("tiny_moe", {}, None),
}
CHUNK_MODELS = ("llama", "gemma2", "mixtral")
# decode inputs (tests/test_tp_inference.py's): pages of 8 tokens, 2 rows
TOTAL_PAGES, PAGE_SIZE, PPS = 16, 8, 8
LENGTHS, FED = [11, 5], [3, 9]


def _cfgs(mod, name):
    ctor, kw, _ = MODELS[name]
    return getattr(mod.LlamaConfig, ctor)(**kw)


def _decode_inputs(cfg, seed):
    """Random fp32 pages and the fed tokens, lengths, tables and write
    slots of tests/test_tp_inference.py's decode case."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_kv_heads, TOTAL_PAGES, PAGE_SIZE,
             cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tables = rng.permutation(TOTAL_PAGES)[:2 * PPS].reshape(2, PPS)
    lens = np.asarray(LENGTHS, np.int32)
    wpage = np.asarray([tables[i, (n - 1) // PAGE_SIZE]
                        for i, n in enumerate(LENGTHS)], np.int32)
    return dict(kp=kp, vp=vp, tok=np.asarray(FED, np.int32), lens=lens,
                tables=tables.astype(np.int32), wpage=wpage,
                woff=((lens - 1) % PAGE_SIZE).astype(np.int32))


def _chunk_inputs(cfg, seed):
    """A chunk of 8 tokens after a prefix of 12 and of 5 in the decode
    case's pages."""
    d = _decode_inputs(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return dict(kp=d["kp"], vp=d["vp"],
                tok=rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
                done=np.asarray([12, 5], np.int32),
                clen=np.asarray([8, 6], np.int32),
                tables=d["tables"][:, :2].copy())


def _to_numpy_tree(params):
    """JAX params as numpy arrays; a QuantizedTensor as a plain namespace
    of values, scales and bits (so a rank unpickles it without JAX)."""
    out = {}
    for k, v in params.items():
        if hasattr(v, "bits"):
            out[k] = types.SimpleNamespace(values=np.asarray(v.values),
                                           scales=np.asarray(v.scales),
                                           bits=int(v.bits))
        else:
            out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------- the ranks


def _heads(x, rank, axis):
    """Rank ``rank``'s part of a global array on the kv-head ``axis``."""
    n = x.shape[axis] // TP
    return np.ascontiguousarray(np.take(x, range(rank * n, (rank + 1) * n),
                                        axis=axis))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _run_models(rank, mesh, trees):
    out = {}
    for name, np_params in trees.items():
        cfg = _cfgs(tl, name)
        full = tl.params_from_jax(np_params, "cpu", torch.float32)
        local = tpi.shard_params(full, cfg, mesh)
        toks = _t(np.arange(24, dtype=np.int64)[None] * 7 % cfg.vocab_size)
        logits, ks, vs = tpi.tp_prefill(full, toks, cfg=cfg, mesh=mesh)
        again, _, _ = tpi.tp_prefill(local, toks, cfg=cfg, mesh=mesh)
        d = _decode_inputs(cfg, 0)
        kp, vp = (_t(_heads(d[n], rank, 1)) for n in ("kp", "vp"))
        dl, kp, vp, _, _ = tpi.tp_decode_step(
            local, kp, vp, _t(d["tok"]), _t(d["lens"]), _t(d["tables"]),
            _t(d["wpage"]), _t(d["woff"]), cfg=cfg, mesh=mesh)
        res = dict(prefill=_np(logits), ks=_np(ks), vs=_np(vs),
                   sharded_tree_prefill=_np(again), decode=_np(dl),
                   kp=_np(kp), vp=_np(vp))
        if name in CHUNK_MODELS:
            c = _chunk_inputs(cfg, 1)
            cl, cks, cvs = tpi.tp_prefill_chunk(
                local, _t(c["tok"]), _t(c["done"]), _t(c["clen"]),
                _t(_heads(c["kp"], rank, 1)), _t(_heads(c["vp"], rank, 1)),
                None, None, _t(c["tables"]), cfg=cfg, mesh=mesh)
            res.update(chunk=_np(cl), chunk_ks=_np(cks), chunk_vs=_np(cvs))
        out[name] = res
    return out


def _same_tree(a, b):
    """The same names in the same order, and equal tensors (a
    QuantizedTensor's values, scales and bits)."""
    def leaves(w):
        return (w.values, w.scales, w.bits) if hasattr(w, "bits") else (w,)
    return list(a) == list(b) and all(
        all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(leaves(a[n]), leaves(b[n]))) for n in a)


def _rank(rank, world, trees):
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(model=world, device_type="cpu")
    with torch.no_grad():
        init = {}
        for name in ("llama", "int4", "mixtral"):
            cfg, bits = _cfgs(tl, name), MODELS[name][2]
            want = tl.init_params(cfg, seed=1, device="cpu",
                                  dtype=torch.float32)
            if bits:
                want = tl.quantize_params(want, bits=bits)
            got = tpi.init_shard(cfg, mesh, seed=1, device="cpu",
                                 dtype=torch.float32, bits=bits)
            init[name] = _same_tree(got, tpi.shard_params(want, cfg, mesh))
        try:  # a mesh must take the whole world (JAX takes a prefix)
            pmesh.make_mesh(model=2 * world, device_type="cpu")
            whole_world = None
        except ValueError as e:
            whole_world = str(e)
        return dict(models=_run_models(rank, mesh, trees), init=init,
                    whole_world=whole_world,
                    axis=(pmesh.axis_index(mesh, "model"),
                          pmesh.axis_size(mesh, "model")))


# ------------------------------------------------------------- the JAX side


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results on its virtual mesh, and the numpy weights
    the ranks take."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from flash_attention_tpu.models import llama as jl
    from flash_attention_tpu.parallel import mesh as jmesh
    from flash_attention_tpu.parallel import tp_inference as jtp
    from flash_attention_tpu.serving import multistep as jms
    from flash_attention_tpu.serving import spec as jspec
    from flash_attention_tpu.serving.engine import Engine as JaxEngine
    mesh = jmesh.make_mesh(model=TP)
    trees, models = {}, {}
    for name, (_, _, bits) in MODELS.items():
        cfg = _cfgs(jl, name)
        params = jl.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
        if bits:
            params = jl.quantize_params(params, bits=bits)
        trees[name] = _to_numpy_tree(params)
        toks = jnp.asarray(np.arange(24, dtype=np.int32)[None] * 7
                           % cfg.vocab_size)
        logits, ks, vs = jtp.tp_prefill(params, toks, cfg=cfg, mesh=mesh)
        d = _decode_inputs(cfg, 0)
        dl, kp, vp, _, _ = jtp.tp_decode_step(
            params, jnp.asarray(d["kp"]), jnp.asarray(d["vp"]),
            jnp.asarray(d["tok"]), jnp.asarray(d["lens"]),
            jnp.asarray(d["tables"]), jnp.asarray(d["wpage"]),
            jnp.asarray(d["woff"]), cfg=cfg, mesh=mesh)
        res = dict(prefill=logits, ks=ks, vs=vs, decode=dl, kp=kp, vp=vp)
        if name in CHUNK_MODELS:
            c = _chunk_inputs(cfg, 1)
            cl, cks, cvs = jtp.tp_prefill_chunk(
                params, jnp.asarray(c["tok"]), jnp.asarray(c["done"]),
                jnp.asarray(c["clen"]), jnp.asarray(c["kp"]),
                jnp.asarray(c["vp"]), None, None, jnp.asarray(c["tables"]),
                cfg=cfg, mesh=mesh)
            res.update(chunk=cl, chunk_ks=cks, chunk_vs=cvs)
        models[name] = {k: np.asarray(v) for k, v in res.items()}
    return dict(trees=trees, models=models)


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's results, from one spawn of TP ranks."""
    return pmesh.spawn(_rank, TP, jax_side["trees"])


def _gather(ranks, *path, axis):
    parts = []
    for r in ranks:
        x = r
        for p in path:
            x = x[p]
        parts.append(x)
    return np.concatenate(parts, axis=axis)


def _same_on_ranks(ranks, *path):
    vals = []
    for r in ranks:
        x = r
        for p in path:
            x = x[p]
        vals.append(x)
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# ------------------------------------------------------------------- tests


def test_mesh_axis(ranks):
    """Each rank's index and the axis size on the (1, 2, 1) mesh; a mesh
    of another size than the world raises (a divergence: JAX's make_mesh
    takes the first devices of more)."""
    assert [r["axis"] for r in ranks] == [(i, TP) for i in range(TP)]
    for r in ranks:
        assert r["whole_world"] is not None
        assert f"need a world of {2 * TP} ranks" in r["whole_world"]


@pytest.mark.parametrize("name", ["llama", "int4", "mixtral"])
def test_init_shard_is_the_shard_of_init_params(ranks, name):
    """init_shard, built weight by weight, gives each rank exactly its part
    of init_params (of quantize_params for int4) from the same seed."""
    assert all(r["init"][name] for r in ranks)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp_prefill_matches_jax(ranks, jax_side, name):
    """Replicated logits equal on every rank and JAX's; each rank's K/V
    are its kv heads of JAX's global K/V; an already-sharded tree gives
    the same logits bit for bit."""
    want = jax_side["models"][name]
    logits = _same_on_ranks(ranks, "models", name, "prefill")
    np.testing.assert_allclose(logits, want["prefill"], **TOL)
    for n in ("ks", "vs"):
        np.testing.assert_allclose(_gather(ranks, "models", name, n, axis=3),
                                   want[n], **TOL)
        for i, r in enumerate(ranks):
            assert r["models"][name][n].shape[3] == want[n].shape[3] // TP
            np.testing.assert_allclose(r["models"][name][n],
                                       _heads(want[n], i, 3), **TOL)
    for r in ranks:
        np.testing.assert_array_equal(r["models"][name]["sharded_tree_prefill"],
                                      logits)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp_decode_step_matches_jax(ranks, jax_side, name):
    """Decode logits (replicated) and the pages after the step's K/V
    writes (each rank's kv heads)."""
    want = jax_side["models"][name]
    np.testing.assert_allclose(
        _same_on_ranks(ranks, "models", name, "decode"), want["decode"],
        **TOL)
    for n in ("kp", "vp"):
        np.testing.assert_allclose(_gather(ranks, "models", name, n, axis=1),
                                   want[n], **TOL)


@pytest.mark.parametrize("name", CHUNK_MODELS)
def test_tp_prefill_chunk_matches_jax(ranks, jax_side, name):
    """A chunk over a paged prefix: logits and the chunk's K/V."""
    want = jax_side["models"][name]
    np.testing.assert_allclose(
        _same_on_ranks(ranks, "models", name, "chunk"), want["chunk"], **TOL)
    for n in ("chunk_ks", "chunk_vs"):
        np.testing.assert_allclose(_gather(ranks, "models", name, n, axis=3),
                                   want[n], **TOL)


def test_shard_params_layout():
    """shard_params' parts by the JAX package's tree_specs, without a mesh:
    column-parallel weights and their scales cut the output dim,
    row-parallel ones the input dim (int4: packed rows), experts the
    expert axis; replicated leaves are the same tensors."""
    cfg = tl.LlamaConfig.tiny()
    p = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    q4 = tl.quantize_params(p, bits=4)
    for name in p:
        part = tpi.shard_leaf(name, p[name], 1, TP, moe=False)
        if name in tpi.COLUMN:
            n = p[name].shape[-1] // TP
            assert torch.equal(part, p[name][..., n:])
        elif name in tpi.ROW:
            n = p[name].shape[1] // TP
            assert torch.equal(part, p[name][:, n:])
        else:
            assert part is p[name]
    wo = tpi.shard_leaf("wo", q4["wo"], 0, TP, moe=False)
    assert wo.values.shape == (2, 128, 256) and wo.scales is q4["wo"].scales
    wq = tpi.shard_leaf("wq", q4["wq"], 1, TP, moe=False)
    assert torch.equal(wq.scales, q4["wq"].scales[:, 256:])
    moe = tl.init_params(tl.LlamaConfig.tiny_moe(), device="cpu",
                         dtype=torch.float32)
    up = tpi.shard_leaf("w_up", moe["w_up"], 1, TP, moe=True)
    assert torch.equal(up, moe["w_up"][:, 2:])
    with pytest.raises(NotImplementedError, match="LoRA"):
        tpi.shard_leaf("lora", {}, 0, TP, moe=False)
    assert tpi.local_config(cfg, TP).n_kv_heads == 1
    with pytest.raises(ValueError, match="must divide"):
        tpi.local_config(tl.LlamaConfig.tiny(n_kv_heads=1), TP)
