"""Tensor-parallel decoding and the engine in the port against the JAX
package's, on the CPU: the int8 KV cache's decode step, ``multistep.
tp_decode_rollout`` and ``spec.tp_draft_rollout``, and ``Engine(mesh=)``
with each of its options, as ``tests/test_torch_tp.py`` holds the model's
step functions (its helpers, inputs and gates are shared): the JAX side on
the conftest's virtual mesh, the port in 2 spawned gloo ranks, one spawn.

This module imports JAX only inside its fixtures (the spawned ranks import
it afresh).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import tp_inference as tpi
from test_torch_tp import (FED, TOL, TP, _decode_inputs, _gather, _heads,
                           _np, _same_on_ranks, _t, _to_numpy_tree)

# the int8 KV cache: pages of 128 tokens (a scale tile's lanes)
QPAGES, QPS = 6, 128
# the engines: two prompts, greedy
PROMPT_LENS, MAX_NEW = (70, 30), 4
ENGINE = dict(total_pages=32, page_size=16, max_batch=2, max_seq_len=256)
# the port's engine variants, each against the JAX engine's greedy tokens
VARIANTS = {"default": {}, "chunked": dict(chunk_size=32),
            "decode_block": dict(decode_block=2),
            "prefix_cache": dict(prefix_cache=True), "spec": "spec"}
ROLLOUT_STEPS, N_DRAFT = 3, 2


def _quant_inputs(cfg, seed):
    """An int8 KV cache (values and per-token scales) with the decode
    case's rows."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, cfg.n_kv_heads, QPAGES, QPS, cfg.head_dim)
    out = {}
    for n in ("k", "v"):
        out[n + "p"] = rng.integers(-127, 128, shape).astype(np.int8)
        out[n + "s"] = (rng.uniform(0.005, 0.02, shape[:3] + (8, 128))
                        .astype(np.float32))
    tables = np.asarray([[1, 3], [5, 0]], np.int32)
    lens = np.asarray([200, 17], np.int32)
    out.update(tok=np.asarray(FED, np.int32), lens=lens, tables=tables,
               wpage=np.asarray([tables[i, (n - 1) // QPS]
                                 for i, n in enumerate(lens)], np.int32),
               woff=((lens - 1) % QPS).astype(np.int32))
    return out


def _prompts():
    rng = np.random.default_rng(7)
    return [list(map(int, rng.integers(0, 255, size=n))) for n in PROMPT_LENS]


def _draft(params, n_layers=1):
    """The target's first layers as the draft (embedding, norm and lm_head
    shared)."""
    return {k: (v[:n_layers] if np.ndim(v) and k not in
                ("embed", "lm_head", "norm_out") else v)
            for k, v in params.items()}


def _run_kv_quant(rank, mesh, np_params):
    cfg = tl.LlamaConfig.tiny()
    params = tl.params_from_jax(np_params, "cpu", torch.float32)
    q = _quant_inputs(cfg, 2)
    kp, vp, ks, vs = (_t(_heads(q[n], rank, 1))
                      for n in ("kp", "vp", "ks", "vs"))
    logits, kp, vp, ks, vs = tpi.tp_decode_step(
        params, kp, vp, _t(q["tok"]), _t(q["lens"]), _t(q["tables"]),
        _t(q["wpage"]), _t(q["woff"]), cfg=cfg, mesh=mesh, k_scales=ks,
        v_scales=vs)
    return dict(logits=_np(logits), kp=_np(kp), vp=_np(vp), ks=_np(ks),
                vs=_np(vs))


def _run_rollouts(rank, mesh, np_params):
    from flash_attention_tpu_torch.serving import multistep, spec
    cfg = tl.LlamaConfig.tiny()
    params = tl.params_from_jax(np_params, "cpu", torch.float32)
    d = _decode_inputs(cfg, 3)
    kp, vp = (_t(_heads(d[n], rank, 1)) for n in ("kp", "vp"))
    toks, _, kp, vp, _, _ = multistep.tp_decode_rollout(
        params, kp, vp, None, None, _t(d["tok"]), _t(d["lens"]),
        _t(d["tables"]), [0.0, 0.0], [0, 0], [1.0, 1.0], [0, 0], [0, 0],
        cfg=cfg, n_steps=ROLLOUT_STEPS, need_filters=False,
        want_logprobs=False, mesh=mesh)
    dcfg = tl.LlamaConfig.tiny(n_layers=1)
    draft = tl.params_from_jax(_draft(np_params), "cpu", torch.float32)
    dkp, dvp = (_t(_heads(d[n][:1], rank, 1)) for n in ("kp", "vp"))
    dtoks, dlogits, dkp, dvp, _, _ = spec.tp_draft_rollout(
        draft, dkp, dvp, None, None, _t(d["tok"]), _t(d["lens"]),
        _t(d["tables"]), [0.0, 0.0], [0, 0], [0, 0], cfg=dcfg,
        n_draft=N_DRAFT, mesh=mesh)
    return dict(toks=_np(toks), kp=_np(kp), vp=_np(vp), dtoks=_np(dtoks),
                dlogits=_np(dlogits), dkp=_np(dkp))


def _run_engines(mesh, np_params):
    from flash_attention_tpu_torch import Engine
    cfg = tl.LlamaConfig.tiny()
    params = tl.params_from_jax(np_params, "cpu", torch.float32)
    out = {}
    for name, kw in VARIANTS.items():
        if kw == "spec":
            kw = dict(draft_cfg=tl.LlamaConfig.tiny(n_layers=1),
                      draft_params=tl.params_from_jax(_draft(np_params),
                                                      "cpu", torch.float32),
                      n_draft=2)
        eng = Engine(cfg, params, **ENGINE, mesh=mesh, **kw)
        reqs = [eng.add_request(p, MAX_NEW) for p in _prompts()]
        eng.run()
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        out[name] = [r.output for r in reqs]
        out[name + "_cache_heads"] = eng.k_pages.shape[1]
    eng = Engine(cfg, params, total_pages=8, page_size=128, max_batch=2,
                 max_seq_len=256, kv_quant=True, mesh=mesh)
    reqs = [eng.add_request(p, MAX_NEW) for p in _prompts()]
    eng.run()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    out["kv_quant"] = [r.output for r in reqs]
    out["kv_quant_scale_heads"] = eng.k_scales.shape[1]
    try:
        Engine(cfg, params, **ENGINE, mesh=mesh, lora_rank=2)
        out["lora"] = None
    except ValueError as e:
        out["lora"] = str(e)
    return out




def _rank(rank, world, tree):
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(model=world, device_type="cpu")
    with torch.no_grad():
        return dict(kv_quant=_run_kv_quant(rank, mesh, tree),
                    rollouts=_run_rollouts(rank, mesh, tree),
                    engines=_run_engines(mesh, tree))


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
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    q = _quant_inputs(cfg, 2)
    ql, qkp, qvp, qks, qvs = jtp.tp_decode_step(
        params, *(jnp.asarray(q[n]) for n in ("kp", "vp", "tok", "lens",
                                              "tables", "wpage", "woff")),
        cfg=cfg, mesh=mesh, k_scales=jnp.asarray(q["ks"]),
        v_scales=jnp.asarray(q["vs"]))
    kv_quant = {k: np.asarray(v) for k, v in dict(
        logits=ql, kp=qkp, vp=qvp, ks=qks, vs=qvs).items()}
    d = _decode_inputs(cfg, 3)
    zeros = jnp.zeros(2, jnp.int32)
    toks, _, kp, vp, _, _ = jms.tp_decode_rollout(
        params, jnp.asarray(d["kp"]), jnp.asarray(d["vp"]), None, None,
        jnp.asarray(d["tok"]), jnp.asarray(d["lens"]),
        jnp.asarray(d["tables"]), jnp.zeros(2, jnp.float32), zeros,
        jnp.ones(2, jnp.float32), zeros, zeros, cfg=cfg,
        n_steps=ROLLOUT_STEPS, need_filters=False, want_logprobs=False,
        mesh=mesh)
    dcfg = jl.LlamaConfig.tiny(n_layers=1)
    draft = jax.tree.map(jnp.asarray, _draft(params))
    dtoks, dlogits, dkp, _, _, _ = jspec.tp_draft_rollout(
        draft, jnp.asarray(d["kp"][:1]), jnp.asarray(d["vp"][:1]), None,
        None, jnp.asarray(d["tok"]), jnp.asarray(d["lens"]),
        jnp.asarray(d["tables"]), jnp.zeros(2, jnp.float32), zeros, zeros,
        cfg=dcfg, n_draft=N_DRAFT, mesh=mesh)
    rollouts = {k: np.asarray(v) for k, v in dict(
        toks=toks, kp=kp, vp=vp, dtoks=dtoks, dlogits=dlogits,
        dkp=dkp).items()}
    engines = {}
    for name, kw in (("default", {}), ("kv_quant", dict(
            total_pages=8, page_size=128, kv_quant=True))):
        eng = JaxEngine(cfg, params, **{**ENGINE, **kw},
                        kv_dtype=jnp.float32, mesh=mesh)
        reqs = [eng.add_request(p, MAX_NEW) for p in _prompts()]
        while eng.sched.has_work:
            eng.step()
        assert all(r.error is None for r in reqs)
        engines[name] = [r.output for r in reqs]
    return dict(tree=_to_numpy_tree(params), kv_quant=kv_quant,
                rollouts=rollouts, engines=engines)


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's results, from one spawn of TP ranks."""
    return pmesh.spawn(_rank, TP, jax_side["tree"])


def test_tp_kv_quant_decode_matches_jax(ranks, jax_side):
    """The int8 cache: logits, the quantized rows written and their scales
    (sharded like the pages) against JAX's."""
    want = jax_side["kv_quant"]
    np.testing.assert_allclose(_same_on_ranks(ranks, "kv_quant", "logits"),
                               want["logits"], **TOL)
    for n in ("kp", "vp"):
        got = _gather(ranks, "kv_quant", n, axis=1).astype(np.int32)
        assert np.abs(got - want[n].astype(np.int32)).max() <= 1, n
    for n in ("ks", "vs"):
        np.testing.assert_allclose(_gather(ranks, "kv_quant", n, axis=1),
                                   want[n], rtol=1e-5, atol=0)


def test_tp_decode_rollout_matches_jax(ranks, jax_side):
    """tp_decode_rollout: the greedy tokens and the pages written."""
    want = jax_side["rollouts"]
    np.testing.assert_array_equal(_same_on_ranks(ranks, "rollouts", "toks"),
                                  want["toks"])
    for n in ("kp", "vp"):
        np.testing.assert_allclose(_gather(ranks, "rollouts", n, axis=1),
                                   want[n], **TOL)


def test_tp_draft_rollout_matches_jax(ranks, jax_side):
    """tp_draft_rollout (a 1-layer draft sharded like the target): tokens,
    their logits and the draft's pages."""
    want = jax_side["rollouts"]
    np.testing.assert_array_equal(_same_on_ranks(ranks, "rollouts", "dtoks"),
                                  want["dtoks"])
    np.testing.assert_allclose(_same_on_ranks(ranks, "rollouts", "dlogits"),
                               want["dlogits"], **TOL)
    np.testing.assert_allclose(_gather(ranks, "rollouts", "dkp", axis=1),
                               want["dkp"], **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_mesh_tokens_match_jax(ranks, jax_side, variant):
    """Engine(mesh=) on every rank emits the JAX mesh engine's greedy
    tokens, with each option (chunked prefill, multi-step decode, prefix
    caching, speculation: all exact for greedy requests), and every rank
    the same ones; each rank's cache holds n_kv_heads / tp heads."""
    got = _same_on_ranks(ranks, "engines", variant)
    assert got == jax_side["engines"]["default"]
    assert _same_on_ranks(ranks, "engines", variant + "_cache_heads") == \
        tl.LlamaConfig.tiny().n_kv_heads // TP


def test_engine_mesh_kv_quant_matches_jax(ranks, jax_side):
    """Engine(mesh=, kv_quant=True): the int8 cache's scales sharded like
    its pages, and JAX's mesh engine's tokens."""
    assert _same_on_ranks(ranks, "engines", "kv_quant") == \
        jax_side["engines"]["kv_quant"]
    assert _same_on_ranks(ranks, "engines", "kv_quant_scale_heads") == \
        tl.LlamaConfig.tiny().n_kv_heads // TP


def test_engine_mesh_lora_raises(ranks):
    """Engine(mesh=, lora_rank=) raises the JAX engine's ValueError."""
    for r in ranks:
        assert r["engines"]["lora"] is not None
        assert "multi-LoRA with tensor parallelism" in r["engines"]["lora"]
