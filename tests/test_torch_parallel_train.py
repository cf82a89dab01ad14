"""Parallel training in the port against the JAX package's, on the CPU.

Tensor parallelism: ``llama.train_loss(tp_axis=)`` at tp=2 for Llama,
Gemma-2, Qwen-2 (biases) and Mixtral (expert parallelism); the JAX side is
``jax.value_and_grad`` through ``jax.shard_map`` of its ``train_loss`` with
``tree_specs`` and ``local_config`` on the conftest's virtual mesh. Every
sharded leaf's gradient is its slice of JAX's; every replicated leaf's
(embed, norms, lm_head, the router) is JAX's whole gradient, the same bits
on both ranks.

The pipeline: ``pipeline_train_loss`` at pp=2 (n_micro 2), pp=4, dp=2 x
pp=2, Gemma-2's grouped windows and tiny MoE, against JAX's
``pipeline_train_loss`` (``tests/test_pipeline.py``'s cases, gradients
included); each stage's gradients are its slices of JAX's, and the data
replicas' are equal. Then JAX's rejections, message for message.

The port runs every case in 4 ranks spawned ONCE by ``parallel.mesh.spawn``
(gloo over the CPU): tp=2 on a (data=2, model=2) mesh and pp=2 on a
(2, pipe=2) one, where both groups run the same case. Weights come from
the JAX package's ``init_params`` and cross over as numpy arrays through
``params_from_jax``; inputs come from numpy seeds. Both sides run fp32:
rtol/atol 2e-4.

This module imports JAX only inside its fixtures: the spawned ranks import
it afresh and must not pay for (or depend on) JAX.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import pipeline
from flash_attention_tpu_torch.parallel import tp_inference as tpi

WORLD = 4
TP = 2
TOL = dict(rtol=2e-4, atol=2e-4)
# model case -> (LlamaConfig constructor, its kwargs)
TP_MODELS = {"llama": ("tiny", {}),
             "gemma2": ("tiny_gemma2", dict(sliding_window=24)),
             "qwen2": ("tiny_qwen2", {}),
             "mixtral": ("tiny_moe", {})}
# pipeline case -> (constructor, kwargs, stages, n_micro, batch, dp)
PP_CASES = {"pp2": ("tiny", dict(n_layers=4), 2, 2, 4, 1),
            "pp4": ("tiny", dict(n_layers=4), 4, 4, 4, 1),
            "dp2_pp2": ("tiny", dict(n_layers=4), 2, 2, 8, 2),
            "gemma2": ("tiny_gemma2", dict(n_layers=4), 2, 4, 4, 1),
            "moe": ("tiny_moe", dict(n_layers=4), 2, 2, 4, 1)}
SEQ = 32
# the rejections: case -> the message's start
REJECT = ("n_layers", "layers per stage", "batch", "lora", "quantized")


def _cfg(mod, ctor, kw):
    return getattr(mod.LlamaConfig, ctor)(**kw)


def _data(cfg, b, seed):
    """Tokens and targets (b, SEQ) int32, the last 5 targets of row 0
    ignored (-100), as tests/test_pipeline.py makes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, SEQ)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (b, SEQ)).astype(np.int32)
    tgts[0, -5:] = -100
    return toks, tgts


def _shard_dim(name, moe):
    """The dim a tensor-parallel rank's part of ``name`` cuts (None:
    replicated), by ``parallel.tp_inference``'s layout."""
    if moe and name in tpi.EXPERTS:
        return 1
    if name in tpi.COLUMN:
        return -1
    if name in tpi.ROW:
        return 1
    return None


# ---------------------------------------------------------------- the ranks


def _leaves(np_params, grad=True):
    p = tl.params_from_jax(np_params, "cpu", torch.float32)
    return {n: w.requires_grad_(grad) for n, w in p.items()}


def _grads(p):
    return {n: None if w.grad is None else w.grad.numpy()
            for n, w in p.items()}


def _tp_case(mesh, name, np_params):
    cfg = _cfg(tl, *TP_MODELS[name])
    toks, tgts = (torch.from_numpy(a) for a in _data(cfg, 2, 1))
    local = tpi.shard_params(_leaves(np_params, grad=False), cfg, mesh)
    local = {n: w.clone().requires_grad_() for n, w in local.items()}
    loss = tl.train_loss(local, toks, tgts, tpi.local_config(cfg, TP),
                         tp_axis=(mesh, "model"))
    loss.backward()
    return dict(loss=float(loss.detach()), grads=_grads(local))


def _pp_mesh(stages, dp):
    from torch.distributed.device_mesh import init_device_mesh
    if stages == WORLD:
        return init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pipe",))
    names = ("data", "pipe") if dp > 1 else ("rep", "pipe")
    return init_device_mesh("cpu", (WORLD // stages, stages),
                            mesh_dim_names=names)


def _pp_case(name, np_params):
    ctor, kw, stages, m, b, dp = PP_CASES[name]
    cfg = _cfg(tl, ctor, kw)
    mesh = _pp_mesh(stages, dp)
    toks, tgts = (torch.from_numpy(a) for a in _data(cfg, b, 2))
    p = _leaves(np_params)
    loss = pipeline.pipeline_train_loss(
        p, toks, tgts, cfg, mesh=mesh, n_micro=m,
        data_axis="data" if dp > 1 else None)
    loss.backward()
    out = dict(loss=float(loss.detach()), grads=_grads(p))
    if name == "pp2":  # an already staged tree, without autograd
        staged = pipeline._stage_params(_leaves(np_params, grad=False), cfg,
                                        mesh, "pipe")
        staged = {n: w.clone() for n, w in staged.items()}
        with torch.no_grad():
            out["staged_loss"] = float(pipeline.pipeline_train_loss(
                staged, toks, tgts, cfg, mesh=mesh, n_micro=m))
        out["staged_layers"] = staged["wq"].shape[0]
    return out


def _rejections(np_params):
    """pipeline_train_loss's ValueErrors, and train_loss's with tp_axis on
    LoRA stacks, each as (type name, message)."""
    mesh = _pp_mesh(2, 1)
    cfg = _cfg(tl, "tiny", dict(n_layers=4))
    p = _leaves(np_params, grad=False)
    toks, tgts = (torch.from_numpy(a) for a in _data(cfg, 4, 2))
    calls = {
        "n_layers": lambda: pipeline.pipeline_train_loss(
            p, toks, tgts, _cfg(tl, "tiny", dict(n_layers=3)), mesh=mesh),
        "layers per stage": lambda: pipeline.pipeline_train_loss(
            p, toks, tgts, _cfg(tl, "tiny_gemma2", dict(n_layers=2)),
            mesh=mesh),
        "batch": lambda: pipeline.pipeline_train_loss(
            p, toks, tgts, cfg, mesh=mesh, n_micro=3),
        "lora": lambda: pipeline.pipeline_train_loss(
            {**p, "lora": {}}, toks, tgts, cfg, mesh=mesh),
        "quantized": lambda: pipeline.pipeline_train_loss(
            tl.quantize_params(p), toks, tgts, cfg, mesh=mesh)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    tmesh = pmesh.make_mesh(data=2, model=TP, device_type="cpu")
    tcfg = _cfg(tl, "tiny", dict(n_layers=1))
    try:
        tl.train_loss({**tl.init_params(tcfg, device="cpu",
                                        dtype=torch.float32), "lora": {}},
                      toks, tgts, tpi.local_config(tcfg, TP),
                      tp_axis=(tmesh, "model"))
        out["tp_lora"] = None
    except (ValueError, NotImplementedError) as e:
        out["tp_lora"] = (type(e).__name__, str(e))
    return out


def _rank(rank, world, tp_trees, pp_trees):
    torch.set_num_threads(1)
    tmesh = pmesh.make_mesh(data=2, model=TP, device_type="cpu")
    out = {"tp": {n: _tp_case(tmesh, n, t) for n, t in tp_trees.items()},
           "tp_at": (pmesh.axis_index(tmesh, "data"),
                     pmesh.axis_index(tmesh, "model"))}
    out["pp"] = {n: _pp_case(n, t) for n, t in pp_trees.items()}
    out["reject"] = _rejections(pp_trees["pp2"])
    return out


# ------------------------------------------------------------- the JAX side


def _np_tree(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_trees(jax, jnp, jl):
    """The JAX weights of every case, by case."""
    tp = {name: jl.init_params(jax.random.PRNGKey(i), _cfg(jl, ctor, kw),
                               jnp.float32)
          for i, (name, (ctor, kw)) in enumerate(TP_MODELS.items())}
    pp = {name: jl.init_params(jax.random.PRNGKey(10 + i),
                               _cfg(jl, case[0], case[1]), jnp.float32)
          for i, (name, case) in enumerate(PP_CASES.items())}
    return tp, pp


@pytest.fixture(scope="module")
def jax_side():
    """JAX's (loss, grads) of each case and its rejection messages, and
    every rank's results: the spawn of the ranks starts as soon as the
    weights exist and runs while JAX compiles."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from flash_attention_tpu.models import llama as jl
    from flash_attention_tpu.parallel import mesh as jmesh
    from flash_attention_tpu.parallel import tp_inference as jtp
    from flash_attention_tpu.parallel.pipeline import pipeline_train_loss
    tp_params, pp_params = _jax_trees(jax, jnp, jl)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    spawned = pool.submit(
        pmesh.spawn, _rank, WORLD,
        {n: _np_tree(p) for n, p in tp_params.items()},
        {n: _np_tree(p) for n, p in pp_params.items()})
    out = {"tp": {}, "pp": {}}
    mesh = jmesh.make_mesh(model=TP)
    for name, (ctor, kw) in TP_MODELS.items():
        cfg, params = _cfg(jl, ctor, kw), tp_params[name]
        toks, tgts = (jnp.asarray(a) for a in _data(cfg, 2, 1))
        specs, lcfg = jtp.tree_specs(params), jtp.local_config(cfg, TP)

        def loss(p, toks=toks, tgts=tgts, specs=specs, lcfg=lcfg):
            return jax.shard_map(
                lambda p_, t_, g_: jl.train_loss(p_, t_, g_, lcfg,
                                                 tp_axis="model"),
                mesh=mesh, in_specs=(specs, P(), P()), out_specs=P(),
                check_vma=False)(p, toks, tgts)

        val, grads = jax.jit(jax.value_and_grad(loss))(params)
        out["tp"][name] = (float(val), _np_tree(grads))
    for name, (ctor, kw, stages, m, b, dp) in PP_CASES.items():
        cfg, params = _cfg(jl, ctor, kw), pp_params[name]
        toks, tgts = (jnp.asarray(a) for a in _data(cfg, b, 2))
        devs = np.asarray(jax.devices()[:stages * dp])
        pmesh_ = (Mesh(devs.reshape(dp, stages), ("data", "pipe")) if dp > 1
                  else Mesh(devs, ("pipe",)))

        def loss(p, toks=toks, tgts=tgts, cfg=cfg, mesh=pmesh_, m=m, dp=dp):
            return pipeline_train_loss(p, toks, tgts, cfg, mesh=mesh,
                                       n_micro=m,
                                       data_axis="data" if dp > 1 else None)

        val, grads = jax.jit(jax.value_and_grad(loss))(params)
        out["pp"][name] = (float(val), _np_tree(grads))
    out["reject"] = _jax_rejections(jax, jnp, jl, pipeline_train_loss,
                                    _np_tree(pp_params["pp2"]))
    out["ranks"] = spawned.result()
    pool.shutdown()
    return out


def _jax_rejections(jax, jnp, jl, pipeline_train_loss, np_params):
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))
    cfg = jl.LlamaConfig.tiny(n_layers=4)
    p = {k: jnp.asarray(v) for k, v in np_params.items()}
    toks, tgts = (jnp.asarray(a) for a in _data(cfg, 4, 2))
    calls = {
        "n_layers": lambda: pipeline_train_loss(
            p, toks, tgts, jl.LlamaConfig.tiny(n_layers=3), mesh=mesh),
        "layers per stage": lambda: pipeline_train_loss(
            p, toks, tgts, jl.LlamaConfig.tiny_gemma2(n_layers=2), mesh=mesh),
        "batch": lambda: pipeline_train_loss(p, toks, tgts, cfg, mesh=mesh,
                                             n_micro=3),
        "lora": lambda: pipeline_train_loss({**p, "lora": {}}, toks, tgts,
                                            cfg, mesh=mesh),
        "quantized": lambda: pipeline_train_loss(jl.quantize_params(p), toks,
                                                 tgts, cfg, mesh=mesh)}
    out = {}
    for name, call in calls.items():
        with pytest.raises(ValueError) as e:
            call()
        out[name] = ("ValueError", str(e.value))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every rank's results, from one spawn of WORLD ranks."""
    return jax_side["ranks"]


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", sorted(TP_MODELS))
def test_tp_train_loss_matches_jax(ranks, jax_side, name):
    """train_loss(tp_axis=) at tp=2: the loss on every rank (both data
    groups of the (2, 2) mesh) equals JAX's through shard_map."""
    want, _ = jax_side["tp"][name]
    losses = [r["tp"][name]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want, **TOL)


@pytest.mark.parametrize("name", sorted(TP_MODELS))
def test_tp_train_grads_match_jax(ranks, jax_side, name):
    """Every leaf's gradient: a sharded leaf's parts, gathered over the
    model dim, are JAX's gradient; a replicated leaf's is JAX's whole
    gradient, bit-identical on the two model ranks."""
    _, want = jax_side["tp"][name]
    moe = name == "mixtral"
    assert [r["tp_at"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert set(ranks[0]["tp"][name]["grads"]) == set(want)
    for leaf, g in want.items():
        parts = [r["tp"][name]["grads"][leaf] for r in ranks[:TP]]
        dim = _shard_dim(leaf, moe)
        if dim is None:
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=leaf)
            got = parts[0]
        else:
            got = np.concatenate(parts, axis=dim)
        np.testing.assert_allclose(got, g, err_msg=leaf, **TOL)
        for r, twin in zip(ranks[:TP], ranks[TP:]):  # the other data group
            np.testing.assert_array_equal(r["tp"][name]["grads"][leaf],
                                          twin["tp"][name]["grads"][leaf])


@pytest.mark.parametrize("name", sorted(PP_CASES))
def test_pipeline_matches_jax(ranks, jax_side, name):
    """pipeline_train_loss: the loss, replicated on every rank, is JAX's;
    each stage's gradient is nonzero in its own layers only, and the
    stages' sum is JAX's gradient; data replicas (dp2_pp2) get the same
    bits, and so do the twin pipelines of a pp=2 case."""
    _, _, stages, _, _, dp = PP_CASES[name]
    want_loss, want = jax_side["pp"][name]
    losses = [r["pp"][name]["loss"] for r in ranks]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want_loss, **TOL)
    per = want["wq"].shape[0] // stages
    for leaf, g in want.items():
        parts = [r["pp"][name]["grads"][leaf] for r in ranks[:stages]]
        total = sum(p for p in parts if p is not None)
        np.testing.assert_allclose(total, g, err_msg=leaf, **TOL)
        if pipeline.stage_specs(want)[leaf]:
            for s, p in enumerate(parts):
                outside = np.delete(p, np.s_[s * per:(s + 1) * per], axis=0)
                assert not outside.any(), (leaf, s)
        for r, twin in zip(ranks[:stages], ranks[stages:]):
            a, b = r["pp"][name]["grads"][leaf], twin["pp"][name]["grads"][leaf]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=leaf)
    assert ranks[0]["pp"][name]["grads"]["embed"].any()
    assert ranks[stages - 1]["pp"][name]["grads"]["lm_head"].any()


def test_pipeline_takes_a_staged_tree(ranks):
    """An already staged tree (each stage its layers' slices) gives the
    loss of the full tree, bit for bit, without autograd."""
    for r in ranks:
        assert r["pp"]["pp2"]["staged_layers"] == 2
        assert r["pp"]["pp2"]["staged_loss"] == r["pp"]["pp2"]["loss"]


@pytest.mark.parametrize("case", REJECT)
def test_pipeline_rejections_match_jax(ranks, jax_side, case):
    """Each of JAX's ValueErrors (layers not dividing the stages or the
    window pattern, the batch not dividing n_micro x dp, LoRA stacks,
    quantized weights), with its message."""
    for r in ranks:
        assert r["reject"][case] == jax_side["reject"][case]


def test_tp_training_with_lora_raises(ranks):
    """LoRA stacks with tp_axis raise, as the TP engine does."""
    for r in ranks:
        kind, msg = r["reject"]["tp_lora"]
        assert kind == "NotImplementedError" and "LoRA" in msg


def test_stage_specs_split_the_layer_leaves():
    """stage_specs: per-layer leaves split their layer axis; embed, the
    final norm and the lm_head are replicated."""
    cfg = tl.LlamaConfig.tiny_moe(n_layers=2, attn_bias=True)
    specs = pipeline.stage_specs(tl.init_params(cfg, device="cpu",
                                                dtype=torch.float32))
    assert not any(specs[n] for n in ("embed", "norm_out", "lm_head"))
    assert all(specs[n] for n in ("wq", "w_router", "bq", "norm_attn"))
