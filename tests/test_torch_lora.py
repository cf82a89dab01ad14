"""Multi-LoRA in the port against the JAX package's, on the CPU.

``models.lora``'s pieces (``init_adapter``, ``stack_adapters``,
``set_slot``, ``merge_adapter``, ``delta``) on the same numpy arrays as
JAX's, fp32 to 1e-6; ``prefill`` and ``decode_step`` with per-row adapter
ids against JAX's on ``LlamaConfig.tiny`` (2 layers, fp32) at
``tests/test_lora.py``'s 2e-4; the gradients of the stacks through
``train_loss(lora_ids=)`` against ``jax.grad`` of JAX's; the engine's mixed
batch (base, a, b) against the merged models and against the JAX engine's
greedy tokens, under ``decode_block`` and ``chunk_size`` too; prefix-cache
isolation between adapters; LoRA over an int8 base; and every ValueError of
the validation with JAX's message. Each JAX computation runs once, in a
module fixture.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import lora as jlora
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu_torch import Engine
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import lora as tlora

torch.set_num_threads(2)

JCFG, CFG = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
RANK = 4
TOL = 2e-4  # tests/test_lora.py's forward tolerance
ENGINE_KW = dict(total_pages=64, page_size=16, max_batch=4, max_seq_len=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_adapter(seed):
    """JAX's init_adapter with B filled (a fresh adapter is a no-op)."""
    ad = jlora.init_adapter(jax.random.PRNGKey(seed), JCFG, RANK, ALL)
    return {t: (a, jax.random.normal(jax.random.PRNGKey(seed + 100),
                                     b.shape, jnp.float32) * 0.05)
            for t, (a, b) in ad.items()}


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, JAX adapters a and b, port adapters)."""
    pj = jl.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    pt = tl.params_from_jax(_np(pj), "cpu", torch.float32)
    ads_j = [_jax_adapter(1), _jax_adapter(2)]
    ads_t = [tlora.adapter_from_jax(_np(a), "cpu", torch.float32)
             for a in ads_j]
    return pj, pt, ads_j, ads_t


# ------------------------------------------------------------ the module
def _unit_init(model):
    g = torch.Generator().manual_seed(0)
    ad = tlora.init_adapter(g, CFG, 8, ALL, alpha=16.0)
    want = jlora.init_adapter(jax.random.PRNGKey(0), JCFG, 8, ALL,
                              alpha=16.0)
    for t in ALL:
        a, b = ad[t]
        assert a.shape == want[t][0].shape and b.shape == want[t][1].shape
        assert a.dtype == b.dtype == torch.float32
        assert not b.any()
        # N(0, 1/din) times alpha / r = 2
        din = a.shape[1]
        std = float(a.std()) * din**0.5 / 2.0
        assert abs(std - 1.0) < 0.05, (t, std)


def _unit_stack(model):
    _, _, ads_j, ads_t = model
    want = jlora.stack_adapters(JCFG, ads_j, RANK, ALL, n_slots=4)
    got = tlora.stack_adapters(CFG, ads_t, RANK, ALL, n_slots=4,
                               device="cpu")
    for t in ALL:
        for x, y in zip(got[t], want[t]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert not got[t][0][:, 0].any() and not got[t][1][:, 0].any()


def _unit_set_slot(model):
    """Slot 2 rewritten with an adapter of wq and w_down only: its other
    targets are zeroed, as JAX's."""
    _, _, ads_j, ads_t = model
    part_j = {t: ads_j[0][t] for t in ("wq", "w_down")}
    part_t = {t: ads_t[0][t] for t in ("wq", "w_down")}
    want = jlora.set_slot(jlora.stack_adapters(JCFG, ads_j, RANK, ALL, 3), 2,
                          part_j, ALL)
    stacks = tlora.stack_adapters(CFG, ads_t, RANK, ALL, 3, device="cpu")
    got = tlora.set_slot(stacks, 2, part_t, ALL)
    for t in ALL:
        assert got[t][0] is stacks[t][0]  # in place
        for x, y in zip(got[t], want[t]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _unit_merge(model):
    pj, pt, ads_j, ads_t = model
    want = jlora.merge_adapter(pj, ads_j[0])
    got = tlora.merge_adapter(pt, ads_t[0])
    for t in want:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=1e-6, atol=1e-6)
    assert not torch.equal(got["wq"], pt["wq"])  # the base is untouched


def _unit_delta(model, three_d):
    _, _, ads_j, ads_t = model
    stacks_j = jlora.stack_adapters(JCFG, ads_j, RANK, ALL, n_slots=3)
    stacks_t = tlora.stack_adapters(CFG, ads_t, RANK, ALL, 3, device="cpu")
    shape = (3, 5, CFG.hidden_dim) if three_d else (3, CFG.hidden_dim)
    h = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ids = np.array([2, 0, 1], np.int32)
    lr_j = {t: (a[1], b[1]) for t, (a, b) in stacks_j.items()}  # layer 1
    lr_t = {t: (a[1], b[1]) for t, (a, b) in stacks_t.items()}
    want = jlora.delta(jnp.asarray(h), lr_j, "w_down", jnp.asarray(ids))
    got = tlora.delta(torch.from_numpy(h), lr_t, "w_down",
                      torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not got[1].any()  # slot 0: exactly zero
    assert tlora.delta(torch.from_numpy(h), None, "w_down", ids) is None
    lr_q = {"wq": lr_t["wq"]}
    assert tlora.delta(torch.from_numpy(h), lr_q, "w_down", ids) is None


UNITS = {"init_adapter": _unit_init, "stack_adapters": _unit_stack,
         "set_slot": _unit_set_slot, "merge_adapter": _unit_merge,
         "delta_3d": lambda m: _unit_delta(m, True),
         "delta_2d": lambda m: _unit_delta(m, False)}


@pytest.mark.parametrize("name", sorted(UNITS))
def test_lora_module_matches_jax(model, name):
    UNITS[name](model)


def test_tf32_left_off():
    """The port never turns TF32 on: ``delta``'s fp32 products stay fp32
    on the card, as JAX's einsums are fp32."""
    import flash_attention_tpu_torch  # noqa: F401 — every module imported
    from flash_attention_tpu_torch.models import import_hf  # noqa: F401
    from flash_attention_tpu_torch.serving import engine  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ------------------------------------------------------- the model's path
@pytest.fixture(scope="module")
def forward(model):
    """JAX's prefill (3, 17) with ids [0, 1, 2] and one decode step with
    ids [0, 1] over random pages; the stacks carried to the port through
    ``params_from_jax``."""
    pj, _, ads_j, _ = model
    stacks = jlora.stack_adapters(JCFG, ads_j, RANK, ALL, n_slots=4)
    toks = np.random.default_rng(0).integers(0, 255, (3, 17)).astype(np.int32)
    pre = jl.prefill({**pj, "lora": stacks}, jnp.asarray(toks), JCFG,
                     lora_ids=jnp.asarray([0, 1, 2], jnp.int32))
    L, hk, hd = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    ps, P, npp = 8, 16, 8
    rng = np.random.default_rng(1)
    kp = rng.normal(size=(L, hk, P, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(L, hk, P, ps, hd)).astype(np.float32)
    perm = rng.permutation(P)
    dec_args = (np.array([7, 7], np.int32), np.array([11, 11], np.int32),
                np.stack([perm[:npp], perm[npp:]]).astype(np.int32))
    wpage = dec_args[2][:, (11 - 1) // ps]
    woff = np.full((2,), (11 - 1) % ps, np.int32)
    dec = jl.decode_step({**pj, "lora": stacks}, jnp.asarray(kp),
                         jnp.asarray(vp), None, None,
                         *map(jnp.asarray, dec_args + (wpage, woff)), JCFG,
                         lora_ids=jnp.asarray([0, 1], jnp.int32))
    carried = tl.params_from_jax({**_np(pj), "lora": _np(stacks)}, "cpu",
                                 torch.float32)
    return (carried, toks, _np(pre), (kp, vp, dec_args, wpage, woff),
            _np(dec[:3]))


def test_prefill_with_lora_matches_jax(model, forward):
    _, pt, _, ads_t = model
    carried, toks, (lj, kj, vj), *_ = forward
    assert set(carried["lora"]) == set(ALL)
    lt, kt, vt = tl.prefill(carried, torch.from_numpy(toks), CFG,
                            lora_ids=torch.tensor([0, 1, 2]))
    for got, want in ((lt, lj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # each row is its merged model's, and the adapters are live
    for row, ad in ((1, ads_t[0]), (2, ads_t[1])):
        want, _, _ = tl.prefill(tlora.merge_adapter(pt, ad),
                                torch.from_numpy(toks[row:row + 1]), CFG)
        np.testing.assert_allclose(lt[row].numpy(), want[0].numpy(),
                                   rtol=TOL, atol=TOL)
    base, _, _ = tl.prefill(pt, torch.from_numpy(toks), CFG)
    assert torch.equal(lt[0], base[0])  # the null slot adds exactly 0
    assert float((lt[1] - base[1]).abs().max()) > 1e-2


def test_decode_step_with_lora_matches_jax(forward):
    carried, _, _, (kp, vp, dec_args, wpage, woff), (dj, kpj, vpj) = forward
    kpt, vpt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    dt, *_ = tl.decode_step(carried, kpt, vpt, None, None,
                            *map(torch.from_numpy, dec_args + (wpage, woff)),
                            CFG, lora_ids=torch.tensor([0, 1]))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kpt.numpy(), kpj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vpt.numpy(), vpj, rtol=TOL, atol=TOL)
    assert float((dt[0] - dt[1]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def grads(model):
    """jax.grad of JAX's train_loss (remat) with respect to the stacks,
    rows on slots [1, 2, 1], base frozen."""
    pj, _, ads_j, _ = model
    stacks = jlora.stack_adapters(JCFG, ads_j, RANK, ALL, n_slots=3)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 255, (3, 24)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[:, -1] = -100
    ids = np.array([1, 2, 1], np.int32)

    def loss(st):
        return jl.train_loss({**pj, "lora": st}, jnp.asarray(toks),
                             jnp.asarray(tgt), JCFG,
                             lora_ids=jnp.asarray(ids))
    value, g = jax.value_and_grad(loss)(stacks)
    return _np(stacks), toks, tgt, ids, float(value), _np(g)


def test_train_loss_stack_grads_match_jax(model, grads):
    _, pt, _, _ = model
    stacks, toks, tgt, ids, value, g = grads
    leaves = tlora.adapter_from_jax(stacks, "cpu", torch.float32)
    for a, b in leaves.values():
        a.requires_grad_()
        b.requires_grad_()
    loss = tl.train_loss({**pt, "lora": leaves}, torch.from_numpy(toks),
                         torch.from_numpy(tgt), CFG,
                         lora_ids=torch.from_numpy(ids))
    loss.backward()
    assert abs(float(loss.detach()) - value) <= TOL * abs(value)
    assert all(w.grad is None for w in pt.values())  # the base is frozen
    for t in ALL:
        for got, want in zip(leaves[t], g[t]):
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=t)
        assert not leaves[t][0].grad[:, 0].any()  # slot 0: no row on it


def test_train_loss_zero_b_starts_at_the_base(model):
    """With B = 0 (init_adapter's adapter) the loss is the base model's
    bit for bit, dA is exactly 0 and dB is not."""
    _, pt, _, _ = model
    ad = tlora.init_adapter(torch.Generator().manual_seed(3), CFG, RANK, ALL)
    leaves = tlora.stack_adapters(CFG, [ad], RANK, ALL, 2, device="cpu")
    for a, b in leaves.values():
        a.requires_grad_()
        b.requires_grad_()
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 255, (2, 16)))
    tgt = torch.roll(toks, -1, 1)
    loss = tl.train_loss({**pt, "lora": leaves}, toks, tgt, CFG,
                         lora_ids=torch.tensor([1, 1]))
    loss.backward()
    with torch.no_grad():
        base = tl.train_loss(pt, toks, tgt, CFG)
    assert float(loss.detach()) == float(base)
    for t in ALL:
        assert not leaves[t][0].grad.any(), t
        assert leaves[t][1].grad[:, 1].any(), t


# ------------------------------------------------------------- the engine
def _greedy_dense(params, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        logits, _, _ = tl.prefill(params, torch.tensor([toks]), CFG,
                                  return_kv=False)
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def _serve(params, adapters, jobs, **kw):
    """The port's LoRA engine over ``jobs`` [(prompt, adapter name)]."""
    eng = Engine(CFG, params, lora_rank=RANK, lora_targets=ALL,
                 **{**ENGINE_KW, **kw})
    for name, ad in adapters.items():
        eng.add_adapter(name, ad)
    reqs = [eng.add_request(p, max_new_tokens=6, lora=name)
            for p, name in jobs]
    eng.run()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    return [r.output for r in reqs], eng


PROMPT = list(map(int, np.random.default_rng(2).integers(0, 255, 40)))
JOBS = [(PROMPT, None), (PROMPT, "a"), (PROMPT, "b"), (PROMPT[:23], "a")]


@pytest.fixture(scope="module")
def jax_engine(model):
    """The JAX engine's greedy tokens on the mixed batch."""
    pj, _, ads_j, _ = model
    eng = JaxEngine(JCFG, pj, kv_dtype=jnp.float32, lora_rank=RANK,
                    lora_targets=ALL, **ENGINE_KW)
    eng.add_adapter("a", ads_j[0])
    eng.add_adapter("b", ads_j[1])
    reqs = [eng.add_request(p, max_new_tokens=6, lora=n) for p, n in JOBS]
    eng.run()
    assert all(r.error is None for r in reqs)
    return [r.output for r in reqs]


def test_engine_mixed_batch_matches_merged_and_jax(model, jax_engine):
    _, pt, _, ads_t = model
    adapters = dict(zip("ab", ads_t))
    outs, eng = _serve(pt, adapters, JOBS)
    assert eng.stats["prefill_dispatches"] == 1  # one mixed batch
    merged = {None: pt, **{n: tlora.merge_adapter(pt, a)
                           for n, a in adapters.items()}}
    assert outs == [_greedy_dense(merged[n], p, 6) for p, n in JOBS]
    assert len({tuple(o) for o in outs[:3]}) == 3  # adapters diverge
    assert outs == jax_engine


@pytest.mark.parametrize("kw", [dict(decode_block=4), dict(chunk_size=16)],
                         ids=["decode_block", "chunk_size"])
def test_engine_lora_options_keep_tokens(model, jax_engine, kw):
    """Multi-step decode and chunked prefill (40 tokens in chunks of 16)
    emit the same tokens on the mixed batch."""
    _, pt, _, ads_t = model
    outs, eng = _serve(pt, dict(zip("ab", ads_t)), JOBS, **kw)
    assert outs == jax_engine
    if "chunk_size" in kw:
        assert eng.stats["prefill_chunks"] == 3


def test_prefix_cache_isolates_adapters(model):
    """The same prompt under another adapter (or the base) adopts none of
    an adapter's cached pages; the same adapter reuses them all."""
    _, pt, _, ads_t = model
    eng = Engine(CFG, pt, lora_rank=RANK, lora_targets=ALL,
                 prefix_cache=True, **ENGINE_KW)
    eng.add_adapter("a", ads_t[0])
    outs = []
    for name in ("a", None, "a"):
        r = eng.add_request(PROMPT, max_new_tokens=4, lora=name)
        eng.run()
        assert r.error is None, r.error
        outs.append(r.output)
        if name is None:
            assert eng.stats.get("prefix_reused_tokens", 0) == 0
    assert eng.stats["prefix_reused_tokens"] == 2 * 16
    assert outs[2] == outs[0]
    assert outs[1] == _greedy_dense(pt, PROMPT, 4)
    assert outs[0] == _greedy_dense(tlora.merge_adapter(pt, ads_t[0]),
                                    PROMPT, 4)


def test_lora_over_int8_base_matches_jax(model):
    """The delta follows the quantized matmul: prefill logits of an int8
    base with the stacks against JAX's, and the engine's adapter rows
    differ from its base rows."""
    pj, _, ads_j, ads_t = model
    qj = jl.quantize_params(pj, bits=8)
    stacks = jlora.stack_adapters(JCFG, ads_j, RANK, ALL, n_slots=3)
    toks = np.random.default_rng(4).integers(0, 255, (2, 12)).astype(np.int32)
    want, _, _ = jl.prefill({**qj, "lora": stacks}, jnp.asarray(toks), JCFG,
                            lora_ids=jnp.asarray([0, 2], jnp.int32))
    qt = tl.params_from_jax({**_np(qj), "lora": _np(stacks)}, "cpu",
                            torch.float32)
    got, _, _ = tl.prefill(qt, torch.from_numpy(toks), CFG,
                           lora_ids=torch.tensor([0, 2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    base = {k: v for k, v in qt.items() if k != "lora"}
    outs, _ = _serve(base, {"a": ads_t[0]},
                     [(PROMPT[:12], None), (PROMPT[:12], "a")])
    assert outs[0] != outs[1]


# ---------------------------------------------------------- the validation
def _moe_params(jax_side):
    cfg = (jl if jax_side else tl).LlamaConfig.tiny_moe(n_layers=1)
    if jax_side:
        p = jl.init_params(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
        st = jlora.stack_adapters(cfg, [], RANK, ("wq",), 2)
    else:
        p = tl.init_params(cfg, device="cpu", dtype=torch.float32)
        st = tlora.stack_adapters(cfg, [], RANK, ("wq",), 2, device="cpu")
    return {**p, "lora": st}, cfg


def _cases(model):
    """(name, JAX call, port call): each must raise ValueError."""
    pj, pt, ads_j, ads_t = model
    toks_j, toks_t = jnp.zeros((1, 4), jnp.int32), torch.zeros(
        (1, 4), dtype=torch.int64)
    sj = jlora.stack_adapters(JCFG, [], RANK, ("wq",), 2)
    st = tlora.stack_adapters(CFG, [], RANK, ("wq",), 2, device="cpu")
    wq_j = {"wq": ads_j[0]["wq"]}
    wq_t = {"wq": ads_t[0]["wq"]}
    kw = dict(ENGINE_KW, max_seq_len=64)

    def eng(side, **extra):
        if side == "jax":
            return JaxEngine(JCFG, pj, kv_dtype=jnp.float32, **kw, **extra)
        return Engine(CFG, pt, **kw, **extra)

    def full(side):
        e = eng(side, lora_rank=RANK, max_loras=1)
        e.add_adapter("a", wq_j if side == "jax" else wq_t)
        return e

    def moe(side):
        p, cfg = _moe_params(side == "jax")
        if side == "jax":
            return lambda: jl.prefill(p, toks_j, cfg,
                                      lora_ids=jnp.zeros(1, jnp.int32))
        return lambda: tl.prefill(p, toks_t, cfg, lora_ids=[0])

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))
    return {
        "prefill_without_ids": (
            lambda: jl.prefill({**pj, "lora": sj}, toks_j, JCFG),
            lambda: tl.prefill({**pt, "lora": st}, toks_t, CFG)),
        "train_loss_without_ids": (
            lambda: jl.train_loss({**pj, "lora": sj}, toks_j, toks_j, JCFG),
            lambda: tl.train_loss({**pt, "lora": st}, toks_t, toks_t, CFG)),
        "moe": (lambda: moe("jax")(), lambda: moe("port")()),
        "unknown_adapter": (
            lambda: eng("jax", lora_rank=RANK).add_request([1, 2], 2,
                                                           lora="x"),
            lambda: eng("port", lora_rank=RANK).add_request([1, 2], 2,
                                                            lora="x")),
        "already_registered": (
            lambda: full("jax").add_adapter("a", wq_j),
            lambda: full("port").add_adapter("a", wq_t)),
        "capacity": (
            lambda: full("jax").add_adapter("b", wq_j),
            lambda: full("port").add_adapter("b", wq_t)),
        "without_lora_rank": (
            lambda: eng("jax").add_adapter("a", wq_j),
            lambda: eng("port").add_adapter("a", wq_t)),
        "wrong_target": (
            lambda: eng("jax", lora_rank=RANK).add_adapter(
                "a", {"w_up": ads_j[0]["w_up"]}),
            lambda: eng("port", lora_rank=RANK).add_adapter(
                "a", {"w_up": ads_t[0]["w_up"]})),
        "speculative": (
            lambda: eng("jax", lora_rank=RANK, draft_cfg=JCFG,
                        draft_params=pj),
            lambda: eng("port", lora_rank=RANK, draft_cfg=CFG,
                        draft_params=pt)),
        "mesh": (
            lambda: eng("jax", lora_rank=RANK, mesh=mesh),
            lambda: eng("port", lora_rank=RANK, mesh=mesh)),
    }


CASES = ("already_registered", "capacity", "mesh", "moe",
         "prefill_without_ids", "speculative", "train_loss_without_ids",
         "unknown_adapter", "without_lora_rank", "wrong_target")


@pytest.mark.parametrize("case", CASES)
def test_validation_raises_jax_errors(model, case):
    jax_call, port_call = _cases(model)[case]
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_decode_and_chunk_without_ids_raise(model):
    """decode_step and prefill_chunk raise prefill's error (JAX's) when the
    stacks come without ids, before touching the cache."""
    _, pt, _, _ = model
    st = tlora.stack_adapters(CFG, [], RANK, ("wq",), 2, device="cpu")
    p = {**pt, "lora": st}
    msg = "params carry LoRA stacks but no lora_ids given"
    pages = torch.zeros((2, 2, 4, 16, 128))
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        tl.decode_step(p, pages, pages.clone(), None, None, one, one,
                       torch.zeros((1, 2), dtype=torch.int32), one * 0,
                       one * 0, CFG)
    with pytest.raises(ValueError, match=msg):
        tl.prefill_chunk(p, torch.zeros((1, 4), dtype=torch.int64), [0], [4],
                         pages, pages.clone(), None, None, [[0]], CFG)
    # ids without stacks are ignored, as in JAX
    a, _, _ = tl.prefill(pt, torch.zeros((1, 4), dtype=torch.int64), CFG,
                         lora_ids=[3])
    b, _, _ = tl.prefill(pt, torch.zeros((1, 4), dtype=torch.int64), CFG)
    assert torch.equal(a, b)


def test_engine_ids_pad_to_slot_zero(model):
    """Padding rows of a dispatch ride slot 0; ids are a device tensor."""
    _, pt, _, ads_t = model
    eng = Engine(CFG, pt, lora_rank=RANK, lora_targets=ALL, **ENGINE_KW)
    eng.add_adapter("a", ads_t[0])
    eng.add_adapter("b", ads_t[1])
    reqs = [eng.add_request([1, 2, 3], 2, lora=n) for n in ("b", None, "a")]
    ids = eng._lora_ids(reqs, 4)
    assert ids.tolist() == [2, 0, 1, 0] and isinstance(ids, torch.Tensor)
    assert set(eng._model_params()) == set(pt) | {"lora"}
    base = Engine(CFG, pt, **ENGINE_KW)
    assert base._lora_ids(reqs, 4) is None and base._model_params() is pt
