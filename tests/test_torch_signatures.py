"""Every public function of the port takes the JAX package's parameters.

For each module that both packages have, every public function (and every
public method of a public class) defined in the port's module and present
in the JAX one must take the same parameter names in the same order, with
the same kinds (positional or keyword-only), so a call written for one
package binds on the other. Each difference is listed below with its
reason: the port's own extensions (``PORT_EXTRA``), JAX parameters the
port does not take (``JAX_ONLY``), and functions whose signatures
differ as a whole (``DIFFERENT``). Each test also fails on an entry that no
longer differs, so the lists cannot outlive what they describe. The
options the port takes only at their defaults raise NotImplementedError
naming them (``test_unported_options_raise``).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

MODULES = ("models.checkpoint", "models.llama", "ops.attention",
           "ops.flash_bwd", "ops.flash_fwd", "ops.kv_update", "ops.moe",
           "ops.paged_attention", "ops.quant", "ops.reference",
           "ops.segments", "serving.engine", "serving.native",
           "serving.sampling", "serving.scheduler", "utils.debug_inputs",
           "utils.metrics")

# port-only parameters: each an extension of the port
PORT_EXTRA = {
    "models.checkpoint.load_checkpoint": ("device",),
    # the lm_head at one row per sequence, as prefill's logit_rows
    "models.llama.prefill_chunk": ("logit_rows",),
    "ops.paged_attention.paged_attention_reference": ("layer",),
    "ops.reference.reference_attention": ("empty_lse",),
    "serving.engine.Engine.run": ("on_step",),
    "utils.debug_inputs.identity_sequence": ("device",),
    "utils.debug_inputs.identity_batch": ("device",),
    "utils.debug_inputs.identity_packed": ("device",),
}
# JAX parameters the port does not take: the plain attention always
# returns (o, lse)
JAX_ONLY = {
    "ops.reference.reference_attention": ("return_lse",),
}
# signatures that differ as a whole
DIFFERENT = {
    # a seed and a device where JAX takes a PRNG key
    "models.llama.init_params",
    # the kernels' wrappers take the CUDA kernels' arguments; JAX's take
    # the Pallas kernels' (segments, positions, block sizes, interpret)
    "ops.flash_fwd.flash_fwd",
    "ops.flash_bwd.flash_bwd",
    # the plain backward takes the band and softcap as arguments; JAX's
    # takes a dict of mask arguments
    "ops.reference.reference_attention_bwd",
}


def _pairs():
    """(qualified name, port object, JAX object) of every public function
    and method the two packages share, in the modules they share."""
    out = []
    for mod in MODULES:
        pm = importlib.import_module(f"flash_attention_tpu_torch.{mod}")
        jm = importlib.import_module(f"flash_attention_tpu.{mod}")
        for name, obj in vars(pm).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != pm.__name__ or not hasattr(jm, name):
                continue
            jobj = getattr(jm, name)
            if inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if (meth == "__init__" or not meth.startswith("_")) \
                            and inspect.isfunction(fn) \
                            and hasattr(jobj, meth):
                        out.append((f"{mod}.{name}.{meth}", fn,
                                    getattr(jobj, meth)))
            elif inspect.isfunction(obj):
                out.append((f"{mod}.{name}", obj, jobj))
    return out


PAIRS = {name: (p, j) for name, p, j in _pairs()}


def _params(fn, drop=()):
    """(name, kind) of each parameter, the names in ``drop`` left out."""
    return [(p.name, p.kind) for p in
            inspect.signature(inspect.unwrap(fn)).parameters.values()
            if p.name not in drop]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_jax(name):
    port, jax_fn = PAIRS[name]
    got = _params(port, PORT_EXTRA.get(name, ()))
    want = _params(jax_fn, JAX_ONLY.get(name, ()))
    if name in DIFFERENT:
        assert got != want, f"{name} now matches JAX: take it off DIFFERENT"
        return
    assert got == want, f"{name}: port {got} != JAX {want}"
    for extra in PORT_EXTRA.get(name, ()):
        assert extra not in inspect.signature(jax_fn).parameters, name
    for missing in JAX_ONLY.get(name, ()):
        assert missing not in inspect.signature(port).parameters, name


def test_the_lists_name_shared_functions():
    """Every name in the three lists is a function both packages have, and
    the JAX engine's public methods all exist in the port's."""
    for name in (*PORT_EXTRA, *JAX_ONLY, *DIFFERENT):
        assert name in PAIRS, name
    from flash_attention_tpu.serving.engine import Engine as JaxEngine
    from flash_attention_tpu_torch import Engine
    for meth in vars(JaxEngine):
        if not meth.startswith("_") and callable(getattr(JaxEngine, meth)):
            assert hasattr(Engine, meth), f"Engine.{meth}"


def _engine():
    from flash_attention_tpu_torch import Engine
    from flash_attention_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    return Engine(cfg, params, total_pages=8, page_size=16, max_batch=2,
                  max_seq_len=64)


def _unported_calls():
    """(option, call) of each option the port takes at its default only,
    each call setting that option alone to another value."""
    import flash_attention_tpu_torch as fat
    from flash_attention_tpu_torch.models import llama
    from flash_attention_tpu_torch.ops import moe
    q = torch.zeros((1, 8, 2, 64))
    o, lse = fat.fwd(q, q, q, True)
    pages = torch.zeros((1, 1, 2, 16, 64))
    qt = fat.quantize_int8(torch.ones((32, 32)))
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    calls = [("block_sizes", lambda: fat.fwd(q, q, q, block_sizes=1)),
             ("interpret", lambda: fat.fwd(q, q, q, interpret=True)),
             ("kv_split", lambda: fat.fwd(q, q, q, kv_split=2)),
             ("block_sizes", lambda: fat.bwd(q, q, q, o, lse, q,
                                             block_sizes=1)),
             ("interpret", lambda: fat.bwd(q, q, q, o, lse, q,
                                           interpret=False)),
             ("pages_per_block", lambda: fat.paged_attention(
                 q[:, 0], pages, pages, torch.ones(1, dtype=torch.int32),
                 torch.zeros((1, 1), dtype=torch.int32), layer=0,
                 pages_per_block=4)),
             ("interpret", lambda: fat.write_token_kv(
                 pages, pages, None, None, q[:, 0, :1], q[:, 0, :1], None,
                 None, torch.zeros(1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), 0, True)),
             ("block_m", lambda: fat.quantized_matmul(
                 torch.ones((2, 32)), qt, block_m=128)),
             ("interpret", lambda: fat.quantized_matmul(
                 torch.ones((2, 32)), qt, interpret=True)),
             ("block_k", lambda: moe.grouped_matmul(
                 torch.ones((4, 8)), torch.ones((1, 8, 8)),
                 torch.zeros(1, dtype=torch.int32), block_k=256)),
             ("interpret", lambda: moe.moe_ffn(
                 torch.ones((2, 8)), torch.ones((8, 2)), None, None, None,
                 n_top=1, act=torch.relu, interpret=True)),
             ("kv_fake_quant", lambda: llama.prefill(
                 params, toks, cfg, None, torch.int8)),
             ("lora_ids", lambda: llama.prefill(params, toks, cfg,
                                                lora_ids=[0])),
             ("lora_ids", lambda: llama.decode_step(
                 params, None, None, None, None, toks[:, 0], None, None,
                 None, None, cfg, None, [0])),
             ("lora", lambda: _engine().add_request([1, 2], 2, lora="a")),
             ("add_adapter", lambda: _engine().add_adapter("a", {}))]
    return calls


# options of the list above that the port now takes: their calls run
PORTED = {"kv_fake_quant"}


@pytest.mark.parametrize("i", range(16))
def test_unported_options_raise(i):
    """Each option the port takes only at its JAX default raises
    NotImplementedError naming it at another value (Engine.add_adapter, LoRA
    registration, always raises); an option since ported (``PORTED``) runs
    at that value instead (prefill with ``kv_fake_quant``: finite
    logits)."""
    calls = _unported_calls()
    assert len(calls) == 16
    option, call = calls[i]
    if option in PORTED:
        logits, _, _ = call()
        assert torch.isfinite(logits).all()
        return
    with pytest.raises(NotImplementedError, match=option):
        call()


def test_failure_dump_writes_aux(tmp_path, monkeypatch):
    """``assert_metrics``' ``aux`` arrays and the worst elements land in the
    ``FAT_FAIL_DUMP`` directory when a gate fails, as in the JAX package."""
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    monkeypatch.setenv("FAT_FAIL_DUMP", str(tmp_path))
    assert_metrics("ok", np.ones(3), np.ones(3), aux={"lse": np.ones(3)})
    assert not list(tmp_path.iterdir())
    with pytest.raises(AssertionError, match="parity gate failed"):
        assert_metrics("bad", np.ones(3), np.zeros(3),
                       aux={"lse": torch.ones(3)})
    names = sorted(p.suffix for p in tmp_path.iterdir())
    assert names == [".csv", ".json", ".npz"]
    aux = np.load(next(tmp_path.glob("*.npz")))
    np.testing.assert_array_equal(aux["lse"], np.ones(3, np.float32))
