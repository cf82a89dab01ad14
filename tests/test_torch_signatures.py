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
naming them (``test_unported_options_raise``). Every public name of the JAX
package (each function and class a module defines, and each name a
package's ``__all__`` exports) exists in the port's module of the same
path, or ``JAX_NOT_PORTED`` gives the reason it does not
(``test_every_jax_name_is_in_the_port``).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

MODULES = ("models.checkpoint", "models.import_hf", "models.llama",
           "models.lora", "ops.attention",
           "ops.flash_bwd", "ops.flash_fwd", "ops.kv_update", "ops.moe",
           "ops.paged_attention", "ops.quant", "ops.reference",
           "ops.segments", "serving.engine", "serving.multistep",
           "serving.native", "serving.prefix", "serving.sampling",
           "serving.scheduler", "serving.spec", "utils.debug_inputs",
           "utils.metrics", "parallel.mesh", "parallel.pipeline",
           "parallel.sharded_attention", "parallel.tp_inference")

# port-only parameters: each an extension of the port
PORT_EXTRA = {
    "models.checkpoint.load_checkpoint": ("device",),
    # the HF import builds each weight on its device, layer by layer
    "models.import_hf.from_hf_state_dict": ("device",),
    "models.import_hf.from_hf": ("device",),
    # the stacks are allocated on the engine's device
    "models.lora.stack_adapters": ("device",),
    # the lm_head at one row per sequence, as prefill's logit_rows
    "models.llama.prefill_chunk": ("logit_rows",),
    "ops.paged_attention.paged_attention_reference": ("layer",),
    "ops.reference.reference_attention": ("empty_lse",),
    "serving.engine.Engine.run": ("on_step",),
    "utils.debug_inputs.identity_sequence": ("device",),
    "utils.debug_inputs.identity_batch": ("device",),
    "utils.debug_inputs.identity_packed": ("device",),
    # the mesh lies over the ranks' process group, on the device type the
    # caller names (JAX's takes a list of devices)
    "parallel.mesh.make_mesh": ("device_type",),
    # the lm_head at one row per sequence, as prefill_chunk's logit_rows
    "parallel.tp_inference.tp_prefill_chunk": ("logit_rows",),
    # a rank passes its own blocks (JAX's shard_map takes global arrays
    # and cuts them itself)
    "parallel.sharded_attention.shard_flash_attention": ("local",),
}
# JAX parameters the port does not take: the plain attention always
# returns (o, lse)
JAX_ONLY = {
    "ops.reference.reference_attention": ("return_lse",),
    # a rank is a process: the mesh takes the whole world, not a device list
    "parallel.mesh.make_mesh": ("devices",),
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


# JAX public names the port lacks, each with its reason
_TILES = "a TPU tiling knob: the CUDA kernels choose their own tiles"
JAX_NOT_PORTED = {
    "BlockSizes": _TILES,
    "ops.BlockSizes": _TILES,
    "ops.configs.BlockSizes": _TILES,
    "ops.paged_attention.MultiPageCopy": (
        "the TPU kernel's multi-page DMA; the CUDA kernel loads pages by TMA"),
    "ops.segments.clamp_for_dma": (
        "clamps block indices for the TPU's DMA; the CUDA kernels read their "
        "tile ranges from ops.segments.block_ranges"),
    "parallel.tp_inference.param_specs": (
        "PartitionSpecs for shard_map; each rank slices its part with "
        "parallel.tp_inference.shard_params"),
    "parallel.tp_inference.tree_specs": (
        "PartitionSpecs for shard_map; each rank slices its part with "
        "parallel.tp_inference.shard_params"),
}


def _jax_public_names():
    """The qualified names (module path under the package, then the name)
    of every public function and class the JAX package's modules define,
    and of every name its packages' ``__all__`` export; private modules
    (``ops._mxu``) left out."""
    import flash_attention_tpu
    mods = [""] + [m.name[len("flash_attention_tpu."):] for m in
                   pkgutil.walk_packages(flash_attention_tpu.__path__,
                                         "flash_attention_tpu.")]
    for rel in mods:
        if any(part.startswith("_") for part in rel.split(".")):
            continue
        jm = importlib.import_module(
            "flash_attention_tpu" + ("." + rel if rel else ""))
        names = {n for n, o in vars(jm).items() if not n.startswith("_")
                 and (inspect.isfunction(o) or inspect.isclass(o))
                 and getattr(o, "__module__", None) == jm.__name__}
        names |= set(getattr(jm, "__all__", ()))
        yield from ((rel, n) for n in sorted(names))


def test_every_jax_name_is_in_the_port():
    """Each JAX public name exists in the port's module of the same path,
    or JAX_NOT_PORTED says why not; no entry there names one that exists."""
    missing = set()
    for rel, name in _jax_public_names():
        try:
            pm = importlib.import_module(
                "flash_attention_tpu_torch" + ("." + rel if rel else ""))
        except ImportError:
            pm = None
        if pm is None or not hasattr(pm, name):
            missing.add(f"{rel}.{name}" if rel else name)
    assert not missing - set(JAX_NOT_PORTED), sorted(
        missing - set(JAX_NOT_PORTED))
    assert not set(JAX_NOT_PORTED) - missing, sorted(
        set(JAX_NOT_PORTED) - missing)


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


def _lora_engine(registered=False):
    """A 1-layer LoRA engine on the CPU, with a fresh adapter registered
    as "a" when ``registered``."""
    from flash_attention_tpu_torch import Engine
    from flash_attention_tpu_torch.models import llama, lora
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    eng = Engine(cfg, params, total_pages=8, page_size=16, max_batch=2,
                 max_seq_len=64, lora_rank=2)
    if registered:
        eng.add_adapter("a", lora.init_adapter(torch.Generator(), cfg, 2))
    return eng


def _unported_calls():
    """(option, call) of each option the port takes at its default only,
    each call setting that option alone to another value."""
    import flash_attention_tpu_torch as fat
    from flash_attention_tpu_torch.models import llama, lora
    from flash_attention_tpu_torch.ops import moe
    q = torch.zeros((1, 8, 2, 64))
    o, lse = fat.fwd(q, q, q, True)
    pages = torch.zeros((1, 1, 2, 16, 64))
    qt = fat.quantize_int8(torch.ones((32, 32)))
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    params = llama.init_params(cfg, device="cpu", dtype=torch.float32)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with_lora = {**params, "lora": lora.stack_adapters(
        cfg, [lora.init_adapter(torch.Generator(), cfg, 2)], 2,
        ("wq", "wk", "wv", "wo"), 2, device="cpu")}
    kv = torch.zeros((1, 2, 2, 16, 128))
    one = torch.ones(1, dtype=torch.int32)
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
             ("lora_ids", lambda: llama.prefill(with_lora, toks, cfg,
                                                lora_ids=[1])),
             ("lora_ids", lambda: llama.decode_step(
                 with_lora, kv, kv.clone(), None, None, toks[:, 0], one,
                 one[None] * 0, one * 0, one * 0, cfg, None, [1])),
             ("lora", lambda: _lora_engine(True).add_request([1, 2], 2,
                                                             lora="a")),
             ("add_adapter", lambda: _lora_engine().add_adapter(
                 "a", lora.init_adapter(torch.Generator(), cfg, 2)))]
    return calls


def _split_runs(call) -> bool:
    """The call (fwd with kv_split=2 over 8 keys: four chunks) gives finite
    values, and on random inputs the split equals the one-launch call in
    the forward gates."""
    import flash_attention_tpu_torch as fat
    from flash_attention_tpu_torch.utils.metrics import assert_metrics
    assert all(torch.isfinite(x).all() for x in call())
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 64),
                                             dtype=np.float32))
    o, lse = fat.fwd(q, q, q, True, kv_split=2)
    want, want_lse = fat.fwd(q, q, q, True)
    tols = {"atol": 5e-3, "mean_atol": 2e-4, "mean_rtol": 1e-2}
    assert_metrics("o[kv_split]", o.numpy(), want.numpy(), tols)
    assert_metrics("lse[kv_split]", lse.numpy(), want_lse.numpy(), tols)
    return True


# options of the list above that the port now takes: their calls run and
# are checked (prefill with ``kv_fake_quant`` and prefill and decode_step
# with ``lora_ids`` on a slot of an adapter with B = 0: finite logits;
# ``kv_split``: the split forward against the one-launch one; the request
# on adapter "a" gets its slot; ``add_adapter`` returns the first one)
PORTED = {"kv_fake_quant": lambda call: torch.isfinite(call()[0]).all(),
          "kv_split": _split_runs,
          "lora_ids": lambda call: torch.isfinite(call()[0]).all(),
          "lora": lambda call: call().lora_id == 1,
          "add_adapter": lambda call: call() == 1}


@pytest.mark.parametrize("i", range(16))
def test_unported_options_raise(i):
    """Each option the port takes only at its JAX default raises
    NotImplementedError naming it at another value; an option since ported
    (``PORTED``) runs at that value instead."""
    calls = _unported_calls()
    assert len(calls) == 16
    option, call = calls[i]
    if option in PORTED:
        assert PORTED[option](call)
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


@pytest.mark.parametrize("shape", [(0,), (7,), (1000, 37)])
def test_card_metrics_match_numpy(shape, monkeypatch):
    """The card-side pass of ``error_metrics`` (fp32 chunks, fp64 sums),
    run here on CPU tensors with chunks of 11 elements, gives the numpy
    path's six metrics."""
    from flash_attention_tpu_torch.utils import metrics
    rng = np.random.default_rng(0)
    test = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)
    ref = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    want = metrics.error_metrics(test, ref)
    monkeypatch.setattr(metrics, "_CHUNK", 11)
    got = metrics._error_metrics_on(torch.device("cpu"), test, ref, 1e-6)
    for name, value in vars(want).items():
        assert getattr(got, name) == pytest.approx(value, rel=1e-5,
                                                   abs=1e-12), name
