"""The port's weight-only quantized Llama against the JAX package's, on the
CPU.

``LlamaConfig.tiny()`` in fp32, int8 and int4: JAX's ``quantize_params``
carried across with ``params_from_jax`` must equal the port's
``quantize_params`` of the carried fp32 params bit for bit. On those
weights, prefill logits and one decode step agree to max abs 1e-4 (both
sides fp32; JAX scales the fp32 sum of x·q, the plain version sums x·(q·s),
which differ by fp32 rounding only), and the engine emits the JAX engine's
greedy tokens.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.serving.engine import Engine as JaxEngine
from flash_attention_tpu_torch import Engine, QuantizedTensor
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops import quant

torch.set_num_threads(2)

ATOL = 1e-4
PS, NPAGES = 16, 16


@pytest.fixture(scope="module")
def fp32():
    pj = jl.init_params(jax.random.PRNGKey(4), jl.LlamaConfig.tiny(),
                        dtype=jnp.float32)
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu",
                            torch.float32)
    return pj, pt


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def model(request, fp32):
    bits = request.param
    pj = jl.quantize_params(fp32[0], bits=bits)
    carried = tl.params_from_jax(jax.tree.map(np.asarray, pj), "cpu",
                                 torch.float32)
    return bits, pj, carried, tl.quantize_params(fp32[1], bits=bits)


def _close(a, b, what):
    err = float(np.max(np.abs(a.numpy() - np.asarray(b))))
    assert err <= ATOL, f"{what}: max abs {err:.3e} > {ATOL}"


def test_quantize_params_matches_jax(model):
    bits, pj, carried, own = model
    assert sorted(carried) == sorted(own) == sorted(pj)
    for name, w in own.items():
        c = carried[name]
        if isinstance(w, QuantizedTensor):
            assert isinstance(c, QuantizedTensor) and c.bits == w.bits == bits
            assert c.values.dtype == torch.int8
            assert c.scales.dtype == torch.float32
            assert torch.equal(c.values, w.values), name
            assert torch.equal(c.scales, w.scales), name
        else:
            assert torch.equal(c, w), name
    L, D = 2, 256
    pack = 8 // bits
    assert own["wq"].values.shape == (L, D // pack, 512)
    assert own["w_down"].scales.shape == (L, D)
    assert own["lm_head"].values.shape == (D // pack, 256)


def test_prefill_and_decode_match_jax(model):
    """Prefill logits of a (2, 40) batch, then one decode step of row 0 on
    pages written from the prefill of its first 39 tokens."""
    _, pj, pt, _ = model
    cfg_j, cfg_t = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    toks = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    lj, _, _ = jl.prefill(pj, jnp.asarray(toks), cfg_j)
    before = quant.KERNEL.launches
    lt, _, _ = tl.prefill(pt, torch.from_numpy(toks), cfg_t)
    assert quant.KERNEL.launches == before  # the CPU runs the plain version
    _close(lt, lj, "prefill logits")

    L, hk = cfg_t.n_layers, cfg_t.n_kv_heads
    shape = (L, hk, NPAGES, PS, 128)
    _, kj, vj = jl.prefill(pj, jnp.asarray(toks[:1, :39]), cfg_j)
    ids = np.arange(3, dtype=np.int32)
    kpj, vpj, _, _ = jl.write_prefill_to_pages(
        jnp.zeros(shape), jnp.zeros(shape), (kj, vj), jnp.asarray(ids),
        jnp.zeros(3, jnp.int32), jnp.asarray(ids), PS)
    _, kt, vt = tl.prefill(pt, torch.from_numpy(toks[:1, :39]), cfg_t)
    kpt, vpt = torch.zeros(shape), torch.zeros(shape)
    tl.write_prefill_to_pages(kpt, vpt, (kt, vt), torch.from_numpy(ids),
                              torch.zeros(3, dtype=torch.int32),
                              torch.from_numpy(ids), PS)
    args = ([toks[0, 39]], [40], [[0, 1, 2]], [2], [39 % PS])
    dj, *_ = jl.decode_step(pj, kpj, vpj, None, None,
                            *(jnp.asarray(np.asarray(a, np.int32))
                              for a in args), cfg_j)
    dt, *_ = tl.decode_step(pt, kpt, vpt, None, None,
                            *(torch.tensor(a, dtype=torch.int32)
                              for a in args), cfg_t)
    _close(dt, dj, "decode logits")
    _close(dt[0], lj[0, -1], "decode vs the JAX prefill")


# (seed, prompt sizes, new tokens): two short requests, one batch
ENGINE_CASE = (6, (5, 23), 5)


def test_engine_greedy_matches_jax(model):
    _, pj, pt, _ = model
    seed, sizes, n_new = ENGINE_CASE
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, 255, size=n))) for n in sizes]
    kw = dict(total_pages=48, page_size=16, max_batch=2, max_seq_len=128)
    jeng = JaxEngine(jl.LlamaConfig.tiny(), pj, kv_dtype=jnp.float32, **kw)
    jreqs = [jeng.add_request(p, max_new_tokens=n_new) for p in prompts]
    jeng.run()
    eng = Engine(tl.LlamaConfig.tiny(), pt, **kw)
    reqs = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    for r, jr in zip(reqs, jreqs):
        assert r.error is None
        assert r.output == jr.output, (r.output, jr.output)


def test_train_loss_on_quantized_params_raises(model):
    _, _, pt, _ = model
    toks = torch.tensor([[1, 2, 3, 4]])
    with pytest.raises(NotImplementedError):
        tl.train_loss(pt, toks, toks.roll(-1, 1), tl.LlamaConfig.tiny())
