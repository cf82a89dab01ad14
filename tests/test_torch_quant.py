"""The port's weight quantization against the JAX package's, on the CPU.

The quantizers must give values and scales bit-identical to JAX's on the
same fp32 input (including exact .5 ties after the division, rounded half
to even); ``dequantize`` must equal JAX's; ``quantized_matmul`` (the plain
version on the CPU) is held to JAX's Pallas kernel in interpret mode at the
shapes of ``tests/test_quant.py`` with max relative error < 1e-5, that
file's gate. Checkpoints written by either package load in the other. The
card-only kernel tests are in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX reference; skip where it is not installed

import jax
import jax.numpy as jnp

from flash_attention_tpu.models import checkpoint as jckpt
from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.ops import quant as jq
from flash_attention_tpu_torch.models import checkpoint as tckpt
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

QUANT = {8: (jq.quantize_int8, tq.quantize_int8),
         4: (jq.quantize_int4, tq.quantize_int4)}


def _ties(bits):
    """A (6, 4) weight whose columns' amax is exactly qmax, so the scale is
    1.0 and w / scale keeps every .5 tie; one column is all zero (scale
    clamped to 1e-8)."""
    q = 127.0 if bits == 8 else 7.0
    w = np.array([[q, 0.5, -2.5, 0.0],
                  [1.5, q, 3.5, 0.0],
                  [-0.5, -1.5, -q, 0.0],
                  [2.5, 4.5, 0.5, 0.0],
                  [-3.5, -q, 5.5, 0.0],
                  [6.5, 2.5, -6.5, 0.0]], np.float32)
    return w


def _weights(bits):
    rng = np.random.default_rng(bits)
    yield _ties(bits)
    for shape in ((512, 512), (64, 200), (514, 896), (2, 1)):
        yield rng.standard_normal(shape).astype(np.float32) * 0.1


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_bit_identical_to_jax(bits):
    qj, qt = QUANT[bits]
    for w in _weights(bits):
        a, b = qj(jnp.asarray(w)), qt(torch.from_numpy(w))
        assert b.bits == a.bits == bits
        assert b.values.dtype == torch.int8 and b.scales.dtype == torch.float32
        np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
        np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a.scales))
        np.testing.assert_array_equal(tq.dequantize(b).numpy(),
                                      np.asarray(jq.dequantize(a)))
    # the ties rounded half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    t = qt(torch.from_numpy(_ties(bits)))
    if bits == 8:
        assert t.values[3, 0] == 2 and t.values[4, 0] == -4
        assert t.values[0, 1] == 0


def test_int8_other_axis_matches_jax():
    w = np.random.default_rng(1).standard_normal((40, 24)).astype(np.float32)
    a, b = jq.quantize_int8(jnp.asarray(w), axis=1), \
        tq.quantize_int8(torch.from_numpy(w), axis=1)
    np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
    np.testing.assert_array_equal(b.scales.numpy(), np.asarray(a.scales))


def test_int4_errors_match_jax():
    w = np.ones((5, 4), np.float32)
    for quant in (jq.quantize_int4, tq.quantize_int4):
        src = jnp.asarray(w) if quant is jq.quantize_int4 else \
            torch.from_numpy(w)
        with pytest.raises(ValueError):
            quant(src)
        with pytest.raises(NotImplementedError):
            quant(src[:4], axis=1)


# tests/test_quant.py's shapes: m in {8, 100} at (512, 512), and the pad
# shapes (320, 200) and (514, 896) at m = 16
MM_CASES = [(8, 512, 512), (100, 512, 512), (16, 320, 200), (16, 514, 896)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", MM_CASES)
def test_quantized_matmul_matches_jax(bits, m, k, n):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    qj, qt = QUANT[bits]
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), qj(jnp.asarray(w))))
    launches = tq.KERNEL.launches
    got = tq.quantized_matmul(torch.from_numpy(x), qt(torch.from_numpy(w)))
    assert tq.KERNEL.launches == launches  # the CPU runs the plain version
    assert got.shape == (m, n) and got.dtype == torch.float32
    rel = np.max(np.abs(got.numpy() - want)) / (np.max(np.abs(want)) + 1e-9)
    assert rel < 1e-5, rel


def test_quantized_matmul_out_dtype():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    w = tq.quantize_int8(torch.from_numpy(rng.normal(size=(64, 32)).astype(
        np.float32)))
    y = tq.quantized_matmul(x.to(torch.bfloat16), w, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    torch.testing.assert_close(
        y, x.to(torch.bfloat16).float() @ tq.dequantize(w))
    assert tq.quantized_matmul(x.to(torch.bfloat16), w).dtype == torch.bfloat16


@pytest.mark.parametrize("m,k,n,want", [
    # Llama-3-8B decode (8 rows; wq/wo, wk/wv, gate/up, down, lm_head): the
    # weight on the M side in 128-column tiles, k split as far as the grid
    # stays within one wave of 3 CTAs per SM of 132
    (8, 4096, 4096, (8, 11, 6)), (8, 4096, 1024, (8, 16, 4)),
    (8, 4096, 14336, (8, 3, 22)), (8, 14336, 4096, (8, 12, 19)),
    (8, 4096, 128256, (8, 1, 64)),
    # Llama-3-8B prefill (8 x 2048 rows): 256 rows of x a tile, no split
    (16384, 4096, 4096, (256, 1, 64)), (16384, 4096, 1024, (256, 1, 64)),
    (16384, 4096, 14336, (256, 1, 64)), (16384, 14336, 4096, (256, 1, 224)),
    # the decode variant's two widths and the prefill tile's first m
    (9, 4096, 1024, (16, 16, 4)), (16, 4096, 4096, (16, 11, 6)),
    (17, 4096, 4096, (256, 4, 16)),
    # ragged and short: at least 4 k steps a split; empty k
    (100, 512, 512, (256, 2, 4)), (7, 200, 208, (8, 1, 4)),
    (1, 0, 128, (8, 1, 1)),
])
def test_plan(m, k, n, want):
    rows, splits, per = tq.plan(m, k, n, 132)
    assert (rows, splits, per) == want
    steps = max(1, -(-k // tq.BK))
    assert (splits - 1) * per < steps <= splits * per  # no split is empty


def test_quantize_params_rejects_moe():
    cfg = tl.LlamaConfig.tiny_moe(n_layers=1, vocab_size=64, dim=128,
                                  hidden_dim=256)
    params = tl.init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        tl.quantize_params(params)
    with pytest.raises(ValueError):
        tl.quantize_params(tl.init_params(tl.LlamaConfig.tiny(n_layers=1),
                                          device="cpu"), bits=5)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jl.LlamaConfig.tiny(n_layers=1, vocab_size=64)
    return jl.init_params(jax.random.PRNGKey(2), cfg, dtype=jnp.float32)


def _assert_same(port, ref):
    """A port parameter dict equals a JAX one, leaf for leaf and bit for
    bit, QuantizedTensors included."""
    assert sorted(port) == sorted(ref)
    for name, r in ref.items():
        p = port[name]
        if isinstance(r, jq.QuantizedTensor):
            assert isinstance(p, tq.QuantizedTensor) and p.bits == r.bits
            pairs = [(p.values, r.values), (p.scales, r.scales)]
        else:
            pairs = [(p, r)]
        for a, b in pairs:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_jax_to_port(tmp_path, jax_params, bits):
    qj = jl.quantize_params(jax_params, bits=bits)
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, qj)
    loaded = tckpt.load_checkpoint(path, device="cpu")
    assert loaded["wq"].values.dtype == torch.int8
    _assert_same(loaded, qj)


@pytest.mark.parametrize("bits", [8, 4])
def test_checkpoint_port_to_jax(tmp_path, jax_params, bits):
    pt = tl.params_from_jax({k: np.asarray(v) for k, v in jax_params.items()},
                            "cpu", torch.float32)
    qt = tl.quantize_params(pt, bits=bits)
    path = str(tmp_path / "t.npz")
    tckpt.save_checkpoint(path, qt)
    loaded = jckpt.load_checkpoint(path)
    assert isinstance(loaded["lm_head"], jq.QuantizedTensor)
    _assert_same(qt, loaded)


def test_checkpoint_port_bf16_roundtrip(tmp_path):
    """bf16 has no numpy dtype: it is stored as raw 2-byte records (|V2),
    as np.savez stores an ml_dtypes bf16 array, and read back as bf16; a
    JAX bf16 checkpoint loads the same way. ``dtype`` casts float leaves."""
    params = tl.init_params(tl.LlamaConfig.tiny(n_layers=1, vocab_size=64),
                            seed=1, device="cpu", dtype=torch.bfloat16)
    params = tl.quantize_params(params, bits=4)
    path = str(tmp_path / "b.npz")
    tckpt.save_checkpoint(path, params)
    with np.load(path) as data:
        assert data["embed"].dtype == np.dtype("V2")
    loaded = tckpt.load_checkpoint(path, device="cpu")
    assert loaded["embed"].dtype == torch.bfloat16
    assert torch.equal(loaded["embed"], params["embed"])
    assert torch.equal(loaded["w_down"].values, params["w_down"].values)
    cast = tckpt.load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert cast["norm_out"].dtype == torch.float32
    assert cast["wq"].values.dtype == torch.int8  # never cast
    jpath = str(tmp_path / "jb.npz")
    jckpt.save_checkpoint(jpath, {"embed": jnp.arange(6, dtype=jnp.bfloat16)})
    assert torch.equal(tckpt.load_checkpoint(jpath, device="cpu")["embed"],
                       torch.arange(6, dtype=torch.bfloat16))
