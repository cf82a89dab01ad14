"""Weight-only int8/int4 quantization (the quantizers, the plain
dequantization and the quantized matmul, with its CUDA kernel) and the
per-token quantizer of the int8/fp8 KV cache.

The counterpart of the JAX package's ``ops/quant.py``:

* ``QuantizedTensor(values, scales, bits)``: the JAX layout. For a logical
  (k, n) weight, int8 values are (k, n); int4 values are (k // 2, n) int8,
  row i holding logical rows 2i (low nibble) and 2i + 1 (high nibble).
  scales are (n,) fp32, one per output channel.
* ``quantize_int8`` / ``quantize_int4``: symmetric per-channel quantizers,
  bit-identical to JAX's on the same fp32 input (the same fp32 ops in the
  same order, round half to even).
* ``dequantize``: the plain fp32 dequantization.
* ``quantized_matmul``: y = x @ dequant(w), summed in fp32 with the
  per-channel scale applied once to the sum (exact: the scale commutes with
  the contraction). A CUDA tensor launches ``csrc/qmm.cu`` (replaces
  ``_qmm_kernel``); a CPU tensor runs :func:`quantized_matmul_reference`.
  The TPU tiling knobs (``block_m/n/k``, ``interpret``) are taken at their
  JAX defaults only: the wrapper picks the kernel's variant, tile and split
  itself (:func:`plan`).
* ``quantize_kv_pages`` and ``_quantize_token`` (JAX's
  ``models/llama.py::_quantize_token``): per-token symmetric int8 or fp8
  (e4m3) quantization of K/V rows, bit-identical to JAX's. A cache page's
  scales are one (8, 128) fp32 tile whose lane t holds token t's scale
  (all 8 rows equal), the TPU's smallest DMA slice, kept as the cache's
  layout so the two packages' caches are interchangeable.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.utils.options import reject_unported

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("qmm", "qmm.cu", {
    "fat_qmm": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I,
                _I, _I, _I, _I, _P],
})
DTYPES = (torch.bfloat16, torch.float16)
# the kernel's tiles (csrc/qmm.cu): BK-deep k steps, BN weight columns (the
# wgmma M side) by 256 rows of x for m > DECODE_M, else (decode) 8 or 16
BK, BN = 64, 128
PREFILL_ROWS, DECODE_M = 256, 16
# resident CTAs per SM of each variant (shared memory: up to 217 KB a
# prefill CTA, under 63 KB a decode one)
PREFILL_CTAS_PER_SM, DECODE_CTAS_PER_SM = 1, 3
# split k only while the grid is short of one wave of resident CTAs,
# keeping at least MIN_SPLIT_STEPS k steps in each split and the grid within
# the wave: at decode more CTAs keep more weight bytes in flight, and past
# a wave the fp32 partials cost more than they hide (chip_smoke.py times the
# decode shapes with and without the split)
MIN_SPLIT_STEPS = 4
MAX_SPLITS = 32


class QuantizedTensor(NamedTuple):
    """values: int8 payload (nibble-packed for int4); scales: fp32 (n,) (or
    (L, n) for a layer stack); bits: 8 or 4."""

    values: torch.Tensor
    scales: torch.Tensor
    bits: int


def _scale(w, axis: int, qmax: float):
    """max(amax / qmax, 1e-8) in IEEE fp32. qmax is a tensor on w's device
    (made by a fill, so a CUDA graph can capture it): PyTorch's CUDA
    division by a Python scalar multiplies by its rounded reciprocal, which
    can differ from the division in the last bit."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    f32 = dict(dtype=torch.float32, device=w.device)
    return torch.maximum(amax / torch.full((), qmax, **f32),
                         torch.full((), 1e-8, **f32))


def quantize_int8(w, axis: int = 0) -> QuantizedTensor:
    """Symmetric per-channel int8; ``axis`` is the contraction (reduced)
    axis, the scales live on the remaining one."""
    w = w.float()
    scale = _scale(w, axis, 127.0)
    q = (w / scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedTensor(q, scale.squeeze(axis), 8)


# the KV cache's 8-bit types and the magnitude each maps amax to: int8's
# clip and e4m3's largest finite value
KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def _quantize_token(x, dtype=torch.int8):
    """Per-token symmetric quantization over the last axis to int8 or fp8
    (e4m3): returns (values in ``dtype``, fp32 scales with the last axis
    reduced). scale = max(amax / 127 or amax / 448, 1e-8) and x / scale in
    IEEE fp32; int8 rounds half to even and clips to +-127, fp8 rounds to
    nearest even (|x / scale| <= 448 by construction)."""
    qmax = KV_QMAX.get(dtype)
    if qmax is None:
        raise ValueError(f"unsupported KV quant dtype {dtype}")
    x = x.float()
    scale = _scale(x, -1, qmax)
    q = x / scale
    if dtype == torch.int8:
        q = q.round_().clamp_(-127, 127)
    return q.to(dtype), scale.squeeze(-1)


def quantize_kv_pages(pages, dtype=torch.int8):
    """Per-token symmetric quantization of KV pages to int8 or fp8 (e4m3).

    pages: (num_kv_heads, total_pages, page_size <= 128, head_dim) float.
    Returns (values in ``dtype``, same shape; scales (hk, pages, 8, 128)
    fp32): per page one (8, 128) tile whose lane t holds token t's scale,
    the same in all 8 rows, lanes past the page size 1.0."""
    hk, n_pages, ps, _ = pages.shape
    q, scale = _quantize_token(pages, dtype)
    lanes = torch.nn.functional.pad(scale, (0, 128 - ps), value=1.0)
    return q, lanes[:, :, None, :].expand(hk, n_pages, 8, 128).contiguous()


def quantize_int4(w, axis: int = 0) -> QuantizedTensor:
    """Symmetric per-channel int4, pairs of rows packed into int8 along
    ``axis`` (which must be 0)."""
    if axis != 0:
        raise NotImplementedError("int4 packing implemented for axis=0")
    k, _ = w.shape
    if k % 2 != 0:
        raise ValueError("contraction dim must be even for int4 packing")
    w = w.float()
    scale = _scale(w, 0, 7.0)
    q = (w / scale).round_().clamp_(-7, 7).to(torch.int32)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    return QuantizedTensor(packed.to(torch.int8), scale.squeeze(0), 4)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """The plain fp32 dequantization of a (k, n) weight."""
    v = qt.values
    if qt.bits == 4:  # sign-extend each nibble, rows 2i and 2i + 1
        lo = ((v & 0xF) ^ 8) - 8
        hi = v >> 4
        v = torch.stack([lo, hi], dim=1).reshape(2 * v.shape[0], v.shape[1])
    return v.float() * qt.scales[None, :]


def quantized_matmul_reference(x, w: QuantizedTensor, *, out_dtype=None):
    """The plain version: ``(x.float() @ dequantize(w)).to(out_dtype)``, on
    any device."""
    return torch.matmul(x.float(), dequantize(w)).to(out_dtype or x.dtype)


def plan(m: int, k: int, n: int, n_sms: int) -> tuple[int, int, int]:
    """The kernel's rows of x per tile (8 or 16: decode; 256: prefill), its
    number of k splits and the k steps per split for an (m, k) @ (k, n)
    product on a card with ``n_sms`` SMs.

    The weight is always the wgmma M side, in 128-column tiles. At a small m
    (decode, and the lm_head at its logit rows) the grid is short of the
    card's resident CTAs at most Llama widths (8 CTAs for n = 1024), and the
    product is bound by the weight's bytes, so k is split as far as the grid
    stays within one wave; each split writes an fp32 partial and a second
    pass sums them in a fixed order. Prefill splits only a grid shorter than
    half a wave of one CTA per SM."""
    if m <= DECODE_M:
        rows, per_sm = (8 if m <= 8 else 16), DECODE_CTAS_PER_SM
    else:
        rows, per_sm = PREFILL_ROWS, PREFILL_CTAS_PER_SM
    tiles = -(-m // rows) * -(-n // BN)
    k_steps = max(1, -(-k // BK))
    want = max(1, per_sm * n_sms // tiles)
    splits = max(1, min(want, MAX_SPLITS, k_steps // MIN_SPLIT_STEPS))
    per = -(-k_steps // splits)
    return rows, -(-k_steps // per), per


def _check_cuda(x, w: QuantizedTensor, out_dtype):
    if x.dtype == torch.float32:
        raise NotImplementedError("the quantized matmul kernel takes bf16 or "
                                  "fp16 activations; fp32 runs only on the "
                                  "CPU")
    if x.dtype not in DTYPES or x.dim() != 2:
        raise ValueError(f"x: the kernel takes 2D bf16 or fp16, got "
                         f"{x.dim()}D {x.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise NotImplementedError(f"out_dtype must be x's dtype or fp32, got "
                                  f"{out_dtype}")
    if w.bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {w.bits}")
    v, s = w.values, w.scales
    if v.device != x.device or s.device != x.device:
        raise ValueError("x, values and scales must be on one device")
    if v.dtype != torch.int8 or v.dim() != 2 or not v.is_contiguous():
        raise ValueError("values must be a contiguous 2D int8 tensor")
    if s.dtype != torch.float32 or s.shape != (v.shape[1],) \
            or not s.is_contiguous():
        raise ValueError("scales must be a contiguous (n,) fp32 tensor")


def quantized_matmul(x, w: QuantizedTensor, *, block_m: int = 256,
                     block_n: int = 512, block_k: int = 512, out_dtype=None,
                     interpret: bool | None = None):
    """y = x @ dequant(w): weight-only quantized matmul.

    x (m, k) activations; w a logical (k, n) ``QuantizedTensor``. Returns
    (m, n) in ``out_dtype`` (default x's dtype), summed in fp32 and scaled
    per channel before one rounding. A CUDA tensor launches
    ``csrc/qmm.cu`` (bf16 or fp16 x, out_dtype x's dtype or fp32); a CPU
    tensor runs :func:`quantized_matmul_reference`. ``block_m/n/k`` and
    ``interpret`` (the TPU kernel's tiles, Pallas interpret mode) raise
    NotImplementedError at any other value than their defaults."""
    reject_unported("quantized_matmul", block_m=(block_m, 256),
                    block_n=(block_n, 512), block_k=(block_k, 512),
                    interpret=(interpret, None))
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w, out_dtype=out_dtype)
    _check_cuda(x, w, out_dtype)
    pack = 8 // w.bits
    m, k = x.shape
    n = w.values.shape[1]
    if w.values.shape[0] * pack != k:
        raise ValueError(f"x has k = {k}; the weight's logical k is "
                         f"{w.values.shape[0] * pack}")
    values, scales = w.values, w.scales
    if n % 16:  # TMA reads weight rows 16-byte aligned
        pad = -n % 16
        values = torch.nn.functional.pad(values, (0, pad))
        scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
    np_ = values.shape[1]
    # TMA reads from 16-byte-aligned bases: a view at an odd offset is copied
    if values.data_ptr() % 16:
        values = values.clone()
    if scales.data_ptr() % 16:
        scales = scales.clone()
    if k % 8 or x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        # TMA wants 16-byte rows and base; zero columns past k meet the
        # zeros TMA reads past the weight's rows: the sum is unchanged
        x = torch.nn.functional.pad(x, (0, -k % 8)).contiguous()
    y = torch.empty((m, np_), dtype=out_dtype, device=x.device)
    if y.numel():
        n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        rows, splits, per = plan(m, k, np_, n_sms)
        ws = None
        if splits > 1 or out_dtype != x.dtype:
            ws = torch.empty((splits, m, np_), dtype=torch.float32,
                             device=x.device)
        lib = KERNEL.lib()
        rc = lib.fat_qmm(x.data_ptr(), values.data_ptr(), scales.data_ptr(),
                         y.data_ptr(), 0 if ws is None else ws.data_ptr(),
                         m, k, np_, x.stride(0), w.bits, rows, splits, per,
                         int(x.dtype == torch.float16),
                         int(out_dtype == torch.float32),
                         torch.cuda.current_stream(x.device).cuda_stream)
        KERNEL.launches += 1
        KERNEL.check(rc)
    return y[:, :n].contiguous() if np_ != n else y
