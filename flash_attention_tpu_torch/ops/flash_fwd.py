"""Flash-attention forward: the band helper and the CUDA kernel's wrapper.

The kernel (``csrc/flash_fwd.cu``) replaces the JAX package's Pallas
``_fwd_kernel``. It reads q (b, sq, h, d) and k/v (b, sk, hk, d) in bf16 or
fp16 through their strides and writes O (b, sq, h, d) and LSE (b, h, sq)
fp32, under a band of relative offsets (causal, a sliding window, or both)
and an optional softcap. The kernel masks its own ragged edges, so nothing
is padded here.
It loads by TMA through tensor maps built from the strides, so the data
must be 16-byte aligned and the strides multiples of 16 bytes: ``_prepare``
copies an input that is not into a fresh tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flash_attention_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = _build.Kernel("flash_fwd", "flash_fwd.cu", {
    "fat_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                      _I, _F, _F, _F, _I, _P],
})
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float16)


def normalize_band(causal: bool, window) -> tuple | None:
    """Fold ``causal`` and a flash-attn-style ``window_size`` into one band.

    Returns (left, right) with ``None`` meaning unbounded on that side, or
    ``None`` when no banding applies at all (dense). Window entries < 0 mean
    unbounded; causal clamps the right bound to 0."""
    if window is None:
        return (None, 0) if causal else None
    wl, wr = window
    wl = None if wl is None or wl < 0 else int(wl)
    wr = None if wr is None or wr < 0 else int(wr)
    if causal:
        wr = 0 if wr is None else min(wr, 0)
    if wl is None and wr is None:
        return (None, 0) if causal else None
    return (wl, wr)


def band_args(causal: bool, window) -> tuple[int, int]:
    """The kernels' (left, right) band arguments, -1 for an unbounded side
    (both -1: dense)."""
    band = normalize_band(causal, window)
    if band is None:
        return -1, -1
    return tuple(-1 if x is None else x for x in band)


def softcap_args(softcap, sm_scale: float) -> tuple[float, float]:
    """The kernels' softcap arguments (scale / cap, cap log2 e): the
    division is done here, never in the kernel; (0, 0) runs the instance
    without the softcap."""
    if softcap is None:
        return 0.0, 0.0
    if not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return sm_scale / softcap, softcap * math.log2(math.e)


def _prepare(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as the kernels take it: raises on what they cannot take, and
    returns a fresh copy of an input that TMA cannot read in place (a stride
    that is not a multiple of 8 elements, or data not 16-byte aligned).
    ``.contiguous()`` alone would keep a misaligned storage offset."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: the kernel takes bf16 or fp16, got {x.dtype}")
    if x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(f"{name} must be (b, s, h, d) with a contiguous head dim")
    # a dim of extent 1 is never stepped (the tensor map packs its stride)
    if any(st % 8 for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1) \
            or x.data_ptr() % 16:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
    return x


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float,
              empty_lse: float = 0.0, window=None, softcap=None):
    """Launch the CUDA forward kernel. Returns (o, lse). ``window`` is a
    (left, right) sliding window (entries < 0 unbounded), folded with
    ``causal`` by :func:`normalize_band`; ``softcap`` squashes the scaled
    scores to ``softcap * tanh(s / softcap)``."""
    q, k, v = (_prepare(x, name) for x, name in ((q, "q"), (k, "k"),
                                                  (v, "v")))
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if h % hk:
        raise ValueError(f"num_heads {h} must be divisible by num_heads_k {hk}")
    left, right = band_args(causal, window)
    cap_scale, cap_log2 = softcap_args(softcap, sm_scale)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = KERNEL.lib()
    rc = lib.fat_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, sk, h, hk, d, ctypes.cast(strides, ctypes.c_void_p),
        sm_scale * math.log2(math.e), left, right, cap_scale, cap_log2,
        float(empty_lse),
        int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return o, lse
