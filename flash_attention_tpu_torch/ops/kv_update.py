"""In-place paged-KV token write.

Each decode step writes one token's K/V per sequence into its page slot of
the layer-stacked cache (L, hk, P, page_size, d), in place: on a CUDA tensor
through the hand-written kernel ``csrc/kv_update.cu`` (which replaces the
JAX package's Pallas ``_kv_write_kernel``), on a CPU tensor through plain
indexed assignment. Unlike the JAX function, which returned new (aliased)
buffers, this one mutates the caller's tensors and returns them.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.utils.options import reject_unported

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("kv_update", "kv_update.cu", {
    "fat_kv_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
})


def write_token_kv_reference(k_pages, v_pages, kval, vval, wpage, woff,
                             layer=None):
    """Plain version: ``pages[layer, :, wpage[b], woff[b]] = val[b]``."""
    kp = k_pages if layer is None else k_pages[int(layer)]
    vp = v_pages if layer is None else v_pages[int(layer)]
    wpage, woff = wpage.long(), woff.long()
    kp[:, wpage, woff] = kval.transpose(0, 1).to(kp.dtype)
    vp[:, wpage, woff] = vval.transpose(0, 1).to(vp.dtype)


def _write_scales_reference(scales, sc, wpage, woff, layer):
    """Scale tiles (hk, P, 8, 128): lane t of a page's tile = token t."""
    s = scales if layer is None else scales[int(layer)]
    # the two index arrays around a slice put (b, hk) first: (b, hk, 8)
    s[:, wpage.long(), :, woff.long()] = sc[..., None].float()


def write_token_kv(k_pages, v_pages, k_scales, v_scales, kval, vval, kscale,
                   vscale, wpage, woff, layer=None,
                   interpret: bool | None = None):
    """Write one token row per sequence into its page slot, in place.

    k_pages/v_pages: (hk, P, ps, d) or layer-stacked (L, hk, P, ps, d) with
    ``layer`` an int; kval/vval (b, hk, d) in the cache dtype; wpage/woff
    (b,) int32. k_scales/v_scales ((L,) hk, P, 8, 128) fp32 with kscale/vscale
    (b, hk) are the quantized cache (plain version only so far). Rows that
    share a target slot race on CUDA; only the trash page may be shared.
    ``interpret`` (Pallas interpret mode) raises off its default. Returns
    (k_pages, v_pages, k_scales, v_scales), the same tensors."""
    reject_unported("write_token_kv", interpret=(interpret, None))
    if k_pages.dim() == 5 and layer is None:
        raise ValueError("a layer-stacked (5D) cache needs the layer index")
    quantized = k_scales is not None
    if k_pages.device.type == "cpu":
        write_token_kv_reference(k_pages, v_pages, kval, vval, wpage, woff,
                                 layer)
        if quantized:
            _write_scales_reference(k_scales, kscale, wpage, woff, layer)
            _write_scales_reference(v_scales, vscale, wpage, woff, layer)
        return k_pages, v_pages, k_scales, v_scales
    if quantized:
        raise NotImplementedError("the quantized KV write runs only in the "
                                  "plain version (CPU) so far")
    pk = k_pages if k_pages.dim() == 5 else k_pages[None]
    pv = v_pages if v_pages.dim() == 5 else v_pages[None]
    L, hk, total_pages, page_size, d = pk.shape
    b = kval.shape[0]
    layer = 0 if layer is None else int(layer)
    for x, name in ((pk, "k_pages"), (pv, "v_pages"), (kval, "kval"),
                    (vval, "vval"), (wpage, "wpage"), (woff, "woff")):
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if pv.shape != pk.shape or pv.dtype != pk.dtype:
        raise ValueError("k_pages and v_pages must match")
    if kval.shape != (b, hk, d) or vval.shape != (b, hk, d):
        raise ValueError(f"kval/vval must be {(b, hk, d)}")
    if kval.dtype != pk.dtype or vval.dtype != pk.dtype:
        raise ValueError("kval/vval must already be in the cache dtype")
    if wpage.dtype != torch.int32 or woff.dtype != torch.int32 or \
            wpage.shape != (b,) or woff.shape != (b,):
        raise ValueError("wpage/woff must be (b,) int32")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    row_bytes = d * pk.element_size()
    if row_bytes % 16 or any(x.data_ptr() % 16 for x in (pk, pv, kval, vval)):
        raise ValueError("rows must be whole 16-byte chunks, 16-byte aligned")
    if b == 0:
        return k_pages, v_pages, k_scales, v_scales
    lib = KERNEL.lib()
    rc = lib.fat_kv_write(
        pk.data_ptr(), pv.data_ptr(), kval.data_ptr(), vval.data_ptr(),
        wpage.data_ptr(), woff.data_ptr(), b, hk, layer, total_pages,
        page_size, row_bytes, torch.cuda.current_stream(pk.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return k_pages, v_pages, k_scales, v_scales
