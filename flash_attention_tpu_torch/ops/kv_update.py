"""In-place paged-KV token write.

Each decode step writes one token's K/V per sequence into its page slot of
the layer-stacked cache (L, hk, P, page_size, d), in place: on a CUDA tensor
through the hand-written kernels of ``csrc/kv_update.cu`` (which replace the
JAX package's Pallas ``_kv_write_kernel``), on a CPU tensor through plain
indexed assignment. Unlike the JAX function, which returned new (aliased)
buffers, this one mutates the caller's tensors and returns them.

A quantized cache (int8 or fp8 e4m3 pages with (L, hk, P, 8, 128) fp32
scale tiles, lane t of a page's tile = token t's scale in all 8 rows) is
written by ``write_token_kv`` from rows already quantized, as in JAX, or by
``quantize_write_token_kv`` from the bf16 rows, which quantizes them per
token (``ops.quant._quantize_token``) inside the same launch: the decode
step's one launch a layer.

Rows narrower than the cache (a head dim the kernels run zero-padded, in a
cache allocated at ``ops.attention.kernel_head_dim``: d 96 in a cache 128
wide, d 320 in one 384 wide) land zero-padded to the cache's width: on the
card the kernels read them at their own stride and write the zero columns
themselves (no padded copy); the plain versions pad them first. The
padding's zeros leave a row's amax, and so its scale, unchanged. The
quantizing kernel's instances are d 64, 128, 256, 384 and 512; an 8-bit
cache of another width raises on the card.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.paged_attention import pad_head_dim
from flash_attention_tpu_torch.ops.quant import KV_QMAX, _quantize_token
from flash_attention_tpu_torch.utils.options import reject_unported

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("kv_update", "kv_update.cu", {
    "fat_kv_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fat_kv_write_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P],
})
# fat_kv_write_quant's modes: rows already in the cache's type, or bf16 rows
# quantized in the kernel to the cache's type
STORE = 0
QUANTIZE = {torch.int8: 1, torch.float8_e4m3fn: 2}
HEAD_DIMS_QUANT = (64, 128, 256, 384, 512)


def write_token_kv_reference(k_pages, v_pages, kval, vval, wpage, woff,
                             layer=None):
    """Plain version: ``pages[layer, :, wpage[b], woff[b]] = val[b]``
    (8-bit pages move as bytes)."""
    kp = k_pages if layer is None else k_pages[int(layer)]
    vp = v_pages if layer is None else v_pages[int(layer)]
    kval, vval = kval.to(kp.dtype), vval.to(vp.dtype)
    if kp.element_size() == 1:
        kp, vp, kval, vval = (x.view(torch.uint8) for x in (kp, vp, kval, vval))
    wpage, woff = wpage.long(), woff.long()
    kp[:, wpage, woff] = kval.transpose(0, 1)
    vp[:, wpage, woff] = vval.transpose(0, 1)


def _write_scales_reference(scales, sc, wpage, woff, layer):
    """Scale tiles (hk, P, 8, 128): lane t of a page's tile = token t."""
    s = scales if layer is None else scales[int(layer)]
    # the two index arrays around a slice put (b, hk) first: (b, hk, 8)
    s[:, wpage.long(), :, woff.long()] = sc[..., None].float()


def _stacked(k_pages, v_pages, layer):
    """The pools as (L, hk, P, ps, d) and the layer index, checked."""
    if k_pages.dim() == 5 and layer is None:
        raise ValueError("a layer-stacked (5D) cache needs the layer index")
    pk = k_pages if k_pages.dim() == 5 else k_pages[None]
    pv = v_pages if v_pages.dim() == 5 else v_pages[None]
    layer = 0 if layer is None else int(layer)
    if not 0 <= layer < pk.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, {pk.shape[0]})")
    if pv.shape != pk.shape or pv.dtype != pk.dtype:
        raise ValueError("k_pages and v_pages must match")
    return pk, pv, layer


def _check_width(kval, vval, pk):
    """Raises unless the rows are at most the cache's head dim wide (a
    cache at the kernels' width may hold a narrower model's K/V)."""
    width = pk.shape[-1]
    if kval.shape[-1] > width or vval.shape[-1] != kval.shape[-1]:
        raise ValueError(f"k/v rows of one width, at most the cache's head "
                         f"dim {width}")


def _to_width(kval, vval, pk):
    """The rows (checked by :func:`_check_width`) zero-padded to the
    cache's head dim, as the plain versions take them."""
    width = pk.shape[-1]
    return pad_head_dim(kval, width), pad_head_dim(vval, width)


def _check_cuda(named, b, hk, d, wpage, woff):
    for name, x in named.items():
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, x in (("kval", named["kval"]), ("vval", named["vval"])):
        if x.shape != (b, hk, d):
            raise ValueError(f"{name} must be {(b, hk, d)}")
    if wpage.dtype != torch.int32 or woff.dtype != torch.int32 or \
            wpage.shape != (b,) or woff.shape != (b,) or \
            not wpage.is_cuda or not woff.is_cuda:
        raise ValueError("wpage/woff must be (b,) int32 CUDA tensors")


def _launch_quant(pk, pv, ks, vs, kval, vval, kscale, vscale, wpage, woff,
                  layer, mode):
    """The quantized cache's kernel: checks its pools and scale tiles, then
    launches ``mode`` (STORE, or a QUANTIZE value). Rows narrower than the
    cache are written zero-padded by the kernel."""
    L, hk, total_pages, page_size, d = pk.shape
    b, d_in = kval.shape[0], kval.shape[-1]
    if pk.dtype not in KV_QMAX:
        raise ValueError(f"a quantized cache holds int8 or float8_e4m3fn, "
                         f"not {pk.dtype}")
    if d not in HEAD_DIMS_QUANT:
        raise ValueError(f"an 8-bit cache of head dim {d}: the kernel takes "
                         f"{HEAD_DIMS_QUANT}; allocate the cache at "
                         f"kernel_head_dim({d}), as the engine does")
    if page_size > 128:
        raise ValueError(f"page_size {page_size} above the scale tile's 128 "
                         f"lanes")
    for name, s in (("k_scales", ks), ("v_scales", vs)):
        if s.dtype != torch.float32 or s.shape != (L, hk, total_pages, 8, 128):
            raise ValueError(f"{name} must be {(L, hk, total_pages, 8, 128)} "
                             f"fp32")
    named = {"k_pages": pk, "v_pages": pv, "k_scales": ks, "v_scales": vs,
             "kval": kval, "vval": vval}
    if mode == STORE:
        named.update(kscale=kscale, vscale=vscale)
        if kval.dtype != pk.dtype or vval.dtype != pk.dtype:
            raise ValueError("kval/vval must already be in the cache dtype")
        for name, s in (("kscale", kscale), ("vscale", vscale)):
            if s.dtype != torch.float32 or s.shape != (b, hk):
                raise ValueError(f"{name} must be {(b, hk)} fp32")
    elif kval.dtype != torch.bfloat16 or vval.dtype != torch.bfloat16:
        raise ValueError("the quantizing write takes bf16 rows")
    _check_cuda(named, b, hk, d_in, wpage, woff)
    if b == 0:
        return
    lib = KERNEL.lib()
    rc = lib.fat_kv_write_quant(
        pk.data_ptr(), pv.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        kval.data_ptr(), vval.data_ptr(),
        0 if kscale is None else kscale.data_ptr(),
        0 if vscale is None else vscale.data_ptr(), wpage.data_ptr(),
        woff.data_ptr(), b, hk, layer, total_pages, page_size, d, d_in, mode,
        torch.cuda.current_stream(pk.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)


def write_token_kv(k_pages, v_pages, k_scales, v_scales, kval, vval, kscale,
                   vscale, wpage, woff, layer=None,
                   interpret: bool | None = None):
    """Write one token row per sequence into its page slot, in place.

    k_pages/v_pages: (hk, P, ps, d) or layer-stacked (L, hk, P, ps, d) with
    ``layer`` an int; kval/vval (b, hk, d) in the cache dtype; wpage/woff
    (b,) int32. With k_scales/v_scales ((L,) hk, P, 8, 128) fp32 the cache
    is quantized (int8 or fp8 e4m3 pages, ps <= 128): kval/vval are already
    quantized and kscale/vscale (b, hk) fp32 land in lane woff of all 8 rows
    of the page's scale tile. Rows that share a target slot race on CUDA;
    only the trash page may be shared. ``interpret`` (Pallas interpret
    mode) raises off its default. Returns (k_pages, v_pages, k_scales,
    v_scales), the same tensors."""
    reject_unported("write_token_kv", interpret=(interpret, None))
    pk, pv, li = _stacked(k_pages, v_pages, layer)
    _check_width(kval, vval, pk)
    quantized = k_scales is not None
    if k_pages.device.type == "cpu":
        kval, vval = _to_width(kval, vval, pk)
        write_token_kv_reference(k_pages, v_pages, kval, vval, wpage, woff,
                                 layer)
        if quantized:
            _write_scales_reference(k_scales, kscale, wpage, woff, layer)
            _write_scales_reference(v_scales, vscale, wpage, woff, layer)
        return k_pages, v_pages, k_scales, v_scales
    if quantized:
        ks = k_scales if k_scales.dim() == 5 else k_scales[None]
        vs = v_scales if v_scales.dim() == 5 else v_scales[None]
        _launch_quant(pk, pv, ks, vs, kval, vval, kscale, vscale, wpage,
                      woff, li, STORE)
        return k_pages, v_pages, k_scales, v_scales
    _, hk, total_pages, page_size, d = pk.shape
    b = kval.shape[0]
    if (kval.shape[-1] * kval.element_size()) % 16:
        # the kernel reads rows in 16-byte chunks: a row that is not whole
        # chunks goes zero-padded to the cache's width
        kval, vval = _to_width(kval, vval, pk)
    _check_cuda({"k_pages": pk, "v_pages": pv, "kval": kval, "vval": vval},
                b, hk, kval.shape[-1], wpage, woff)
    if kval.dtype != pk.dtype or vval.dtype != pk.dtype:
        raise ValueError("kval/vval must already be in the cache dtype")
    row_bytes = d * pk.element_size()
    if row_bytes % 16:
        raise ValueError("rows must be whole 16-byte chunks")
    if b == 0:
        return k_pages, v_pages, k_scales, v_scales
    lib = KERNEL.lib()
    rc = lib.fat_kv_write(
        pk.data_ptr(), pv.data_ptr(), kval.data_ptr(), vval.data_ptr(),
        wpage.data_ptr(), woff.data_ptr(), b, hk, li, total_pages,
        page_size, row_bytes, kval.shape[-1] * kval.element_size(),
        torch.cuda.current_stream(pk.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return k_pages, v_pages, k_scales, v_scales


def quantize_write_token_kv(k_pages, v_pages, k_scales, v_scales, k, v,
                            wpage, woff, layer=None):
    """Quantize one token row per sequence to the cache's type and write it
    with its scale, in place: ``_quantize_token`` then :func:`write_token_kv`
    on the quantized cache, in one launch on CUDA (bf16 rows). k/v (b, hk, d);
    the other arguments as in :func:`write_token_kv`. Returns the four
    tensors."""
    if k_scales is None or v_scales is None:
        raise ValueError("quantize_write_token_kv needs the scale tiles")
    if k_pages.dtype not in QUANTIZE:
        raise ValueError(f"a quantized cache holds int8 or float8_e4m3fn, "
                         f"not {k_pages.dtype}")
    pk, pv, li = _stacked(k_pages, v_pages, layer)
    _check_width(k, v, pk)
    if k_pages.device.type == "cpu":
        k, v = _to_width(k, v, pk)
        kq, ksc = _quantize_token(k, k_pages.dtype)
        vq, vsc = _quantize_token(v, v_pages.dtype)
        return write_token_kv(k_pages, v_pages, k_scales, v_scales, kq, vq,
                              ksc, vsc, wpage, woff, layer)
    ks = k_scales if k_scales.dim() == 5 else k_scales[None]
    vs = v_scales if v_scales.dim() == 5 else v_scales[None]
    _launch_quant(pk, pv, ks, vs, k, v, None, None, wpage, woff, li,
                  QUANTIZE[pk.dtype])
    return k_pages, v_pages, k_scales, v_scales
