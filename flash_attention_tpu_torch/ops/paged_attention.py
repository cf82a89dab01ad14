"""Paged-attention decode: one new query token per sequence against a paged
KV cache.

On a CUDA tensor the call launches the hand-written kernel
``csrc/paged_attention.cu`` at d 64, 128 and 256, ``csrc/paged_attention_
wide.cu`` at d 384 and 512 (both replace the JAX package's Pallas
``_paged_attn_kernel``); on a CPU tensor it runs the plain version
``paged_attention_reference``. The kernel walks each row's own pages, so the
JAX package's pages-per-block grouping and its padding of the page-table
width are not needed (a table padded that way is still accepted).

The kernel splits each (row, kv head) pair's tokens into chunks that
``plan`` chooses from the table's width (or a sliding window's span), b, hk
and the SM count, never from ``lengths``: a call reads nothing back to the
host and can be captured in a CUDA graph. Chunks write fp32 partials to a workspace from PyTorch's
allocator, and the last chunk of each pair merges them, found by a per-pair
counter that the kernel leaves at zero (one counter buffer per device:
calls on one device run one at a time, in stream order).

A quantized cache (int8 or fp8 e4m3 pages of 128 tokens, with the
(L, hk, P, 8, 128) fp32 scale tiles of ``ops.quant.quantize_kv_pages``)
runs the kernel's quantized instances, which fold each token's scales into
the scores and the probabilities as the TPU kernel does.

Any head dim up to 512 runs: the kernels' instances are d 64, 128, 256,
384 and 512, and a cache allocated at ``kernel_head_dim(d)`` (the engine's)
holds each token's K/V zero-padded to that width, so q is padded to the
cache's width and O sliced back, with the softmax scale of the real d. A
cache at another width is padded to the kernel's by a copy on each call.
Any GQA group runs: a CTA takes up to ``max_group(d)`` query heads of a kv
head (8 at d <= 256; 64 at d 384 and 512, whose kernel puts them all on the
wgmma M side), and a larger group is split into sub-groups over the launch
grid, each sub-group's CTAs reading the kv head's pages again.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.ops.attention import kernel_head_dim
from flash_attention_tpu_torch.ops.flash_fwd import softcap_args
from flash_attention_tpu_torch.utils.options import reject_unported

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_PAGED_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P]
KERNEL = _build.Kernel(
    "paged_attention", ("paged_attention.cu", "paged_attention_wide.cu"),
    {"fat_paged_attention": _PAGED_ARGS,
     "fat_paged_attention_wide": _PAGED_ARGS})
# the kernel's page types besides q's own: its kv_type argument
KV_TYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}
QUANT_PAGE_SIZE = 128  # a scale tile's lane = a token of its page
HEAD_DIMS = (64, 128, 256, 384, 512)
WIDE_HEAD_DIMS = (384, 512)  # paged_attention_wide.cu's
MAX_GROUP = 8  # query heads of a CTA; a larger group splits over the grid
MAX_GROUP_WIDE = 64  # the same at d 384 and 512
TILE = 64  # tokens per tile of the kernel's ring
_LOG2E = math.log2(math.e)
# The split: about CHUNKS_PER_SM live chunks a SM when every row is full,
# each at least MIN_CHUNK_TILES tiles (a chunk pays its start and its partial
# once), and at most MAX_CHUNKS a pair (the merge's weights in shared memory;
# csrc/paged_attention.cu).
CHUNKS_PER_SM = 8
MIN_CHUNK_TILES = 4
MAX_CHUNKS = 64
# device index -> (SM count, the per-pair counters: int32 zeros)
_DEVICES: dict[int, tuple[int, torch.Tensor]] = {}


def plan(pages_per_seq: int, page_size: int, b: int, hk: int,
         n_sms: int, window: int | None = None) -> tuple[int, int]:
    """The kernel's chunk of each (row, kv head) pair, in 64-token tiles,
    and the number of chunks, for a table of ``pages_per_seq`` pages of
    ``page_size`` tokens. Depends on the shapes (and the static window)
    only, never on lengths: the chunks cover the table's every page, or
    with a window of W tokens the ceil(W / 64) + 1 tiles its tokens can
    touch (they start at the tile of the window's first token), and a chunk
    past a row's length exits at once on the card."""
    tiles = max(1, -(-pages_per_seq * page_size // TILE))
    if window is not None:
        tiles = min(tiles, -(-window // TILE) + 1)
    want = max(1, -(-CHUNKS_PER_SM * n_sms // max(1, b * hk)))
    chunks = max(1, min(want, tiles // MIN_CHUNK_TILES, MAX_CHUNKS))
    chunk_tiles = -(-tiles // chunks)
    return chunk_tiles, -(-tiles // chunk_tiles)


_plan = functools.lru_cache(maxsize=256)(plan)


def max_group(d: int) -> int:
    """Query heads of a kv head one CTA of the kernel at head dim ``d``
    takes."""
    return MAX_GROUP_WIDE if d in WIDE_HEAD_DIMS else MAX_GROUP


def sub_groups(group: int, d: int) -> int:
    """CTAs a (chunk, kv head, row) takes for a GQA group at head dim ``d``:
    each holds at most ``max_group(d)`` of its query heads."""
    return -(-group // max_group(d))


def pad_head_dim(x, width: int):
    """x zero-padded on its last axis to ``width`` (8-bit values as bytes,
    whose zero is the zero of int8 and of fp8 e4m3)."""
    extra = width - x.shape[-1]
    if extra == 0:
        return x
    if x.element_size() == 1 and x.is_floating_point():
        return F.pad(x.view(torch.uint8), (0, extra)).view(x.dtype)
    return F.pad(x, (0, extra))


def _device(device, pairs: int) -> tuple[int, torch.Tensor]:
    """The device's SM count and its per-pair counters (zeros, which every
    call leaves zero), at least ``pairs`` of them. Made at a device's first
    call: a call captured in a CUDA graph needs an eager call before it."""
    state = _DEVICES.get(device.index)
    if state is None or state[1].numel() < pairs:
        state = _DEVICES[device.index] = (
            torch.cuda.get_device_properties(device).multi_processor_count,
            torch.zeros(max(pairs, 1 << 16), dtype=torch.int32,
                        device=device))
    return state


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, *,
                              k_scales=None, v_scales=None, sm_scale=None,
                              window=None, softcap=None, layer=None):
    """Plain version: gather each row's pages densely, run masked attention
    in fp32. ``k_pages`` is (hk, P, ps, d), or (L, hk, P, ps, d) with
    ``layer``. Rows with length <= 0 return zeros. Masked tokens (past the
    length, before the window, or in a hole entry of -1) contribute exactly
    0, whatever their pages hold: their V rows are zeroed, not only their
    weights, so a non-finite value there cannot reach the output."""
    if layer is not None:
        k_pages, v_pages = k_pages[int(layer)], v_pages[int(layer)]
        if k_scales is not None:
            k_scales, v_scales = k_scales[int(layer)], v_scales[int(layer)]
    b, h, d = q.shape
    hk, _, page_size, _ = k_pages.shape
    group = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    kp, vp = k_pages.float(), v_pages.float()
    if k_scales is not None:  # per-token scale = lane t of the page's tile
        kp = kp * k_scales[:, :, 0, :page_size, None].float()
        vp = vp * v_scales[:, :, 0, :page_size, None].float()
    idx = page_indices.long()
    k = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(b, hk, -1, d)
    v = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(b, hk, -1, d)
    qg = q.float().reshape(b, hk, group, d)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(s.shape[-1], device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    mask = pos < lens
    if window is not None:
        mask &= pos >= (lens - window).clamp(min=0)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    v = v.masked_fill(~mask[:, None, :, None], 0.0)
    alive = (lengths.to(q.device) > 0)[:, None, None, None]
    p = torch.softmax(torch.where(alive, s, torch.zeros_like(s)), dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v)
    o = torch.where(alive, o, torch.zeros_like(o))
    return o.reshape(b, h, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, lengths, page_indices, *,
                    k_scales=None, v_scales=None, sm_scale=None,
                    pages_per_block: int = 8, window=None, softcap=None,
                    interpret: bool | None = None, layer=None):
    """Single-token decode attention against a paged KV cache.

    q (b, h, d); k_pages/v_pages (hk, P, ps, d) or the layer-stacked
    (L, hk, P, ps, d) with ``layer`` an int; lengths (b,) int32 (each row's
    length including this token); page_indices (b, pages_per_seq) int32.
    Returns o (b, h, d) in q.dtype; rows with length <= 0 are zeros.
    ``window`` W: the query sees the tokens [max(length - W, 0), length),
    and table entries whose pages hold none of them may be holes (-1).
    ``softcap`` squashes scaled scores to ``softcap * tanh(s / softcap)``.
    ``k_scales``/``v_scales`` ((L,) hk, P, 8, 128) fp32 with int8 or fp8
    e4m3 pages of 128 tokens: the quantized cache, lane t of a page's tile
    token t's scale (bf16 q on the card). Any d <= 512 decodes: pages
    wider than d (a cache at ``kernel_head_dim(d)``, as the engine
    allocates it) take q zero-padded; pages of a width the kernel lacks
    (d 80 or 96) are padded by a copy of the whole pool in every call on
    the card, about 35 times the kernel's time (1.37 ms against 0.04 ms at
    L8 hk8 d96, 0.75 GiB a pool, on an H100 80GB HBM3 at 700 W): allocate
    the cache at ``kernel_head_dim(d)`` instead. ``pages_per_block`` and
    ``interpret`` (the TPU kernel's grouping, Pallas interpret mode) raise
    NotImplementedError off their defaults."""
    reject_unported("paged_attention",
                    pages_per_block=(pages_per_block, 8),
                    interpret=(interpret, None))
    b, h, d = q.shape
    layered = k_pages.dim() == 5
    if layered and layer is None:
        raise ValueError("a layer-stacked (5D) cache needs the layer index")
    if not layered and layer is not None:
        raise ValueError("layer given but the cache is not layer-stacked")
    hk = k_pages.shape[-4]
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1; got {window}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    width = k_pages.shape[-1]
    if width < d:
        raise ValueError(f"the pages' head dim {width} is below q's {d}")
    if width > d:
        # a cache at the kernels' width: zero columns add nothing to q k
        # and give zero columns of O
        return paged_attention(
            pad_head_dim(q, width), k_pages, v_pages, lengths, page_indices,
            k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale,
            window=window, softcap=softcap, layer=layer)[..., :d]
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, lengths, page_indices, k_scales=k_scales,
            v_scales=v_scales, sm_scale=sm_scale, window=window,
            softcap=softcap, layer=layer)
    kd = kernel_head_dim(d)
    if kd != d:
        # a cache below the kernel's width: a padded copy of the pool
        return paged_attention(
            pad_head_dim(q, kd), pad_head_dim(k_pages, kd),
            pad_head_dim(v_pages, kd), lengths, page_indices,
            k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale,
            window=window, softcap=softcap, layer=layer)[..., :d]
    pk = k_pages if layered else k_pages[None]
    pv = v_pages if layered else v_pages[None]
    L, _, total_pages, page_size, _ = pk.shape
    layer = 0 if layer is None else int(layer)
    tensors = {"q": q, "k_pages": pk, "v_pages": pv, "lengths": lengths,
               "page_indices": page_indices}
    quantized = k_scales is not None
    if quantized:
        ks = k_scales if layered else k_scales[None]
        vs = v_scales if layered else v_scales[None]
        tensors.update(k_scales=ks, v_scales=vs)
    for name, x in tensors.items():
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if quantized:
        if q.dtype != torch.bfloat16 or pk.dtype not in KV_TYPES or \
                pv.dtype != pk.dtype:
            raise ValueError("a quantized cache takes bf16 q and int8 or "
                             "float8_e4m3fn pages")
        if page_size != QUANT_PAGE_SIZE:
            raise ValueError(f"a quantized cache needs page_size "
                             f"{QUANT_PAGE_SIZE}, got {page_size}")
        want = (L, pk.shape[1], total_pages, 8, 128)
        for name in ("k_scales", "v_scales"):
            x = tensors[name]
            if x.dtype != torch.float32 or x.shape != want or \
                    x.data_ptr() % 16:
                raise ValueError(f"{name} must be {want} fp32, 16-byte "
                                 f"aligned")
    elif q.dtype not in (torch.bfloat16, torch.float16) or \
            pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise ValueError("q and the pages must share one dtype, bf16 or fp16")
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("the pages must be 16-byte aligned")
    if pv.shape != pk.shape or pk.shape[-1] != d:
        raise ValueError("k_pages/v_pages shape mismatch")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("lengths must be (b,) int32")
    if page_indices.dtype != torch.int32 or page_indices.dim() != 2 or \
            page_indices.shape[0] != b:
        raise ValueError("page_indices must be (b, pages_per_seq) int32")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if q.data_ptr() % 16:  # the kernel reads q in aligned vectors
        q = q.clone()
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = KERNEL.lib()
    dev = q.device
    # a (kv head, sub-group) pair is the kernel's unit: its chunks, its
    # counter and its partials
    hks = hk * sub_groups(h // hk, d)
    n_sms, counters = _device(dev, b * hks)
    pps = page_indices.shape[1]
    chunk_tiles, n_chunks = _plan(pps, page_size, b, hks, n_sms,
                                  None if window is None else int(window))
    cap_scale, cap_log2 = softcap_args(softcap, sm_scale)
    mg = max_group(d)
    ws = torch.empty(b * hks * n_chunks * (mg * d + 2 * mg)
                     if n_chunks > 1 else 0, dtype=torch.float32, device=dev)
    fn = (lib.fat_paged_attention_wide if d in WIDE_HEAD_DIMS
          else lib.fat_paged_attention)
    rc = fn(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
        tensors["k_scales"].data_ptr() if quantized else 0,
        tensors["v_scales"].data_ptr() if quantized else 0,
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), b, h, hk, d, L, layer,
        total_pages, page_size, pps, chunk_tiles, n_chunks,
        0 if window is None else int(window), sm_scale * _LOG2E, cap_scale,
        cap_log2, int(q.dtype == torch.float16),
        KV_TYPES.get(pk.dtype, 0) if quantized else 0,
        torch._C._cuda_getCurrentRawStream(dev.index))
    KERNEL.launches += 1
    KERNEL.check(rc)
    return out
