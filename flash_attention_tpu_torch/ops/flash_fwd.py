"""Flash-attention forward: the band helper and the CUDA kernel's wrapper.

The kernel (``csrc/flash_fwd.cu``) replaces the JAX package's Pallas
``_fwd_kernel``. It reads q (b, sq, h, d) and k/v (b, sk, hk, d) in bf16 or
fp16 through their strides and writes O (b, sq, h, d) and LSE (b, h, sq)
fp32, under a band of relative offsets (causal, a sliding window, or both)
and an optional softcap. The kernel masks its own ragged edges, so nothing
is padded here. With ``segs`` (segment ids and positions of a packed batch)
it runs its segmented instance (replacing the segmented ``pallas_call`` of
``_fwd_kernel``): each CTA loops over the kv tiles of the range that
``ops.segments.block_ranges`` gives its 128 query rows, and masks by segment
id and by the band over positions. ``flash_fwd_segmented_reference`` is the
plain version of that mode.
It loads by TMA through tensor maps built from the strides, so the data
must be 16-byte aligned and the strides multiples of 16 bytes: ``_prepare``
copies an input that is not into a fresh tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from flash_attention_tpu_torch.ops import _build, segments
from flash_attention_tpu_torch.ops.reference import reference_attention

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = _build.Kernel("flash_fwd", "flash_fwd.cu", {
    "fat_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                      _I, _F, _F, _F, _I, _P, _P],
    "fat_flash_fwd_seg_tiles": [_I, _P],
})
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float16)
# query rows a block of the plain segmented versions holds at once: their
# (b, group, rows, sk) scores, not (b, h, sq, sk), are what they allocate
PLAIN_ROWS = 512


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


def seg_tiles(kernel: _build.Kernel, d: int) -> tuple[int, int]:
    """The (owned, streamed) block rows of a segmented kernel's CTA at head
    dim ``d``, read from the kernel's own library (``fat_*_seg_tiles``), so
    the ranges are computed at the tile sizes the CUDA code runs."""
    out = (ctypes.c_int * 2)()
    lib = kernel.lib()
    fn = next(f for f in kernel.argtypes if f.endswith("_seg_tiles"))
    kernel.check(getattr(lib, fn)(d, out))
    return out[0], out[1]


def prepare_segs(segs, b: int, sq: int, sk: int, device):
    """(q_seg, kv_seg, q_pos, kv_pos) as the kernels read them: contiguous
    int32 (b, sq), (b, sk), (b, sq), (b, sk) on ``device``."""
    if len(segs) != 4:
        raise ValueError("segs must be (q_seg, kv_seg, q_pos, kv_pos)")
    out = tuple(torch.as_tensor(x, device=device).to(torch.int32).contiguous()
                for x in segs)
    for x, n, name in zip(out, (sq, sk, sq, sk),
                          ("q_seg", "kv_seg", "q_pos", "kv_pos")):
        if tuple(x.shape) != (b, n):
            raise ValueError(f"{name} must be ({b}, {n}), got "
                             f"{tuple(x.shape)}")
    return out


def seg_pointers(segs, lo, hi):
    """The C interfaces' six device pointers of a segmented launch: q_seg,
    kv_seg, q_pos, kv_pos and the block ranges lo, hi."""
    ptrs = (ctypes.c_uint64 * 6)(*(x.data_ptr() for x in (*segs, lo, hi)))
    return ctypes.cast(ptrs, ctypes.c_void_p), ptrs


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float,
              empty_lse: float = 0.0, window=None, softcap=None, segs=None):
    """Launch the CUDA forward kernel. Returns (o, lse). ``window`` is a
    (left, right) sliding window (entries < 0 unbounded), folded with
    ``causal`` by :func:`normalize_band`; ``softcap`` squashes the scaled
    scores to ``softcap * tanh(s / softcap)``. With ``segs`` (q_seg, kv_seg,
    q_pos, kv_pos), each (b, s) int, the segmented instance runs: a query
    sees a key of its own segment id, and the band applies to ``kv_pos -
    q_pos`` (causal is ``kv_pos <= q_pos``)."""
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
    seg_ptr = keep = None
    if segs is not None:
        segs = prepare_segs(segs, b, sq, sk, q.device)
        block_q, block_kv = seg_tiles(KERNEL, d)
        lo, hi = segments.block_ranges(segs[0], segs[2], segs[1], segs[3],
                                       block_q, block_kv, causal=causal,
                                       causal_dir="kv_le_q")
        seg_ptr, keep = seg_pointers(segs, lo, hi)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = KERNEL.lib()
    rc = lib.fat_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, sk, h, hk, d, ctypes.cast(strides, ctypes.c_void_p),
        sm_scale * math.log2(math.e), left, right, cap_scale, cap_log2,
        float(empty_lse),
        int(q.dtype == torch.float16), seg_ptr,
        torch.cuda.current_stream(q.device).cuda_stream)
    del keep
    KERNEL.launches += 1
    KERNEL.check(rc)
    return o, lse


def query_blocks(q, k, rows: int = PLAIN_ROWS):
    """(kv head, its query heads, a block of query rows) in turn: the loop
    of the plain segmented versions, whose scores then hold one GQA group
    and ``rows`` query rows at a time."""
    hk, g = k.shape[2], q.shape[2] // k.shape[2]
    for i in range(hk):
        for r0 in range(0, q.shape[1], rows):
            yield i, slice(i * g, (i + 1) * g), slice(r0, r0 + rows)


def flash_fwd_segmented_reference(q, k, v, segs, *, causal: bool,
                                  sm_scale: float, empty_lse: float = 0.0,
                                  window=None, softcap=None):
    """The plain version of the segmented forward: (o, lse) as
    :func:`flash_fwd` with ``segs`` computes them, in fp32, one GQA group
    and one block of query rows at a time (:func:`query_blocks`). The mask
    comes from the segment ids and positions, as in the kernel, never from
    cu_seqlens."""
    q_seg, kv_seg, q_pos, kv_pos = prepare_segs(segs, q.shape[0], q.shape[1],
                                                k.shape[1], q.device)
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    for i, hs, rs in query_blocks(q, k):
        o[:, rs, hs], lse[:, hs, rs] = reference_attention(
            q[:, rs, hs], k[:, :, i:i + 1], v[:, :, i:i + 1], causal=causal,
            sm_scale=sm_scale, q_segment_ids=q_seg[:, rs],
            kv_segment_ids=kv_seg, q_positions=q_pos[:, rs],
            kv_positions=kv_pos, window=window, softcap=softcap,
            empty_lse=empty_lse)
    return o, lse
