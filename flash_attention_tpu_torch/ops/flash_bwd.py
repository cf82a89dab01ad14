"""Flash-attention backward: three CUDA kernels, their wrappers and their
plain PyTorch versions.

The counterpart of the JAX package's ``ops/flash_bwd.py``, in three steps:

1. ``flash_bwd_di`` (``csrc/flash_bwd_di.cu``, replaces ``_di_kernel``):
   D = rowsum(dO * O), taken as the diagonal of dO O^T from the same wgmma
   chain (``hop::ss_chain``) as dP, so dP - D cancels exactly.
2. ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``, replaces ``_dq_kernel``):
   dQ = scale * (P * (dP - D)) K with P and dP recomputed.
3. ``flash_bwd_dkv`` (``csrc/flash_bwd_dkv.cu``, replaces ``_dkv_kernel``):
   dV = sum_g P^T dO and dK = scale * sum_g dS^T Q, the GQA group summed in
   the kernel (no atomics).

All three are warp-specialised Hopper kernels on ``csrc/hopper_common.cuh``
(TMA, mbarriers, wgmma). Layouts are the port's unpadded ones: q, o, do
(b, sq, h, d); k, v (b, sk, hk, d); lse and D (b, h, sq) fp32. The kernels
read their inputs by TMA through strides (the head dim contiguous; an input
whose other strides are not multiples of 8 or whose data is not 16-byte
aligned is copied first, as in ``ops.flash_fwd``) and write contiguous
outputs in the input dtype. Each wrapper launches its
kernel for CUDA tensors only; the plain versions beside them (``*_reference``)
run on any device and are what ``ops.attention.bwd`` runs for CPU tensors.
The kernels and the plain versions take the same band (causal, a sliding
window, or both; ``ops.flash_fwd.normalize_band``) and softcap. With
``segs`` (segment ids and positions of a packed batch) dq and dkv run their
segmented instances (the segmented ``pallas_call``s of ``_dq_kernel`` and
``_dkv_kernel``): dq loops over the kv tiles of its query block's range and
dkv over the query tiles of its key block's range, both from
``ops.segments.block_ranges``, and both mask by segment id and by the band
over positions; D does not depend on the mask. The plain versions take
``segs`` too and then hold one GQA group and one block of query rows at a
time (``ops.flash_fwd.query_blocks``).

The plain versions compute in float64 and keep their own D in float64; the
operands the TPU kernel rounds to the input dtype before a product (P before
dV = P^T dO, dS before dK and dQ) they round the same way, as the CUDA
kernels do, so on bf16 inputs a kernel is held to its own arithmetic and an
output whose terms cancel to near zero is not off by the rounding alone. Where
a row attends to one key, dP - D is exactly 0 in the kernels (D is summed as
dP is); an fp32 plain version would leave about 1e-7 there instead, which is
above the fp16 gates' resolution on such rows. In float64 the residue is far
below any output dtype's.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attention_tpu_torch.ops import _build, segments
from flash_attention_tpu_torch.ops.flash_fwd import (HEAD_DIMS, _prepare,
                                                     band_args, prepare_segs,
                                                     query_blocks,
                                                     seg_pointers, seg_tiles,
                                                     softcap_args)
from flash_attention_tpu_torch.ops.reference import _build_mask

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

DI_KERNEL = _build.Kernel("flash_bwd_di", "flash_bwd_di.cu", {
    "fat_flash_bwd_di": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
})
DQ_KERNEL = _build.Kernel("flash_bwd_dq", "flash_bwd_dq.cu", {
    "fat_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _F, _I, _I, _F, _F, _I, _P, _P],
    "fat_flash_bwd_dq_seg_tiles": [_I, _P],
})
DKV_KERNEL = _build.Kernel("flash_bwd_dkv", "flash_bwd_dkv.cu", {
    "fat_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P, _F, _I, _I, _F, _F, _I, _P, _P],
    "fat_flash_bwd_dkv_seg_tiles": [_I, _P],
})
KERNELS = (DI_KERNEL, DQ_KERNEL, DKV_KERNEL)
PARTS = ("di", "dq", "all")


def _strides(*xs):
    st = [s for x in xs for s in x.stride()[:3]]
    return ctypes.cast((ctypes.c_longlong * len(st))(*st), ctypes.c_void_p)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _prepare_inputs(q, k, v, do, lse, di):
    """(q, k, v, do) as the kernels take them (see ``_prepare``); raises on
    anything else they cannot take."""
    q, k, v, do = (_prepare(x, name) for x, name in ((q, "q"), (k, "k"),
                                                      (v, "v"), (do, "do")))
    b, sq, h, d = q.shape
    if any(x.dtype != q.dtype for x in (k, v, do)):
        raise ValueError("q, k, v and do must share one dtype")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d \
            or do.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, do "
                         f"{tuple(do.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if h % k.shape[2]:
        raise ValueError(f"num_heads {h} must be divisible by num_heads_k "
                         f"{k.shape[2]}")
    for x, name in ((lse, "lse"), (di, "di")):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, sq) \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be a contiguous fp32 (b, h, sq) "
                             f"tensor on q's device")
    return q, k, v, do


def flash_bwd_di(o, do):
    """Launch the D kernel: D = rowsum(dO * O), (b, h, sq) fp32."""
    o, do = _prepare(o, "o"), _prepare(do, "do")
    if do.shape != o.shape or do.dtype != o.dtype:
        raise ValueError("o and do must share one shape and dtype")
    b, sq, h, d = o.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    di = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    if di.numel() == 0:
        return di
    lib = DI_KERNEL.lib()
    rc = lib.fat_flash_bwd_di(o.data_ptr(), do.data_ptr(), di.data_ptr(), b,
                              sq, h, d, _strides(o, do),
                              int(o.dtype == torch.float16), _stream(o))
    DI_KERNEL.launches += 1
    DI_KERNEL.check(rc)
    return di


def _seg_launch(kernel, segs, q, k, causal, causal_dir):
    """The segment pointers of a dq or dkv launch (None without ``segs``)
    and the tensors they point into, with the block ranges computed at the
    kernel's own tiles: query blocks over kv tiles for dq, key blocks over
    query tiles for dkv."""
    if segs is None:
        return None, None
    b, sq, _, d = q.shape
    segs = prepare_segs(segs, b, sq, k.shape[1], q.device)
    owned, streamed = seg_tiles(kernel, d)
    q_seg, kv_seg, q_pos, kv_pos = segs
    if causal_dir == "kv_le_q":
        lo, hi = segments.block_ranges(q_seg, q_pos, kv_seg, kv_pos, owned,
                                       streamed, causal=causal,
                                       causal_dir=causal_dir)
    else:
        lo, hi = segments.block_ranges(kv_seg, kv_pos, q_seg, q_pos, owned,
                                       streamed, causal=causal,
                                       causal_dir=causal_dir)
    return seg_pointers(segs, lo, hi)


def flash_bwd_dq(q, k, v, do, lse, di, *, causal: bool, sm_scale: float,
                 window=None, softcap=None, segs=None):
    """Launch the dQ kernel. Returns dq (b, sq, h, d) in q's dtype. With
    ``segs`` the segmented instance runs (see ``ops.flash_fwd.flash_fwd``)."""
    q, k, v, do = _prepare_inputs(q, k, v, do, lse, di)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    seg_ptr, keep = _seg_launch(DQ_KERNEL, segs, q, k, causal, "kv_le_q")
    lib = DQ_KERNEL.lib()
    rc = lib.fat_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, sq, sk, h, hk, d,
        _strides(q, k, v, do), sm_scale, *band_args(causal, window),
        *softcap_args(softcap, sm_scale), int(q.dtype == torch.float16),
        seg_ptr, _stream(q))
    del keep
    DQ_KERNEL.launches += 1
    DQ_KERNEL.check(rc)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, di, *, causal: bool, sm_scale: float,
                  window=None, softcap=None, segs=None):
    """Launch the dK/dV kernel. Returns (dk, dv), each (b, sk, hk, d) in the
    input dtype, summed over each kv head's GQA group. With ``segs`` the
    segmented instance runs (see ``ops.flash_fwd.flash_fwd``)."""
    q, k, v, do = _prepare_inputs(q, k, v, do, lse, di)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dk = torch.empty((b, sk, hk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    seg_ptr, keep = _seg_launch(DKV_KERNEL, segs, q, k, causal, "q_ge_kv")
    lib = DKV_KERNEL.lib()
    rc = lib.fat_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
        sk, h, hk, d, _strides(q, k, v, do), sm_scale,
        *band_args(causal, window), *softcap_args(softcap, sm_scale),
        int(q.dtype == torch.float16), seg_ptr, _stream(q))
    del keep
    DKV_KERNEL.launches += 1
    DKV_KERNEL.check(rc)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
              window=None, softcap=None, parts: str = "all", segs=None):
    """The CUDA backward: D, then dQ, then dK/dV. Returns (dq, dk, dv);
    ``parts="di"`` stops after D and returns it, ``parts="dq"`` stops after
    dQ and returns dq. ``segs`` runs dq and dkv segmented."""
    if parts not in PARTS:
        raise ValueError(f"parts must be one of {PARTS}, got {parts!r}")
    di = flash_bwd_di(o, do)
    if parts == "di":
        return di
    lse = lse.float().contiguous()
    kw = dict(causal=causal, sm_scale=sm_scale, window=window,
              softcap=softcap, segs=segs)
    dq = flash_bwd_dq(q, k, v, do, lse, di, **kw)
    if parts == "dq":
        return dq
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Plain versions: the same functions in fp32 PyTorch, on any device.
# ---------------------------------------------------------------------------


def di_reference(o, do):
    """D = rowsum(dO * O), (b, h, sq) in float64."""
    return (o.double() * do.double()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_dscores(q, k, v, do, lse, di, causal, sm_scale, window,
                       softcap, segs=None):
    """P and dS, (b, h, sq, sk) float64, with the GQA heads expanded.

    P = exp(S - LSE) is 0 on masked entries (so rows with no live key give
    0 whatever their LSE); dS = P * (dP - D), times the softcap's
    1 - tanh^2 chain-rule factor when softcap is on."""
    group = q.shape[2] // k.shape[2]
    qf = q.double().transpose(1, 2)                                  # b h q d
    kf = k.double().repeat_interleave(group, dim=2).transpose(1, 2)  # b h k d
    vf = v.double().repeat_interleave(group, dim=2).transpose(1, 2)
    dof = do.double().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    p = torch.exp(s - lse.double()[..., None])
    mask = _build_mask(q.shape[1], k.shape[1], causal, window,
                       device=q.device, segs=segs)
    if mask is not None:
        p = p.masked_fill(~(mask if mask.dim() == 2 else mask[:, None]), 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di.double()[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    return p, ds, qf, kf, dof


def _rounded(x, dtype):
    """x rounded to ``dtype`` and back to float64: an operand the TPU
    kernel (and the CUDA one) rounds to the input dtype before a product."""
    return x.to(dtype).double()


def _dq64(q, k, v, do, lse, di, causal, sm_scale, window, softcap,
          segs=None):
    """dQ = scale * dS K in float64, (b, sq, h, d)."""
    _, ds, _, kf, _ = _probs_and_dscores(q, k, v, do, lse, di, causal,
                                         sm_scale, window, softcap, segs)
    return (torch.matmul(_rounded(ds, k.dtype), kf)
            * sm_scale).transpose(1, 2)


def _dkv64(q, k, v, do, lse, di, causal, sm_scale, window, softcap,
           segs=None):
    """dK = scale * sum_g dS^T Q and dV = sum_g P^T dO in float64,
    (b, sk, hk, d) each."""
    b, sk, hk, d = k.shape
    p, ds, qf, _, dof = _probs_and_dscores(q, k, v, do, lse, di, causal,
                                           sm_scale, window, softcap, segs)

    def group_sum(x):  # (b, h, sk, d) -> (b, sk, hk, d)
        return x.view(b, hk, -1, sk, d).sum(2).transpose(1, 2)

    dk = group_sum(torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2),
                                qf)) * sm_scale
    dv = group_sum(torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), dof))
    return dk, dv


def _row_segs(segs, rows):
    """``segs`` with the query side cut to ``rows``."""
    q_seg, kv_seg, q_pos, kv_pos = segs
    return q_seg[:, rows], kv_seg, q_pos[:, rows], kv_pos


def dq_reference(q, k, v, do, lse, di, *, causal: bool, sm_scale: float,
                 window=None, softcap: float | None = None, segs=None):
    """dQ = scale * dS K, (b, sq, h, d) in q's dtype, dS rounded to K's
    dtype before the product as in the TPU kernel. With ``segs`` the
    segmented mask, one GQA group and block of query rows at a time."""
    args = (causal, sm_scale, window, softcap)
    if segs is None:
        return _dq64(q, k, v, do, lse, di, *args).to(q.dtype)
    segs = prepare_segs(segs, q.shape[0], q.shape[1], k.shape[1], q.device)
    dq = torch.empty_like(q)
    for i, hs, rs in query_blocks(q, k):
        kv = slice(i, i + 1)
        dq[:, rs, hs] = _dq64(q[:, rs, hs], k[:, :, kv], v[:, :, kv],
                              do[:, rs, hs], lse[:, hs, rs], di[:, hs, rs],
                              *args, _row_segs(segs, rs)).to(q.dtype)
    return dq


def dkv_reference(q, k, v, do, lse, di, *, causal: bool, sm_scale: float,
                  window=None, softcap: float | None = None, segs=None):
    """dK = scale * sum_g dS^T Q and dV = sum_g P^T dO, (b, sk, hk, d), dS
    and P rounded to Q's and dO's dtype before the products as in the TPU
    kernel. With ``segs`` the segmented mask, one GQA group and block of
    query rows at a time, summed in float64 and rounded once."""
    args = (causal, sm_scale, window, softcap)
    if segs is None:
        dk, dv = _dkv64(q, k, v, do, lse, di, *args)
        return dk.to(k.dtype), dv.to(v.dtype)
    segs = prepare_segs(segs, q.shape[0], q.shape[1], k.shape[1], q.device)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=k.device)
    dv = torch.zeros_like(dk)
    for i, hs, rs in query_blocks(q, k):
        kv = slice(i, i + 1)
        dki, dvi = _dkv64(q[:, rs, hs], k[:, :, kv], v[:, :, kv],
                          do[:, rs, hs], lse[:, hs, rs], di[:, hs, rs], *args,
                          _row_segs(segs, rs))
        dk[:, :, kv] += dki
        dv[:, :, kv] += dvi
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, *, causal: bool,
                        sm_scale: float, window=None,
                        softcap: float | None = None, parts: str = "all",
                        segs=None):
    """The plain backward, step for step as :func:`flash_bwd`."""
    if parts not in PARTS:
        raise ValueError(f"parts must be one of {PARTS}, got {parts!r}")
    di = di_reference(o, do)
    if parts == "di":
        return di.float()
    kw = dict(causal=causal, sm_scale=sm_scale, window=window,
              softcap=softcap, segs=segs)
    dq = dq_reference(q, k, v, do, lse, di, **kw)
    if parts == "dq":
        return dq
    return (dq, *dkv_reference(q, k, v, do, lse, di, **kw))
