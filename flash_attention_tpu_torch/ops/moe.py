"""Mixture-of-Experts: routing, the sorted block dispatch and the grouped
matmul, with two CUDA kernels, their wrappers and their plain versions.

The counterpart of the JAX package's ``ops/moe.py`` (megablox style, no
capacity factor, no token dropping):

* ``route``: an fp32 router product, top-k, and a softmax over the k
  winners (Mixtral semantics).
* ``dispatch``: the T*k (token, expert) assignments are stably sorted by
  expert and placed in a buffer of a static worst-case size,
  ``(ceil(T*k / B) + E + 1) * B`` rows, where every expert's rows start on a
  B-row block boundary; ``block_expert`` names each block's expert (-1 for a
  dead block). Everything is tensor ops on the device: no ``.item()``, no
  ``nonzero``, so nothing waits for the card.
* ``grouped_matmul``: y[r] = x[r] @ w[block_expert[r // B]], a
  ``torch.autograd.Function`` whose backward is dx = gmm(dy, w^T) and
  dW = gmm_dw(x, dy). w^T is the strided view ``w.transpose(1, 2)``, read by
  the kernel through its strides and never copied (the JAX backward
  materialises ``swapaxes``).
* ``moe_ffn``: route, dispatch, gate/up/down grouped matmuls, the unsort and
  the fp32 weighted combine.

Kernels (each launched only for CUDA tensors; the plain versions
``gmm_reference`` and ``gmm_dw_reference`` compute per block or per group in
fp32 and are what the wrappers run for CPU tensors). Both are persistent,
warp-specialised ``wgmma`` kernels fed by TMA through an mbarrier ring, one
CTA per SM walking the output tiles:

1. ``gmm`` (``csrc/gmm.cu``, replaces ``_gmm_kernel``): 128-row tiles (one
   block, one expert) by 256 columns. A dead block writes zeros and loads
   nothing.
2. ``gmm_dw`` (``csrc/gmm_dw.cu``, replaces ``_gmm_dw_kernel``): 128 x 256
   tiles of dW, expert by expert, each summing its expert's row blocks in
   index order. An expert with no rows gets dW = 0; the JAX kernel leaves
   that slot unwritten.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attention_tpu_torch.ops import _build
from flash_attention_tpu_torch.utils.options import reject_unported

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = _build.Kernel("gmm", "gmm.cu", {
    "fat_gmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
})
DW_KERNEL = _build.Kernel("gmm_dw", "gmm_dw.cu", {
    "fat_gmm_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    "fat_gmm_dw_max_experts": [],
})
KERNELS = (KERNEL, DW_KERNEL)
DTYPES = (torch.bfloat16, torch.float16)
TILE_ROWS = 128  # the kernels' row tile: a block must hold a whole number


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _n_ctas(device) -> int:
    """CTAs of a persistent launch: one per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _block_rows(x, block_expert) -> int:
    nb = block_expert.shape[0]
    if block_expert.dim() != 1 or nb == 0 or x.shape[0] % nb:
        raise ValueError(f"block_expert must be (n_blocks,) with n_blocks "
                         f"dividing the {x.shape[0]} rows of x")
    return x.shape[0] // nb


def _check_cuda(x, block_expert, name):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: the kernel takes bf16 or fp16, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) % 8 \
            or x.data_ptr() % 16 or x.shape[1] % 8:
        raise ValueError(f"{name} must be 2D with contiguous rows, a width "
                         f"and row stride that are multiples of 8, and "
                         f"16-byte aligned data")
    if block_expert.device != x.device or block_expert.dtype != torch.int32 \
            or not block_expert.is_contiguous():
        raise ValueError("block_expert must be a contiguous int32 tensor on "
                         "the same device")
    br = _block_rows(x, block_expert)
    if br % TILE_ROWS:
        raise ValueError(f"rows per block ({br}) must be a multiple of "
                         f"{TILE_ROWS} for the kernel")
    return br


def gmm(x, w, block_expert):
    """y[r] = x[r] @ w[block_expert[r // B]], rows of dead blocks (-1) 0.

    x (n_rows, K); w (E, K, N), either with its N dim contiguous or its K
    dim contiguous (the view ``w.transpose(1, 2)`` of an (E, N, K) stack);
    block_expert (n_rows / B,) int32. Returns (n_rows, N) in x's dtype. A
    CUDA tensor launches ``csrc/gmm.cu``; a CPU tensor runs
    :func:`gmm_reference`."""
    if x.device.type == "cpu":
        return gmm_reference(x, w, block_expert)
    br = _check_cuda(x, block_expert, "x")
    n_rows, k = x.shape
    if w.dim() != 3 or w.shape[1] != k:
        raise ValueError(f"w must be (E, {k}, N), got {tuple(w.shape)}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError("w must share x's device and dtype")
    e, _, n = w.shape
    se, sk, sn = w.stride()
    if sn == 1:
        kn, s_other = 1, sk
    elif sk == 1:
        kn, s_other = 0, sn
    else:
        raise ValueError("w needs a contiguous N dim or a contiguous K dim")
    if n % 8 or se % 8 or s_other % 8 or w.data_ptr() % 16:
        raise ValueError("w: N, and its strides other than the unit one, "
                         "must be multiples of 8, the data 16-byte aligned")
    y = torch.empty((n_rows, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_longlong * 3)(x.stride(0), se, s_other)
    lib = KERNEL.lib()
    rc = lib.fat_gmm(x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
                     y.data_ptr(), n_rows, k, n, br, e, kn,
                     ctypes.cast(strides, ctypes.c_void_p),
                     int(x.dtype == torch.float16), _n_ctas(x.device),
                     _stream(x))
    KERNEL.launches += 1
    KERNEL.check(rc)
    return y


def gmm_dw(x, dy, block_expert, n_experts: int):
    """dW[e] = x[rows of e]^T @ dy[rows of e], (n_experts, K, N) in x's
    dtype, summed in fp32 and written once; an expert with no live block
    gets exact zeros. The rows of one expert's blocks may sit anywhere. A
    CUDA tensor launches ``csrc/gmm_dw.cu``; a CPU tensor runs
    :func:`gmm_dw_reference`."""
    if x.device.type == "cpu":
        return gmm_dw_reference(x, dy, block_expert, n_experts)
    br = _check_cuda(x, block_expert, "x")
    _check_cuda(dy, block_expert, "dy")
    if dy.shape[0] != x.shape[0] or dy.dtype != x.dtype:
        raise ValueError("x and dy must share their rows and dtype")
    n_rows, k = x.shape
    n = dy.shape[1]
    dw = torch.empty((n_experts, k, n), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    lib = DW_KERNEL.lib()
    if n_experts > lib.fat_gmm_dw_max_experts():
        raise ValueError(f"gmm_dw: the kernel takes at most "
                         f"{lib.fat_gmm_dw_max_experts()} experts")
    strides = (ctypes.c_longlong * 2)(x.stride(0), dy.stride(0))
    rc = lib.fat_gmm_dw(x.data_ptr(), dy.data_ptr(), block_expert.data_ptr(),
                        dw.data_ptr(), n_rows, k, n, br,
                        block_expert.shape[0], n_experts,
                        ctypes.cast(strides, ctypes.c_void_p),
                        int(x.dtype == torch.float16), _n_ctas(x.device),
                        _stream(x))
    DW_KERNEL.launches += 1
    DW_KERNEL.check(rc)
    return dw


# ---------------------------------------------------------------------------
# Plain versions: the same functions in fp32 PyTorch, on any device.
# ---------------------------------------------------------------------------


def _blocks_of(block_expert, e):
    return (block_expert == e).nonzero().flatten()


def gmm_reference(x, w, block_expert):
    """Per expert, its blocks' rows times ``w[e]`` in fp32; dead blocks 0.
    Returns x's dtype."""
    br = _block_rows(x, block_expert)
    nb = block_expert.shape[0]
    xb = x.float().reshape(nb, br, x.shape[1])
    y = torch.zeros((nb, br, w.shape[2]), dtype=torch.float32,
                    device=x.device)
    for e in range(w.shape[0]):
        sel = _blocks_of(block_expert, e)
        if sel.numel():
            y[sel] = torch.matmul(xb[sel], w[e].float())
    return y.reshape(x.shape[0], -1).to(x.dtype)


def gmm_dw_reference(x, dy, block_expert, n_experts: int):
    """dW[e] = x[rows of e]^T @ dy[rows of e] in fp32, exact zeros for an
    expert with no rows. Returns x's dtype."""
    br = _block_rows(x, block_expert)
    nb = block_expert.shape[0]
    xb = x.float().reshape(nb, br, x.shape[1])
    dyb = dy.float().reshape(nb, br, dy.shape[1])
    dw = torch.zeros((n_experts, x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        sel = _blocks_of(block_expert, e)
        if sel.numel():
            dw[e] = torch.matmul(xb[sel].reshape(-1, x.shape[1]).T,
                                 dyb[sel].reshape(-1, dy.shape[1]))
    return dw.to(x.dtype)


# ---------------------------------------------------------------------------
# The differentiable grouped matmul.
# ---------------------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    """The counterpart of the JAX package's ``custom_vjp``: the forward
    saves (x, w, block_expert); the backward runs dx = gmm(dy, w^T), with
    w^T a strided view, and dW = gmm_dw(x, dy). block_expert gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, block_expert, fwd, dw_fn):
        ctx.save_for_backward(x, w, block_expert)
        ctx.fns = (fwd, dw_fn)
        return fwd(x, w, block_expert)

    @staticmethod
    def backward(ctx, dy):
        x, w, block_expert = ctx.saved_tensors
        fwd, dw_fn = ctx.fns
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = fwd(dy, w.transpose(1, 2), block_expert)
        if ctx.needs_input_grad[1]:
            dw = dw_fn(x, dy, block_expert, w.shape[0])
        return dx, dw, None, None, None


def grouped_matmul(x, w, block_expert, *, block_n: int = 512,
                   block_k: int = 512, interpret: bool | None = None):
    """Differentiable y[r] = x[r] @ w[expert of r's block].

    x (N, K) with N a whole number of row blocks; w (E, K, M); block_expert
    (N / B,) int32, -1 for dead blocks, whose rows come out 0. Gradients
    flow to x and w through the kernels (plain versions on the CPU).
    ``block_n``, ``block_k`` and ``interpret`` (the TPU kernel's tiles,
    Pallas interpret mode) raise NotImplementedError off their defaults."""
    reject_unported("grouped_matmul", block_n=(block_n, 512),
                    block_k=(block_k, 512), interpret=(interpret, None))
    return _GroupedMatmul.apply(x, w, block_expert, gmm, gmm_dw)


def grouped_matmul_reference(x, w, block_expert):
    """:func:`grouped_matmul` through the plain versions, forward and
    backward, on any device: the yardstick a kernel run is held to."""
    return _GroupedMatmul.apply(x, w, block_expert, gmm_reference,
                                gmm_dw_reference)


# ---------------------------------------------------------------------------
# Routing, dispatch and the MoE feed-forward.
# ---------------------------------------------------------------------------


def route(x, router_w, n_top: int):
    """Top-k routing, Mixtral semantics. x (T, D), router_w (D, E) ->
    (weights (T, k) fp32 normalised over the k winners, ids (T, k) int32 in
    descending logit order, router logits (T, E) fp32)."""
    logits = torch.matmul(x.float(), router_w.float())
    top_logits, top_ids = torch.topk(logits, n_top, dim=-1, sorted=True)
    return torch.softmax(top_logits, dim=-1), top_ids.to(torch.int32), logits


def dispatch(ids, n_experts: int, block_rows: int = 128):
    """The sorted, block-padded layout of the (token, slot) assignments.

    ids (T, k) int. Returns (perm, pos, block_expert, n_pad): ``perm`` the
    stable sort of the flat assignments by expert, ``pos`` the padded-buffer
    row of each sorted assignment, ``block_expert`` (n_pad / block_rows,)
    int32 with -1 for dead blocks, and the static row count
    n_pad = (ceil(T*k / block_rows) + E + 1) * block_rows. All on ids'
    device, with no host synchronisation."""
    tk = ids.numel()
    br = block_rows
    dev = ids.device
    e_flat = ids.reshape(tk).long()
    perm = torch.argsort(e_flat, stable=True)
    se = e_flat[perm]
    # rows per group, incl. an (empty) overflow group at index n_experts
    g = torch.zeros(n_experts + 1, dtype=torch.long, device=dev)
    g.scatter_add_(0, e_flat, torch.ones_like(e_flat))
    gstart = torch.cumsum(g, 0) - g
    pg = (g + br - 1) // br * br          # group sizes padded to blocks
    pend = torch.cumsum(pg, 0)
    pstart = pend - pg
    pos = pstart[se] + torch.arange(tk, device=dev) - gstart[se]
    n_pad = (-(-tk // br) + n_experts + 1) * br
    bstart = torch.arange(n_pad // br, device=dev) * br
    bexp = torch.searchsorted(pend, bstart, right=True)
    bexp = torch.where(bexp < n_experts, bexp, -1).to(torch.int32)
    return perm, pos, bexp, n_pad


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, n_top: int, act,
            expert_offset=None, block_rows: int = 128,
            interpret: bool | None = None):
    """Sparse MoE feed-forward over a flat token batch.

    x (T, D); router_w (D, E_global); w_gate/w_up (E_local, D, F); w_down
    (E_local, F, D); ``act`` the fp32 gate activation. ``expert_offset``
    (expert parallelism): this rank's first global expert id (an int; None
    = one rank owning every expert). Returns (out (T, D) in x's dtype --
    PARTIAL under expert parallelism, to be summed over the ranks -- and
    the router logits (T, E_global) fp32). ``interpret`` (Pallas interpret
    mode) raises off its default.

    Under expert parallelism an assignment to another rank's expert goes to
    the overflow group (index E_local) with weight 0, as in the JAX package:
    its blocks are dead (-1), which the grouped-matmul kernel skips and
    writes as zeros, as its plain version does."""
    reject_unported("moe_ffn", interpret=(interpret, None))
    t, d = x.shape
    e_local = w_gate.shape[0]
    weights, ids, logits = route(x, router_w, n_top)
    if expert_offset is not None:
        local = (ids >= expert_offset) & (ids < expert_offset + e_local)
        ids = torch.where(local, ids - expert_offset, e_local).to(ids.dtype)
        weights = torch.where(local, weights, 0.0)
    perm, pos, bexp, n_pad = dispatch(ids, e_local, block_rows)
    tok = torch.arange(t, device=x.device).repeat_interleave(n_top)
    xs = x.new_zeros((n_pad, d)).index_copy(0, pos, x[tok[perm]])
    gate = grouped_matmul(xs, w_gate, bexp)
    up = grouped_matmul(xs, w_up, bexp)
    h = act(gate).to(x.dtype) * up
    y = grouped_matmul(h, w_down, bexp)
    # unsort back to (T, k) order, then the weighted combine in fp32
    yu = y.new_zeros((t * n_top, d)).index_copy(0, perm, y[pos])
    out = (yu.view(t, n_top, d).float() * weights[..., None]).sum(1)
    return out.to(x.dtype), logits
