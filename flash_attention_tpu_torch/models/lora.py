"""Multi-LoRA: per-request low-rank adapters over one base model.

The counterpart of ``flash_attention_tpu/models/lora.py``. An adapter adds
``x @ A @ B`` (rank r, alpha/r folded into A) to a subset of the
projections. To serve many adapters at once, the engine stacks every
registered adapter on a slot axis and each batch row carries its slot id;
inside the layer the row's (A, B) are gathered and applied as two small
batched products, so one dispatch serves a batch that mixes adapters. Slot
0 is the all-zeros null adapter: the base model, with a delta of exactly 0.

The stacks are laid out as the JAX package lays them out, the layer axis
first: {target: (A (L, n_slots, din, r), B (L, n_slots, r, dout))}, so the
model unbinds them per layer as it unbinds the weights. ``set_slot`` writes
a slot in place (JAX returns new arrays). The two products of ``delta`` run
in fp32, as JAX's einsums do, and are left in fp32 on the card: the port
never sets ``torch.backends.cuda.matmul.allow_tf32``, whose default keeps
fp32 products out of TF32. They are plain ``torch.bmm`` (JAX computes them
with XLA outside any Pallas kernel).
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.models.checkpoint import to_tensor

# projections LoRA can target, with their (in, out) dims per LlamaConfig
_TARGET_DIMS = {
    "wq": lambda c: (c.dim, c.n_heads * c.head_dim),
    "wk": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wv": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wo": lambda c: (c.n_heads * c.head_dim, c.dim),
    "w_gate": lambda c: (c.dim, c.hidden_dim),
    "w_up": lambda c: (c.dim, c.hidden_dim),
    "w_down": lambda c: (c.hidden_dim, c.dim),
}


def init_adapter(rng, cfg, rank: int, targets=("wq", "wk", "wv", "wo"),
                 alpha: float | None = None, dtype=torch.float32):
    """Random LoRA adapter: {target: (A (L, din, r), B (L, r, dout))}.

    ``rng`` is a ``torch.Generator``; the adapter is drawn on its device.
    The standard init, A gaussian N(0, 1/din) times alpha/r and B zeros,
    makes a fresh adapter a no-op (``alpha`` defaults to ``rank``)."""
    alpha = float(rank) if alpha is None else alpha
    out = {}
    for t in targets:
        din, dout = _TARGET_DIMS[t](cfg)
        a = torch.randn((cfg.n_layers, din, rank), generator=rng,
                        device=rng.device, dtype=torch.float32)
        a = (a * din**-0.5 * (alpha / rank)).to(dtype)
        out[t] = (a, torch.zeros((cfg.n_layers, rank, dout), dtype=dtype,
                                 device=rng.device))
    return out


def adapter_from_jax(np_adapter, device, dtype):
    """An adapter (or a dict of stacks) of the JAX package as numpy arrays,
    {target: (A, B)}, cast and moved."""
    return {t: tuple(to_tensor(x).to(device=device, dtype=dtype)
                     for x in ab)
            for t, ab in np_adapter.items()}


def merge_adapter(params, adapter):
    """Fold an adapter into the base weights, W' = W + A @ B, a layer at a
    time (no (L, din, dout) fp32 transient). The serving oracle: a row on a
    stacked adapter must generate what the merged model does."""
    out = dict(params)
    for t, (a, b) in adapter.items():
        w = params[t].detach().clone()
        for i in range(w.shape[0]):
            w[i] += torch.matmul(a[i], b[i]).to(w.dtype)
        out[t] = w
    return out


def stack_adapters(cfg, adapters: list, rank: int, targets, n_slots: int,
                   dtype=torch.float32, device="cuda"):
    """Stack adapters on a slot axis, id 0 = the null adapter (base model).

    Returns {target: (A (L, n_slots, din, r), B (L, n_slots, r, dout))} on
    ``device``, the layer axis first. ``n_slots`` is fixed up front (the
    engine's capacity): registering another adapter writes a slot."""
    stacks = {}
    for t in targets:
        din, dout = _TARGET_DIMS[t](cfg)
        stacks[t] = (
            torch.zeros((cfg.n_layers, n_slots, din, rank), dtype=dtype,
                        device=device),
            torch.zeros((cfg.n_layers, n_slots, rank, dout), dtype=dtype,
                        device=device))
    for i, ad in enumerate(adapters, start=1):
        set_slot(stacks, i, ad, targets)
    return stacks


@torch.no_grad()  # stacks that are training leaves take the write too
def set_slot(stacks, slot: int, adapter, targets):
    """Write ``adapter`` into slot ``slot`` of each target's stacks, in
    place (a target the adapter lacks gets zeros). Returns the stacks of
    ``targets``."""
    out = {}
    for t in targets:
        a, b = stacks[t]
        if t in adapter:
            a[:, slot].copy_(adapter[t][0])
            b[:, slot].copy_(adapter[t][1])
        else:
            a[:, slot].zero_()
            b[:, slot].zero_()
        out[t] = (a, b)
    return out


def delta(h, lr, target, ids):
    """Per-row LoRA delta for one layer: h (b, [s,] din) @ A[ids] @ B[ids].

    lr: {target: (A (n_slots, din, r), B (n_slots, r, dout))}, this layer's
    slices; ids (b,) int, a tensor on h's device. Both products run in fp32
    and the delta comes back in h's dtype, or None if the target is not
    adapted."""
    if lr is None or target not in lr:
        return None
    a, b = lr[target]
    a_sel, b_sel = a[ids].float(), b[ids].float()  # (b, din, r), (b, r, dout)
    h32 = h.float()
    if h.dim() == 3:                                # (b, s, din)
        d = torch.bmm(torch.bmm(h32, a_sel), b_sel)
    else:                                           # (b, din)
        d = torch.bmm(torch.bmm(h32[:, None], a_sel), b_sel)[:, 0]
    return d.to(h.dtype)
