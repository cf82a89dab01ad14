"""Tensor-parallel serving: prefill, chunked prefill and decode sharded over
a mesh dim.

The counterpart of ``flash_attention_tpu/parallel/tp_inference.py``, with
its Megatron-style partitioning of the Llama layers over the ``model`` dim:

* wq/wk/wv (and Qwen-2's bq/bk/bv) and w_gate/w_up are column-parallel
  (output features local): each rank holds whole attention heads and their
  GQA kv heads, so the attention block, the paged KV cache (sharded on the
  kv-head axis) and its kernels run with no communication, at the local
  widths (Llama-3-8B at tp=2: 16 query heads, 4 kv heads, hidden 7168);
* wo and w_down are row-parallel: one all-reduce (``parallel.mesh.psum``)
  each per layer, in the projection's output dtype;
* the embedding, the norms (Gemma-2's sandwich norms apply after the
  all-reduce) and the lm_head are replicated, so the logits come out
  replicated;
* Mixtral shards the expert axis instead (expert parallelism): each rank
  runs its own experts' groups (``ops.moe.moe_ffn(expert_offset=)``), the
  router stays replicated and the FFN all-reduce sums the partial outputs.

The JAX package runs the single-device step functions under ``shard_map``
with a head-local config; here every rank calls the same ``models.llama``
functions on its own part of the weights (``shard_params``) with the local
config (``local_config``) and ``tp_axis=(mesh, axis)``. As in JAX, the
functions take the full or the already-sharded tree. They return the
replicated logits and this rank's K/V and pages (its kv heads), where JAX
returns global arrays sharded over the mesh.

LoRA stacks do not shard (multi-LoRA with tensor parallelism raises, as in
the JAX engine).
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attention_tpu_torch.models import llama
from flash_attention_tpu_torch.ops.quant import QuantizedTensor
from flash_attention_tpu_torch.parallel.mesh import axis_index, axis_size

# the sharded dim of each stacked (L, in, out) weight: column-parallel
# weights their output dim, row-parallel ones their input dim; the rest
# (embed, norms, lm_head) are replicated
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv")
ROW = ("wo", "w_down")
# MoE: the expert stacks (L, E, d_in, d_out) shard the expert axis, and the
# router is replicated
EXPERTS = ("w_gate", "w_up", "w_down")


def local_config(cfg: llama.LlamaConfig, tp: int) -> llama.LlamaConfig:
    """The config of one rank's part of the model."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"heads {cfg.n_heads}/{cfg.n_kv_heads} must divide tp={tp}")
    if cfg.n_experts:
        # MoE: the EXPERT axis shards (expert parallelism); each local
        # expert keeps the full hidden_dim. Routing stays global.
        if cfg.n_experts % tp:
            raise ValueError(f"n_experts {cfg.n_experts} must divide tp={tp}")
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
            n_experts=cfg.n_experts // tp)
    if cfg.hidden_dim % tp:
        raise ValueError(f"hidden {cfg.hidden_dim} must divide tp={tp}")
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
        hidden_dim=cfg.hidden_dim // tp)


def _part(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/tp of ``t`` along ``dim``, as a tensor
    of its own (the full one can be freed)."""
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of size {n} must divide tp={tp}")
    return t.narrow(dim, rank * (n // tp), n // tp).contiguous()


def shard_leaf(name: str, w, rank: int, tp: int, moe: bool):
    """Rank ``rank``'s part of the param ``name`` (a tensor or a
    ``QuantizedTensor``; ``moe``: the tree has a router), by the JAX
    package's ``tree_specs``. A ``QuantizedTensor``'s values shard like the
    weight and its per-output-channel scales follow the output dim; an int4
    weight packs pairs of rows along k, so a row-parallel shard cuts packed
    rows and needs k / 2 divisible by tp."""
    if name == "lora":
        raise NotImplementedError("LoRA stacks with tensor parallelism are "
                                  "not supported (as in the JAX engine)")
    if tp == 1:
        return w
    if moe and name in EXPERTS:
        dim = 1
    elif name in COLUMN:
        dim = -1
    elif name in ROW:
        dim = 1
    else:
        return w  # replicated
    if isinstance(w, QuantizedTensor):
        scales = _part(w.scales, -1, rank, tp) if dim == -1 else w.scales
        return QuantizedTensor(_part(w.values, dim, rank, tp), scales, w.bits)
    return _part(w, dim, rank, tp)


def _out_dim(w) -> int:
    return (w.values if isinstance(w, QuantizedTensor) else w).shape[-1]


def _is_local(params, cfg: llama.LlamaConfig, tp: int) -> bool:
    """Whether ``params`` is already one rank's part (its wq holds
    n_heads / tp heads)."""
    return tp > 1 and _out_dim(params["wq"]) == (cfg.n_heads // tp
                                                 * cfg.head_dim)


def shard_params(params, cfg: llama.LlamaConfig, mesh, axis: str = "model"):
    """This rank's part of a full param tree (the counterpart of placing the
    tree by ``tree_specs``); a tree already sharded for this mesh comes back
    as it is. The parts are copies: a caller that drops the full tree frees
    it."""
    tp = axis_size(mesh, axis)
    if tp == 1 or _is_local(params, cfg, tp):
        return params
    rank, moe = axis_index(mesh, axis), "w_router" in params
    return {n: shard_leaf(n, w, rank, tp, moe) for n, w in params.items()}


def init_shard(cfg: llama.LlamaConfig, mesh, axis: str = "model", *,
               seed: int = 0, device="cuda", dtype=torch.bfloat16,
               bits: int | None = None):
    """This rank's part of ``llama.init_params(cfg, seed=seed)`` (of its
    ``quantize_params(bits=bits)`` with ``bits``), built one full weight at
    a time and cut at once, so the whole model never sits on the device:
    the peak is this rank's part and one full weight stack."""
    if bits is not None and cfg.n_experts:
        raise NotImplementedError("weight-only quantization of MoE expert "
                                  "stacks is not supported")
    tp, rank = axis_size(mesh, axis), axis_index(mesh, axis)
    local_config(cfg, tp)  # the heads (and experts) must divide tp
    out = {}
    for name, w in llama.iter_params(cfg, seed=seed, device=device,
                                     dtype=dtype):
        if bits is not None:
            w = llama.quantize_leaf(name, w, bits)
        out[name] = shard_leaf(name, w, rank, tp, cfg.n_experts > 0)
        del w
    return out


def tp_decode_step(params, k_pages, v_pages, tokens, lengths, page_tables,
                   write_page, write_off, *, cfg: llama.LlamaConfig,
                   mesh, axis: str = "model", k_scales=None, v_scales=None):
    """Tensor-parallel batched decode step (see the module docstring).

    params: the full or this rank's tree; k_pages/v_pages (L, hk / tp, P,
    ps, hd): this rank's kv heads of the cache, updated in place, with
    optionally the int8 or fp8 cache's per-token scales (L, hk / tp, P, 8,
    128), sharded like the pages. Returns (logits replicated, k_pages,
    v_pages, k_scales, v_scales), the cache rank-local."""
    tp = axis_size(mesh, axis)
    return llama.decode_step(
        shard_params(params, cfg, mesh, axis), k_pages, v_pages, k_scales,
        v_scales, tokens, lengths, page_tables, write_page, write_off,
        local_config(cfg, tp), tp_axis=(mesh, axis))


def tp_prefill_chunk(params, tokens, done, chunk_len, k_pages, v_pages,
                     k_scales, v_scales, prefix_tables, *,
                     cfg: llama.LlamaConfig, mesh, axis: str = "model",
                     logit_rows=None):
    """Tensor-parallel chunked prefill (one chunk). The prefix page gather
    and the chunk attention are kv-head-local (no communication) like
    ``tp_decode_step``; returns (logits replicated, ks, vs (L, b, c,
    hk / tp, hd) rank-local). ``logit_rows`` as in ``llama.prefill_chunk``
    (a port extension there too)."""
    tp = axis_size(mesh, axis)
    return llama.prefill_chunk(
        shard_params(params, cfg, mesh, axis), tokens, done, chunk_len,
        k_pages, v_pages, k_scales, v_scales, prefix_tables,
        local_config(cfg, tp), tp_axis=(mesh, axis), logit_rows=logit_rows)


def tp_prefill(params, tokens, *, cfg: llama.LlamaConfig, mesh,
               axis: str = "model", logit_rows=None):
    """Tensor-parallel prompt forward. Returns (logits replicated, ks, vs)
    with ks/vs (L, b, s, hk / tp, hd): this rank's kv heads. ``logit_rows``:
    the lm_head only at each row's given position (see ``llama.prefill``)."""
    tp = axis_size(mesh, axis)
    return llama.prefill(shard_params(params, cfg, mesh, axis), tokens,
                         local_config(cfg, tp), tp_axis=(mesh, axis),
                         logit_rows=logit_rows)
