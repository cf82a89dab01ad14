"""Import HuggingFace Llama / Mistral / Gemma-2 / Qwen-2 / Mixtral weights.

The counterpart of ``flash_attention_tpu/models/import_hf.py``, with the
same conventions: ``params = from_hf_state_dict(state_dict, cfg)`` (or
``from_hf(model)``) builds the port's params dict, which serves as it is or
after ``llama.quantize_params``.

* torch ``nn.Linear`` stores (out, in); the model computes x @ w with w
  (in, out), so every projection is transposed, and stacked on a leading
  layer axis.
* HF RoPE is the half-split ("rotate_half") convention, the model's own.
* Gemma-2's RMSNorm computes ``x * (1 + w)`` from a zero-centred weight;
  the model computes ``x * g``, so every Gemma norm weight gets +1. Its four
  per-layer norms map input_layernorm → norm_attn, post_attention_layernorm
  → norm_post_attn, pre_feedforward_layernorm → norm_mlp and
  post_feedforward_layernorm → norm_post_mlp.
* HF ``layer_types`` (Gemma-2) maps to ``window_pattern``; Mistral's
  config-wide ``sliding_window`` to pattern 1.
* Qwen-2's QKV biases become bq, bk, bv; Mixtral's experts (L, E, in, out).
* A model without ``lm_head.weight`` ties it to the embedding: the lm_head
  is a contiguous copy of ``embed`` transposed, not a view, so an in-place
  update of one never reaches the other (JAX's ``params["embed"].T`` is a
  separate array too).

The port extends both builders with ``device``: each weight is allocated
there and filled a layer at a time straight from the source tensors (the
transpose, the cast and, on a card, the upload in one ``copy_``), so no fp32
copy of the whole model is ever made on the host. ``config_from_hf`` reads
the config object's attributes by name and needs no ``transformers``.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.models.llama import LlamaConfig


def _window_from_hf(hf_config) -> tuple[int | None, int]:
    """(sliding_window, window_pattern) from an HF config.

    Gemma-2 publishes per-layer ``layer_types``; Mistral a single
    ``sliding_window`` for every layer; Llama neither."""
    window = getattr(hf_config, "sliding_window", None)
    if window is None:
        return None, 1
    types = getattr(hf_config, "layer_types", None)
    if not types or all(t == "sliding_attention" for t in types):
        return int(window), 1
    # alternating local/global (Gemma-2): sliding layers every `period`
    # starting at 0; any other published pattern raises
    period = next((i for i, t in enumerate(types[1:], 1)
                   if t == "sliding_attention"), len(types))
    ok = (types[0] == "sliding_attention"
          and all((t == "sliding_attention") == (i % period == 0)
                  for i, t in enumerate(types)))
    if not ok:
        raise ValueError(f"unsupported layer_types pattern: {types}")
    return int(window), period


def _rope_scaling_from_hf(hf_config):
    """HF ``rope_scaling`` as ``LlamaConfig.rope_scaling``. Only the
    Llama-3.1 remap ("llama3") is modelled; any other kind raises."""
    rs = getattr(hf_config, "rope_scaling", None)
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind == "default":
        return None
    if kind != "llama3":
        raise ValueError(f"unsupported rope_scaling type: {kind!r}")
    return (float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"]))


def config_from_hf(hf_config) -> LlamaConfig:
    window, pattern = _window_from_hf(hf_config)
    kind = getattr(hf_config, "model_type", "llama")
    kw = {}
    if kind == "gemma2":
        qs = getattr(hf_config, "query_pre_attn_scalar", None)
        kw = dict(
            attn_softcap=getattr(hf_config, "attn_logit_softcapping", None),
            final_softcap=getattr(hf_config, "final_logit_softcapping", None),
            act="gelu",  # hidden_activation = gelu_pytorch_tanh
            post_norms=True,
            query_scale=None if qs is None else float(qs),
            embed_scale=True,
        )
    if kind == "mixtral":
        kw = dict(n_experts=hf_config.num_local_experts,
                  n_experts_per_tok=hf_config.num_experts_per_tok)
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        # Qwen-2 carries QKV biases; its older configs have no
        # attention_bias attribute (implicitly true for the family)
        attn_bias=bool(getattr(hf_config, "attention_bias",
                               kind == "qwen2")),
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        head_dim=getattr(hf_config, "head_dim", None)
        or hf_config.hidden_size // hf_config.num_attention_heads,
        hidden_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=_rope_scaling_from_hf(hf_config),
        norm_eps=hf_config.rms_norm_eps,
        sliding_window=window,
        window_pattern=pattern,
        **kw,
    )


def from_hf_state_dict(state_dict, cfg: LlamaConfig, dtype=torch.bfloat16,
                       device="cuda"):
    """The params dict from an HF Llama / Mistral / Gemma-2 / Qwen-2 /
    Mixtral state dict (torch tensors or numpy arrays keyed
    ``model.layers.N.self_attn.q_proj.weight`` etc.), in ``dtype`` on
    ``device``."""
    device = torch.device(device)
    L = cfg.n_layers
    # Gemma RMSNorm stores zero-centred weights and computes x * (1 + w)
    norm_shift = 1.0 if cfg.post_norms else 0.0

    def get(name):
        t = state_dict[name]
        return t.detach() if isinstance(t, torch.Tensor) \
            else torch.from_numpy(np.asarray(t))

    def fill(names, prep=lambda t: t):
        """One (len(names), ...) tensor, row i copied from names[i]."""
        out = torch.empty((len(names), *prep(get(names[0])).shape),
                          dtype=dtype, device=device)
        for i, n in enumerate(names):
            out[i].copy_(prep(get(n)))
        return out

    def stack_linear(fmt):
        # nn.Linear holds (out, in): transposed to (in, out), layers stacked
        return fill([fmt.format(i) for i in range(L)], lambda t: t.t())

    def stack_vec(fmt):
        # in fp32 with the shift, then rounded once, as the JAX import does
        return fill([fmt.format(i) for i in range(L)],
                    lambda t: t.float() + norm_shift)

    def stack_experts(fmt):
        # Mixtral experts: nn.Linear (out, in) per (layer, expert) ->
        # (L, E, in, out)
        shape = get(fmt.format(0, 0)).t().shape
        out = torch.empty((L, cfg.n_experts, *shape), dtype=dtype,
                          device=device)
        for i in range(L):
            for e in range(cfg.n_experts):
                out[i, e].copy_(get(fmt.format(i, e)).t())
        return out

    def one(name, prep=lambda t: t):
        t = prep(get(name))
        return torch.empty(t.shape, dtype=dtype, device=device).copy_(t)

    pre_mlp_norm = ("model.layers.{}.pre_feedforward_layernorm.weight"
                    if cfg.post_norms
                    else "model.layers.{}.post_attention_layernorm.weight")
    params = {
        "embed": one("model.embed_tokens.weight"),
        "wq": stack_linear("model.layers.{}.self_attn.q_proj.weight"),
        "wk": stack_linear("model.layers.{}.self_attn.k_proj.weight"),
        "wv": stack_linear("model.layers.{}.self_attn.v_proj.weight"),
        "wo": stack_linear("model.layers.{}.self_attn.o_proj.weight"),
        "norm_attn": stack_vec("model.layers.{}.input_layernorm.weight"),
        "norm_mlp": stack_vec(pre_mlp_norm),
        "norm_out": one("model.norm.weight",
                        lambda t: t.float() + norm_shift),
    }
    if cfg.n_experts:  # Mixtral sparse MoE block (w1 gate / w3 up / w2 down)
        params["w_router"] = stack_linear(
            "model.layers.{}.block_sparse_moe.gate.weight")
        params["w_gate"] = stack_experts(
            "model.layers.{}.block_sparse_moe.experts.{}.w1.weight")
        params["w_up"] = stack_experts(
            "model.layers.{}.block_sparse_moe.experts.{}.w3.weight")
        params["w_down"] = stack_experts(
            "model.layers.{}.block_sparse_moe.experts.{}.w2.weight")
    else:
        params["w_gate"] = stack_linear(
            "model.layers.{}.mlp.gate_proj.weight")
        params["w_up"] = stack_linear("model.layers.{}.mlp.up_proj.weight")
        params["w_down"] = stack_linear(
            "model.layers.{}.mlp.down_proj.weight")
    if cfg.post_norms:  # Gemma-2 sandwich norms
        params["norm_post_attn"] = stack_vec(
            "model.layers.{}.post_attention_layernorm.weight")
        params["norm_post_mlp"] = stack_vec(
            "model.layers.{}.post_feedforward_layernorm.weight")
    if cfg.attn_bias:  # Qwen-2 QKV biases (1-D: no transpose, no shift)
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"),
                             ("bv", "v_proj")):
            params[ours] = fill([f"model.layers.{i}.self_attn.{theirs}.bias"
                                 for i in range(L)])
    if "lm_head.weight" in state_dict:
        params["lm_head"] = one("lm_head.weight", lambda t: t.t())
    else:  # tied embeddings: a copy, never a view of embed
        params["lm_head"] = params["embed"].t().contiguous()
    return params


def from_hf(model, dtype=torch.bfloat16, device="cuda"):
    """Import from an instantiated ``transformers`` causal-LM model
    (Llama / Mistral / Gemma-2 / Qwen-2 / Mixtral): (params, cfg)."""
    cfg = config_from_hf(model.config)
    return from_hf_state_dict(model.state_dict(), cfg, dtype, device), cfg
