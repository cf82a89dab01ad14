"""Llama-family transformer on the port's kernels.

The PyTorch counterpart of ``flash_attention_tpu/models/llama.py`` for the
serving and training paths: RMSNorm + RoPE (with the Llama-3.1 frequency
remap) + GQA attention + SwiGLU, optional QKV biases (Qwen-2), and the
Mixtral sparse MoE feed-forward (``ops.moe``: top-k routing, the sorted
block dispatch and the grouped-matmul kernels) when ``n_experts > 0``.
Sliding windows (Mistral: every layer; Gemma-2: every ``window_pattern``-th
layer, ``LlamaConfig.layer_window``) and the attention softcap run in the
attention kernels themselves; the Gemma-2 extras (GeGLU, sandwich norms,
the embedding scale, ``query_scale`` and the final-logit softcap) around
them.

* ``prefill`` runs the dense flash attention (``ops.attention``) and returns
  logits plus every layer's K/V for the cache; with ``return_kv=False`` and
  ``remat=True`` it is the training forward, each layer under
  ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` around
  the layer-scan body).
* ``train_loss`` is the mean next-token cross-entropy over that forward;
  ``.backward()`` reaches the flash-attention backward kernels.
* ``decode_step`` writes each layer's new K/V into the layer-stacked paged
  cache in place (``ops.kv_update``) and attends with ``ops.paged_attention``.
* ``prefill_chunk`` runs one chunk of a chunked prefill: the chunk's queries
  attend to the prefix gathered from the pages and the chunk itself through
  the segmented flash forward (``fwd(segs=...)``), with the segment ids and
  global positions that mask the dead prefix slots and the chunk's pad tail.
* A quantized KV cache (int8 or fp8 e4m3 pages with per-token scales in
  (L, hk, P, 8, 128) fp32 tiles, ``ops.quant.quantize_kv_pages``' layout):
  ``decode_step`` quantizes each layer's new K/V and writes it in one
  launch (``ops.kv_update.quantize_write_token_kv``), and the paged kernel
  folds the scales into its softmax; ``write_prefill_to_pages`` quantizes
  a prefill's K/V page by page and ``prefill_chunk`` dequantizes the prefix
  it gathers, in plain torch, as the JAX package does in XLA.
  ``prefill(kv_fake_quant=)`` rounds K/V through the same quantizer.
* ``write_chunk_to_pages`` commits a chunk's K/V at token granularity (a
  speculative verification chunk starts anywhere in a page): one launch of
  the kv-write kernel per chunk position, over every layer at once.

Parameters are a plain dict of tensors with layer weights stacked on axis 0,
``(L, in, out)``, the JAX package's layout, so ``params_from_jax`` is a cast
and a move. ``lax.scan`` over layers becomes a Python loop; the cache stays
one (L, hk, P, page_size, d) tensor that the kernels index by layer. The
large projections and the lm_head are ``torch.matmul``, as the JAX package
left them to XLA.

``quantize_params`` makes a weight-only int8 or int4 model: the seven
projections of every layer become stacked ``QuantizedTensor``s (values
(L, k or k / 2, n), scales (L, n)) and the lm_head a single one. Every
product with such a weight then runs ``ops.quant.quantized_matmul`` (the
qmm kernel on the card). A quantized model serves; ``train_loss`` on it
raises, as the JAX package has no gradient for the quantized matmul.

Multi-LoRA (``models.lora``): params may carry ``"lora"``, stacked adapters
{target: (A (L, slots, din, r), B (L, slots, r, dout))}, and ``prefill``,
``decode_step``, ``prefill_chunk`` and ``train_loss`` then take
``lora_ids`` ((b,) slot per row) and add each row's delta after every
targeted projection (the attention's four and the FFN's three), at the JAX
package's points; over a quantized base the delta follows the quantized
matmul. Without stacks ``lora_ids`` is ignored, as in JAX.

Tensor parallelism (``parallel.tp_inference``): ``prefill``,
``prefill_chunk``, ``decode_step`` and ``train_loss`` take
``tp_axis=(mesh, axis)`` on one rank's part of the weights with the local
config, and all-reduce the attention's wo output and the FFN's output over
that mesh dim (``parallel.mesh.reduce_from``: ``psum`` in the projection's
dtype, as JAX's, with an identity backward); Gemma-2's sandwich norms apply
after the all-reduce. A Mixtral rank runs its own experts
(``moe_ffn(expert_offset=)``). When autograd records, the normed residual
stream enters the column-parallel projections (and a Mixtral rank's router
and experts) through ``parallel.mesh.copy_to``, whose backward sums the
ranks' partial gradients, so every replicated weight (embed, norms,
lm_head, the router) gets the whole gradient, the same bits on each rank,
and the loss is replicated.

A K/V cache may be wider than the head dim (``ops.attention.
kernel_head_dim``: d 80 or 96 held at 128, d 320 at 384, as the engine
allocates it for the kernels): the writes zero-pad each token's K/V to the
cache's width (on the card the kv write's kernel writes the zero columns
itself) and the reads slice it back.

Outside this slice (they raise): quantized MoE experts and LoRA stacks with
tensor parallelism. On the card, head dims above 512 raise in the attention
kernels and their backward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flash_attention_tpu_torch.models import lora
from flash_attention_tpu_torch.models.checkpoint import to_tensor
from flash_attention_tpu_torch.ops.attention import flash_attention, fwd
from flash_attention_tpu_torch.ops.kv_update import (quantize_write_token_kv,
                                                     write_token_kv)
from flash_attention_tpu_torch.ops.moe import moe_ffn
from flash_attention_tpu_torch.ops.paged_attention import paged_attention
from flash_attention_tpu_torch.ops.paged_attention import pad_head_dim
from flash_attention_tpu_torch.ops.quant import (KV_QMAX, QuantizedTensor,
                                                 _quantize_token,
                                                 quantize_int4, quantize_int8,
                                                 quantized_matmul)
from flash_attention_tpu_torch.parallel.mesh import (axis_index, copy_to,
                                                     reduce_from)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    hidden_dim: int = 11008
    rope_theta: float = 10000.0
    # Llama-3.1 RoPE remap: (factor, low_freq_factor, high_freq_factor,
    # original_max_position), HF rope_type "llama3"; None = plain RoPE.
    rope_scaling: tuple[float, float, float, int] | None = None
    norm_eps: float = 1e-5
    sliding_window: int | None = None
    window_pattern: int = 1
    attn_softcap: float | None = None
    final_softcap: float | None = None
    act: str = "silu"
    post_norms: bool = False
    query_scale: float | None = None
    embed_scale: bool = False
    attn_bias: bool = False
    n_experts: int = 0
    n_experts_per_tok: int = 2

    @property
    def sm_scale(self) -> float | None:
        return None if self.query_scale is None else self.query_scale**-0.5

    def layer_window(self, j: int) -> int | None:
        """Sliding window of layer ``j`` (None = global attention)."""
        if self.sliding_window is None or j % self.window_pattern:
            return None
        return self.sliding_window

    @classmethod
    def llama2_7b(cls):
        return cls()

    @classmethod
    def mistral_7b(cls):
        """Mistral-7B-v0.1 geometry: GQA (8 kv heads) + 4096 sliding window."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=14336,
                   rope_theta=10000.0, sliding_window=4096)

    @classmethod
    def llama3_8b(cls):
        """Llama-3-8B geometry: GQA (8 kv heads), 128k vocab, theta 5e5."""
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=14336,
                   rope_theta=500000.0)

    @classmethod
    def llama31_8b(cls):
        """Llama-3.1-8B: the 3.0 geometry plus the long-context RoPE remap."""
        return dataclasses.replace(cls.llama3_8b(),
                                   rope_scaling=(8.0, 1.0, 4.0, 8192))

    @classmethod
    def qwen2_7b(cls):
        """Qwen2-7B geometry: GQA (4 kv heads), QKV biases, theta 1e6."""
        return cls(vocab_size=152064, dim=3584, n_layers=28, n_heads=28,
                   n_kv_heads=4, head_dim=128, hidden_dim=18944,
                   rope_theta=1e6, norm_eps=1e-6, attn_bias=True)

    @classmethod
    def gemma2_9b(cls):
        """Gemma-2-9B geometry: alternating 4096-window/global layers, GeGLU,
        sandwich norms, attention softcap 50 and final-logit softcap 30. Its
        head dim 256 runs as it is in the card's attention kernels (the
        forward, the backward's three and paged decode) and in the plain
        versions on the CPU."""
        return cls(vocab_size=256000, dim=3584, n_layers=42, n_heads=16,
                   n_kv_heads=8, head_dim=256, hidden_dim=14336,
                   rope_theta=10000.0, sliding_window=4096, window_pattern=2,
                   attn_softcap=50.0, final_softcap=30.0, act="gelu",
                   post_norms=True, query_scale=256.0, embed_scale=True)

    @classmethod
    def mixtral_8x7b(cls):
        """Mixtral-8x7B geometry: 8 experts, top-2, GQA (8 kv heads),
        theta 1e6, no sliding window (v0.1)."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, head_dim=128, hidden_dim=14336,
                   rope_theta=1e6, n_experts=8, n_experts_per_tok=2)

    @classmethod
    def tiny_moe(cls, **kw):
        d = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, head_dim=128, hidden_dim=512, n_experts=4,
                 n_experts_per_tok=2)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        d = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, head_dim=128, hidden_dim=512)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny_qwen2(cls, **kw):
        d = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, head_dim=128, hidden_dim=512, attn_bias=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny_gemma2(cls, **kw):
        d = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, head_dim=128, hidden_dim=512,
                 sliding_window=64, window_pattern=2, attn_softcap=50.0,
                 final_softcap=30.0, act="gelu", post_norms=True,
                 query_scale=128.0, embed_scale=True)
        d.update(kw)
        return cls(**d)


_LAYER_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "norm_attn", "norm_mlp")
_BIAS_NAMES = ("bq", "bk", "bv")
_POST_NAMES = ("norm_post_attn", "norm_post_mlp")
_OPTIONAL_NAMES = _BIAS_NAMES + _POST_NAMES + ("w_router",)
# every leaf stacked on a leading (layer) axis
_PER_LAYER = _LAYER_NAMES + _OPTIONAL_NAMES
_MATMUL_NAMES = _LAYER_NAMES[:7]  # the weights quantize_params quantizes


def check_supported(cfg: LlamaConfig, params=None, tp_axis=None) -> None:
    """Raise for what this slice of the port does not run. ``tp_axis`` is
    None or a (mesh, mesh dim name) pair; a bare axis name (the JAX
    package's form, bound by ``shard_map``) names no process group here."""
    unsupported = {
        "tp_axis as a bare axis name (pass (mesh, axis))":
            tp_axis is not None and not (isinstance(tp_axis, tuple)
                                         and len(tp_axis) == 2
                                         and isinstance(tp_axis[1], str)),
    }
    if params is not None:
        unsupported["LoRA stacks with tensor parallelism"] = (
            tp_axis is not None and "lora" in params)
        unsupported["quantized MoE experts"] = (
            "w_router" in params and is_quantized(params))
        unsupported["weights other than tensors and QuantizedTensors"] = any(
            not isinstance(params[n], torch.Tensor)
            and not (n in _MATMUL_NAMES and isinstance(params[n],
                                                       QuantizedTensor))
            for n in _LAYER_NAMES)
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"outside this slice of the PyTorch port: {', '.join(bad)}")
    period = cfg.window_pattern if cfg.sliding_window is not None else 1
    if cfg.n_layers % period:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"window_pattern {period}")


def is_quantized(params) -> bool:
    """Whether any weight of ``params`` is a ``QuantizedTensor``."""
    return any(isinstance(w, QuantizedTensor) for w in params.values())


def _randn_into(out: torch.Tensor, scale: float, gen: torch.Generator,
                rows: int = 8192) -> None:
    """Fill a 2D slice with N(0, scale^2) drawn in fp32 on its device, a few
    thousand rows at a time, so no full-size fp32 transient exists."""
    for r0 in range(0, out.shape[0], rows):
        blk = out[r0:r0 + rows]
        blk.copy_(torch.randn(blk.shape, generator=gen, device=out.device,
                              dtype=torch.float32) * scale)


def init_params(cfg: LlamaConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random parameters drawn on ``device`` from ``seed``, layer by layer.

    Same layout and scales as the JAX package's ``init_params`` (a weight
    (in, out) is N(0, 1/in)); the numbers differ (another generator). Layer
    weights are stacked on axis 0. With ``n_experts`` E > 0 the FFN weights
    are expert stacks, w_gate/w_up (L, E, D, F) and w_down (L, E, F, D), and
    the router w_router (L, D, E) is N(0, 0.02^2)."""
    check_supported(cfg)
    return dict(iter_params(cfg, seed=seed, device=device, dtype=dtype))


def iter_params(cfg: LlamaConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """``init_params``' parameters one at a time, as (name, tensor) pairs in
    its order and with its values: a caller that keeps only a part of each
    (a tensor-parallel rank, ``parallel.tp_inference.init_shard``) never
    holds the whole model."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, D, H, HK, hd, F = (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.hidden_dim)
    E = cfg.n_experts
    shapes = {"wq": (D, H * hd), "wk": (D, HK * hd), "wv": (D, HK * hd),
              "wo": (H * hd, D), "w_gate": (D, F), "w_up": (D, F),
              "w_down": (F, D)}
    experts = (E,) if E else ()
    for name, (din, dout) in shapes.items():
        stack = experts if name in ("w_gate", "w_up", "w_down") else ()
        w = torch.empty((L, *stack, din, dout), dtype=dtype, device=device)
        for mat in w.view(-1, din, dout):  # each (layer, expert) slice
            _randn_into(mat, din**-0.5, gen)
        yield name, w
        del w
    if E:
        w = torch.empty((L, D, E), dtype=dtype, device=device)
        for i in range(L):
            _randn_into(w[i], 0.02, gen)
        yield "w_router", w
    w = torch.empty((cfg.vocab_size, D), dtype=dtype, device=device)
    _randn_into(w, 0.02, gen)
    yield "embed", w
    w = torch.empty((D, cfg.vocab_size), dtype=dtype, device=device)
    _randn_into(w, D**-0.5, gen, rows=512)
    yield "lm_head", w
    for name in ("norm_attn", "norm_mlp") + (_POST_NAMES if cfg.post_norms
                                             else ()):
        yield name, torch.ones((L, D), dtype=dtype, device=device)
    yield "norm_out", torch.ones((D,), dtype=dtype, device=device)
    if cfg.attn_bias:
        for name, n in zip(_BIAS_NAMES, (H * hd, HK * hd, HK * hd)):
            w = torch.empty((L, n), dtype=dtype, device=device)
            _randn_into(w, 0.02, gen)
            yield name, w


@torch.no_grad()  # trained weights that require grad record no graph
def quantize_params(params, bits: int = 8) -> dict:
    """Weight-only quantization of every per-layer matmul weight and the
    lm_head, int8 (``bits=8``) or int4 (``bits=4``), per output channel.

    Each (k, n) slice is quantized on its own, on the params' device, into
    preallocated stacks, so no fp32 or int32 copy of a whole stack exists
    (the largest transients are those of the lm_head). Other entries are
    shared with ``params``. MoE params raise, as in the JAX package."""
    if "w_router" in params:
        raise NotImplementedError(
            "weight-only quantization of MoE expert stacks is not supported "
            "(the grouped matmul kernel takes float expert weights)")
    return {name: quantize_leaf(name, w, bits) for name, w in params.items()}


@torch.no_grad()
def quantize_leaf(name: str, w, bits: int = 8):
    """The param ``name`` as ``quantize_params`` leaves it: a layer stack of
    the seven projections quantized layer by layer into preallocated
    stacks, the lm_head quantized, any other param as it is."""
    quant = {8: quantize_int8, 4: quantize_int4}.get(bits)
    if quant is None:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if name == "lm_head":
        return quant(w)
    if name not in _MATMUL_NAMES:
        return w
    n_layers, k, n = w.shape
    values = torch.empty((n_layers, k * bits // 8, n), dtype=torch.int8,
                         device=w.device)
    scales = torch.empty((n_layers, n), dtype=torch.float32, device=w.device)
    for i in range(n_layers):
        values[i], scales[i], _ = quant(w[i])
    return QuantizedTensor(values, scales, bits)


def params_from_jax(np_params: dict, device, dtype) -> dict:
    """Carry the JAX package's parameters across: the same names and stacked
    (L, in, out) layout, so each array is only cast and moved.

    A quantized leaf is any value with ``values``, ``scales`` and ``bits``
    (the JAX ``QuantizedTensor`` after ``jax.tree.map(np.asarray, ...)``):
    it becomes a ``QuantizedTensor`` with int8 values and fp32 scales, moved
    but never cast to ``dtype``. A ``"lora"`` entry (JAX's stacks,
    {target: (A, B)}) becomes a dict of (A, B) tensor pairs."""
    out = {}
    for name, a in np_params.items():
        if name == "lora":
            out[name] = lora.adapter_from_jax(a, device, dtype)
        elif all(hasattr(a, f) for f in ("values", "scales", "bits")):
            out[name] = QuantizedTensor(to_tensor(a.values).to(device),
                                        to_tensor(a.scales).to(device),
                                        int(a.bits))
        else:
            out[name] = to_tensor(a).to(device=device, dtype=dtype)
    return out


def _mm(x, w):
    """x @ w in the activation dtype (the product accumulates in fp32); a
    ``QuantizedTensor`` w runs the quantized matmul on x as (-1, k)."""
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x.reshape(-1, x.shape[-1]), w)
        return y.view(*x.shape[:-1], y.shape[-1])
    return torch.matmul(x, w).to(x.dtype)


def _rmsnorm(x, g, eps):
    x32 = x.float()
    n = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (n * g.float()).to(x.dtype)


def _rope(x, positions, theta, scaling=None):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if scaling is not None:
        factor, low_f, high_f, orig_max = scaling
        wavelen = 2.0 * torch.pi / freqs
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen < orig_max / high_f, freqs,
                            torch.where(wavelen > orig_max / low_f,
                                        freqs / factor, mid))
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _layer_weights(params) -> list[dict]:
    """Per-layer views of the stacked (L, ...) weights, one dict per layer.

    One ``unbind`` per weight, so the backward stacks each weight's L
    gradients once; indexing ``params[name][i]`` inside the layer loop would
    make every layer's backward allocate and add a zero-filled gradient of
    the whole stack. A stacked ``QuantizedTensor`` unbinds its values and
    scales into one ``QuantizedTensor`` per layer."""
    def unbind(w):
        if isinstance(w, QuantizedTensor):
            return [QuantizedTensor(v, s, w.bits)
                    for v, s in zip(w.values.unbind(0), w.scales.unbind(0))]
        return w.unbind(0)

    per = {n: unbind(params[n]) for n in _PER_LAYER if n in params}
    n_layers = params["norm_attn"].shape[0]
    layers = [{n: w[i] for n, w in per.items()} for i in range(n_layers)]
    if "lora" in params:  # each layer's (A, B) slices under "lora"
        stacks = {t: (a.unbind(0), b.unbind(0))
                  for t, (a, b) in params["lora"].items()}
        for i, w in enumerate(layers):
            w["lora"] = {t: (a[i], b[i]) for t, (a, b) in stacks.items()}
    return layers


def _lora_ids(params, lora_ids, device):
    """The rows' adapter slots as a (b,) device tensor, or None when params
    carry no LoRA stacks (``lora_ids`` is then ignored, as in JAX). Raises
    the JAX package's errors."""
    if "lora" not in params:
        return None
    if lora_ids is None:
        raise ValueError("params carry LoRA stacks but no lora_ids given")
    if "w_router" in params:
        raise ValueError("LoRA adapters on MoE expert weights are not "
                         "supported (attention-only targets work)")
    return torch.as_tensor(lora_ids, device=device).long()


def _proj(h, w, name, lora_ids=None):
    """h @ w[name], plus its bias (Qwen-2's bq, bk, bv) and, with LoRA
    stacks in w, the rows' adapter delta."""
    out = _mm(h, w[name])
    bias = "b" + name[1]  # wq -> bq
    if bias in w:
        out = out + w[bias]
    d = lora.delta(h, w.get("lora"), name, lora_ids)
    return out if d is None else out + d


def _maybe_psum(x, tp_axis):
    """x summed over the ranks of ``tp_axis`` ((mesh, axis)), or x; the
    gradient passes through unchanged (``reduce_from``)."""
    return x if tp_axis is None else reduce_from(x, *tp_axis)


def _maybe_copy(x, tp_axis):
    """x, with its gradient summed over the ranks of ``tp_axis`` when
    autograd records (``copy_to``)."""
    return x if tp_axis is None else copy_to(x, *tp_axis)


def _act(x, kind: str = "silu"):
    """The gate activation in fp32: SiLU (Llama, Mistral) or GELU in its
    tanh form (Gemma-2's GeGLU)."""
    if kind == "gelu":
        return F.gelu(x.float(), approximate="tanh")
    return F.silu(x.float())


def _ffn(h, w, cfg: LlamaConfig, lora_ids=None, tp_axis=None):
    """The FFN half of a layer, shared by prefill, decode and training:
    SwiGLU (GeGLU with ``act="gelu"``) with the LoRA deltas of its three
    projections, or with a router the sparse MoE layer over every token of
    h (pad rows and pad batch entries included, as in the JAX package).
    Under tensor parallelism a MoE rank holds experts [r E_local, (r + 1)
    E_local) of the global ids (expert parallelism). Returns the output
    before the all-reduce."""
    if "w_router" not in w:
        gate = _act(_proj(h, w, "w_gate", lora_ids), cfg.act)
        return _proj(gate.to(h.dtype) * _proj(h, w, "w_up", lora_ids), w,
                     "w_down", lora_ids)
    off = None
    if tp_axis is not None:
        off = axis_index(*tp_axis) * w["w_gate"].shape[0]
    # the replicated router's gradient from this rank's experts is partial
    router = _maybe_copy(w["w_router"], tp_axis)
    out, _ = moe_ffn(h.reshape(-1, h.shape[-1]), router, w["w_gate"],
                     w["w_up"], w["w_down"], n_top=cfg.n_experts_per_tok,
                     act=lambda a: _act(a, cfg.act), expert_offset=off)
    return out.view(h.shape)


def _post(x, w, name, cfg: LlamaConfig):
    """Gemma-2's sandwich norm on a sublayer's output (with post_norms)."""
    return _rmsnorm(x, w[name], cfg.norm_eps) if cfg.post_norms else x


def _embed(params, tokens, cfg: LlamaConfig):
    """The token embedding, times sqrt(dim) in fp32 with Gemma's embed
    scale, rounded back to the weights' dtype as the JAX package rounds
    it."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.float() * cfg.dim**0.5).to(x.dtype)
    return x


def _head(x, params, cfg: LlamaConfig):
    """The final norm, the lm_head and the final softcap: fp32 logits."""
    x = _rmsnorm(x, params["norm_out"], cfg.norm_eps)
    logits = _mm(x, params["lm_head"]).float()
    if cfg.final_softcap is None:
        return logits
    return cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)


def _loss_sums(x, params, cfg: LlamaConfig, targets):
    """(sum of the next-token NLL over the valid targets, their count) of
    the final hidden states ``x`` (b, s, D): the loss of ``train_loss``
    before its mean. Every target < 0 is ignored."""
    valid = targets >= 0
    nll = F.cross_entropy(_head(x, params, cfg).flatten(0, 1),
                          torch.where(valid, targets, 0).flatten().long(),
                          reduction="none").view(valid.shape)
    return (nll * valid).sum(), valid.sum()


def _fake_quant(t, dtype):
    """t rounded through the KV cache's per-token quantizer and back."""
    tq, sc = _quantize_token(t, dtype)
    return (tq.float() * sc[..., None]).to(t.dtype)


def _dense_layer(x, w, cfg: LlamaConfig, positions, window=None,
                 attend=None, kv_fake_quant=None, lora_ids=None,
                 tp_axis=None):
    """One transformer layer (weights ``w``, one dict of ``_layer_weights``)
    on a dense (b, s, D) activation, with the layer's sliding ``window``
    (None = global). Returns (x, (k, v)) with k/v (b, s, hk, hd) after
    RoPE (and after the quantizer's rounding with ``kv_fake_quant``).
    ``attend(q, k, v, window_size)`` replaces the causal flash attention
    over the layer's own k, v (a chunk's attention to its prefix).
    ``lora_ids`` ((b,) device tensor) selects each row's adapter when w
    carries LoRA slices. ``tp_axis`` ((mesh, axis)): w is one rank's part
    and the wo and FFN outputs are summed over the axis, before Gemma-2's
    sandwich norms."""
    b, s = x.shape[:2]
    h = _maybe_copy(_rmsnorm(x, w["norm_attn"], cfg.norm_eps), tp_axis)
    q = _proj(h, w, "wq", lora_ids).view(b, s, cfg.n_heads, cfg.head_dim)
    k = _proj(h, w, "wk", lora_ids).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(h, w, "wv", lora_ids).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if kv_fake_quant is not None:
        k, v = _fake_quant(k, kv_fake_quant), _fake_quant(v, kv_fake_quant)
    win = None if window is None else (window - 1, 0)
    if attend is None:
        o = flash_attention(q, k, v, causal=True, sm_scale=cfg.sm_scale,
                            window_size=win, softcap=cfg.attn_softcap)
    else:
        o = attend(q, k, v, win)
    attn = _maybe_psum(_proj(o.reshape(b, s, -1), w, "wo", lora_ids),
                       tp_axis)
    x = x + _post(attn, w, "norm_post_attn", cfg)
    h = _maybe_copy(_rmsnorm(x, w["norm_mlp"], cfg.norm_eps), tp_axis)
    mlp = _maybe_psum(_ffn(h, w, cfg, lora_ids, tp_axis), tp_axis)
    return x + _post(mlp, w, "norm_post_mlp", cfg), (k, v)


def _layer_out(x, w, cfg: LlamaConfig, positions, window, kv_fake_quant,
               lora_ids, tp_axis=None):
    return _dense_layer(x, w, cfg, positions, window,
                        kv_fake_quant=kv_fake_quant, lora_ids=lora_ids,
                        tp_axis=tp_axis)[0]


def prefill(params, tokens, cfg: LlamaConfig, tp_axis=None,
            kv_fake_quant=None, lora_ids=None, return_kv: bool = True,
            remat: bool = False, logit_rows=None):
    """Full-prompt forward. tokens: (b, s) int.

    Returns (logits (b, s, vocab) fp32, k_cache (L, b, s, hk, hd), v_cache).
    With ``logit_rows`` ((b,) int) the lm_head runs only at each row's given
    position and logits come back (b, vocab): the full fp32 logits are the
    largest array a serving prefill would touch, and the engine reads one
    row per sequence.

    ``return_kv=False`` is the training forward: no cache is returned, and
    with ``remat`` each layer runs under ``torch.utils.checkpoint``, so the
    backward keeps only each layer's input and recomputes the rest (the
    flash-attention forward included) layer by layer: activation memory
    O(1) in depth for one extra forward of work. As in the JAX package,
    ``remat`` applies only without the cache.

    ``kv_fake_quant`` (``torch.int8`` or ``torch.float8_e4m3fn``) rounds
    each layer's K/V through the quantized cache's per-token quantizer
    before attention (and in the K/V returned): the quality path of the
    quantized cache, what the paged kernel computes from the 8-bit pages
    and their scales. ``lora_ids`` ((b,) int) selects each row's adapter
    slot when ``params["lora"]`` holds the stacks; stacks without it raise
    ValueError. ``tp_axis`` ((mesh, axis)): params and cfg are one rank's
    part (``parallel.tp_inference``), the K/V returned its kv heads."""
    x, ks, vs = _forward(params, tokens, cfg, tp_axis, kv_fake_quant,
                         lora_ids, return_kv, remat)
    if logit_rows is not None:
        x = x[torch.arange(x.shape[0], device=x.device), logit_rows.long()]
    return _head(x, params, cfg), ks, vs


def _forward(params, tokens, cfg: LlamaConfig, tp_axis=None,
             kv_fake_quant=None, lora_ids=None, return_kv: bool = True,
             remat: bool = False):
    """:func:`prefill` up to the final hidden states: (x (b, s, D), k_cache,
    v_cache)."""
    if kv_fake_quant is not None and kv_fake_quant not in KV_QMAX:
        raise ValueError(f"kv_fake_quant must be torch.int8 or "
                         f"torch.float8_e4m3fn, got {kv_fake_quant!r}")
    check_supported(cfg, params, tp_axis)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    ids = _lora_ids(params, lora_ids, x.device)
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks = vs = None
    if return_kv:
        ks = torch.empty((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim),
                         dtype=x.dtype, device=x.device)
        vs = torch.empty_like(ks)
    remat = remat and not return_kv and torch.is_grad_enabled()
    for i, w in enumerate(_layer_weights(params)):
        window = cfg.layer_window(i)
        if remat:
            x = checkpoint(_layer_out, x, w, cfg, positions, window,
                           kv_fake_quant, ids, tp_axis, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        x, (k, v) = _dense_layer(x, w, cfg, positions, window,
                                 kv_fake_quant=kv_fake_quant, lora_ids=ids,
                                 tp_axis=tp_axis)
        if return_kv:
            ks[i], vs[i] = k, v
    return x, ks, vs


def train_loss(params, tokens, targets, cfg: LlamaConfig, *,
               remat: bool = True, tp_axis=None, lora_ids=None):
    """Mean next-token cross-entropy, the training entry point.

    ``targets`` (b, s) int; every target < 0 is ignored (the JAX package's
    rule, so -100 and any other negative marker). Differentiable end to end
    through the flash-attention backward; ``remat`` (the default)
    recomputes each layer in the backward (see :func:`prefill`). Call
    ``.backward()`` on the result, or ``torch.autograd.grad``. With LoRA
    stacks in ``params`` and ``lora_ids``, an adapter-only fine-tune makes
    the stacks the leaves that require grad. ``tp_axis`` ((mesh, axis)):
    params and cfg are one rank's part (``parallel.tp_inference``); the
    loss comes back replicated, and ``.backward()`` on every rank gives
    each sharded leaf its part of the gradient and each replicated one the
    whole (see the module docstring); LoRA stacks with it raise."""
    if is_quantized(params):
        raise NotImplementedError("train_loss on quantized weights: the "
                                  "quantized matmul has no gradient (a "
                                  "quantized model serves)")
    x, _, _ = _forward(params, tokens, cfg, tp_axis, lora_ids=lora_ids,
                       return_kv=False, remat=remat)
    nll, n_valid = _loss_sums(x, params, cfg, targets)
    return nll / n_valid.clamp(min=1)


def decode_step(params, k_pages, v_pages, k_scales, v_scales, tokens, lengths,
                page_tables, write_page, write_off, cfg: LlamaConfig,
                tp_axis=None, lora_ids=None):
    """One decode token for a batch of sequences against the paged cache.

    k_pages/v_pages (L, hk, P, ps, hd) are updated IN PLACE (each layer's
    new K/V lands in its slot before that layer's attention). tokens (b,),
    lengths (b,) int32 including this token, page_tables (b, pages_per_seq)
    int32, write_page/write_off (b,) int32. With k_scales/v_scales
    (L, hk, P, 8, 128) fp32 the cache is int8 or fp8 e4m3 (page size 128):
    each layer's K/V is quantized per token into its slot and its scale
    into lane write_off of the page's tile, updated in place too.
    ``lora_ids`` ((b,) int) selects each row's adapter slot when
    ``params["lora"]`` holds the stacks. The cache may be wider than
    ``cfg.head_dim`` (zero-padded to the kernels' width). ``tp_axis``
    ((mesh, axis)): params, cfg and the cache are one rank's part.

    Returns (logits (b, vocab) fp32, k_pages, v_pages, k_scales, v_scales).
    """
    check_supported(cfg, params, tp_axis)
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)
    ids = _lora_ids(params, lora_ids, x.device)
    pos = (lengths - 1).long()[:, None]
    H, HK, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for i, w in enumerate(_layer_weights(params)):
        h = _rmsnorm(x, w["norm_attn"], cfg.norm_eps)
        q = _proj(h, w, "wq", ids).view(b, 1, H, hd)
        k = _proj(h, w, "wk", ids).view(b, 1, HK, hd)
        v = _proj(h, w, "wv", ids).view(b, HK, hd)
        q = _rope(q, pos, cfg.rope_theta, cfg.rope_scaling)[:, 0]
        k = _rope(k, pos, cfg.rope_theta, cfg.rope_scaling)[:, 0]
        if k_scales is None:
            write_token_kv(k_pages, v_pages, None, None,
                           k.to(k_pages.dtype).contiguous(),
                           v.to(v_pages.dtype).contiguous(), None, None,
                           write_page, write_off, layer=i)
        else:
            quantize_write_token_kv(k_pages, v_pages, k_scales, v_scales,
                                    k.contiguous(), v.contiguous(),
                                    write_page, write_off, layer=i)
        o = paged_attention(q.contiguous(), k_pages, v_pages, lengths,
                            page_tables, k_scales=k_scales,
                            v_scales=v_scales, sm_scale=cfg.sm_scale,
                            window=cfg.layer_window(i),
                            softcap=cfg.attn_softcap, layer=i)
        attn = _maybe_psum(_proj(o.reshape(b, -1), w, "wo", ids), tp_axis)
        x = x + _post(attn, w, "norm_post_attn", cfg)
        h = _rmsnorm(x, w["norm_mlp"], cfg.norm_eps)
        mlp = _maybe_psum(_ffn(h, w, cfg, ids, tp_axis), tp_axis)
        x = x + _post(mlp, w, "norm_post_mlp", cfg)
    return _head(x, params, cfg), k_pages, v_pages, k_scales, v_scales


def prefill_chunk(params, tokens, done, chunk_len, k_pages, v_pages,
                  k_scales, v_scales, prefix_tables, cfg: LlamaConfig,
                  tp_axis=None, lora_ids=None, *, logit_rows=None):
    """One chunk of a chunked prefill.

    tokens (b, c): the next ``chunk_len[i]`` prompt tokens of row i, whose
    first ``done[i]`` tokens already live in the paged cache k_pages/v_pages
    (L, hk, P, ps, hd); prefix_tables (b, npp) int: the pages holding tokens
    [0, npp * ps) of each row (a row with fewer live prefix tokens may pad
    with any valid page id: ``done`` masks it off). Each layer gathers the
    prefix pages densely, and the chunk's queries (positions done + arange(c))
    attend to [prefix || chunk] through the segmented flash forward, with
    causal and the layer's window over positions; prefix slots at or past
    ``done`` and the chunk's tail past ``chunk_len`` carry the pad segment
    ids, so a row with chunk_len 0 gets finite zeros.

    Returns (logits (b, c, vocab) fp32, ks, vs (L, b, c, hk, hd)): the
    chunk's K/V for ``write_prefill_to_pages``. With ``logit_rows`` ((b,)
    int) the lm_head runs only at each row's given chunk position and the
    logits come back (b, vocab), as in :func:`prefill`. With ``k_scales``
    and ``v_scales`` (L, hk, P, 8, 128) fp32 the cache is int8 or fp8: the
    gathered prefix is dequantized with its tokens' scales (lane t of a
    page's tile) in the activations' dtype. ``lora_ids`` ((b,) int)
    selects each row's adapter slot when ``params["lora"]`` holds the
    stacks. ``tp_axis`` ((mesh, axis)): params, cfg and the cache are one
    rank's part, and the K/V returned its kv heads."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    check_supported(cfg, params, tp_axis)
    b, c = tokens.shape
    dev = k_pages.device
    done = torch.as_tensor(done, device=dev).long()
    chunk_len = torch.as_tensor(chunk_len, device=dev).long()
    tables = torch.as_tensor(prefix_tables, device=dev).long()
    ps = k_pages.shape[-2]
    pref = tables.shape[1] * ps
    x = _embed(params, tokens, cfg)
    ids = _lora_ids(params, lora_ids, dev)
    idx = torch.arange(c, device=dev)
    positions = done[:, None] + idx
    # kv = [prefix tokens 0..pref) || chunk tokens done..done + c)
    kv_pos_prefix = torch.arange(pref, device=dev).expand(b, pref)
    live = idx < chunk_len[:, None]
    kv_seg = torch.cat([torch.where(kv_pos_prefix < done[:, None], 0, -1),
                        torch.where(live, 0, -1)], dim=1)
    kv_pos = torch.cat([kv_pos_prefix, positions], dim=1)
    q_seg = torch.where(live, 0, -2)
    segs = tuple(t.int() for t in (q_seg, kv_seg, positions, kv_pos))
    hk, hd = cfg.n_kv_heads, cfg.head_dim
    width = k_pages.shape[-1]  # >= hd: the cache's (kernel) head dim

    def gather(pages, scales, i, dtype):
        # layer i's (hk, b, npp, ps, width) -> (b, npp * ps, hk, hd); 8-bit
        # pages move as bytes
        if scales is None:
            g = pages[i][:, tables]
            return g.permute(1, 2, 3, 0, 4).reshape(
                b, pref, hk, width)[..., :hd].to(dtype)
        g = pages[i].view(torch.uint8)[:, tables].view(pages.dtype)
        g = g.permute(1, 2, 3, 0, 4).reshape(b, pref, hk, width)[..., :hd]
        # token t's scale: lane t of its page's tile, (b, npp * ps, hk)
        sc = scales[i][:, tables][:, :, :, 0, :ps].permute(1, 2, 3, 0)
        return (g.float() * sc.reshape(b, pref, hk)[..., None]).to(dtype)

    ks = torch.empty((cfg.n_layers, b, c, hk, hd), dtype=x.dtype, device=dev)
    vs = torch.empty_like(ks)
    for i, w in enumerate(_layer_weights(params)):
        def attend(q, k, v, win, i=i):
            kcat = torch.cat([gather(k_pages, k_scales, i, k.dtype), k], dim=1)
            vcat = torch.cat([gather(v_pages, v_scales, i, v.dtype), v], dim=1)
            return fwd(q, kcat, vcat, True, sm_scale=cfg.sm_scale, segs=segs,
                       window_size=win, softcap=cfg.attn_softcap)[0]
        x, (ks[i], vs[i]) = _dense_layer(x, w, cfg, positions,
                                         cfg.layer_window(i), attend,
                                         lora_ids=ids, tp_axis=tp_axis)
    if logit_rows is not None:
        x = x[torch.arange(b, device=dev), torch.as_tensor(
            logit_rows, device=dev).long()]
    return _head(x, params, cfg), ks, vs


def write_chunk_to_pages(k_pages, v_pages, layer_kv, done, chunk_len,
                         tables, k_scales=None, v_scales=None):
    """Token-granular scatter of a chunk's K/V into the pages, in place.

    layer_kv: (ks, vs) each (L, b, c, hk, hd) from ``prefill_chunk``;
    done/chunk_len (b,) int; tables (b, npp) int padded with the trash page.
    Chunk position j of row i lands at global position ``done[i] + j``: its
    page is ``tables[i, (done[i] + j) // ps]`` (clipped to the table) and
    its slot ``(done[i] + j) % ps``. Positions past ``chunk_len`` or past
    the row's allocation land in the row's own not yet committed slots or
    in the trash page, as in the JAX package: both are rewritten before any
    read reaches them. Each position j is ONE kv-write launch over every
    layer (``ops.kv_update.write_token_kv``, or ``quantize_write_token_kv``
    on an int8 or fp8 cache, whose scales land in lane ``(done + j) % ps``),
    the pools seen as (1, L * hk, P, ps, hd); on CPU tensors each position
    is the plain ``write_token_kv_reference``. Positions run in order, so a
    slot two positions share keeps the later one, as in JAX.
    Returns (k_pages, v_pages, k_scales, v_scales)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    ks, vs = layer_kv
    L, b, c, hk, hd = ks.shape
    P, ps = k_pages.shape[2], k_pages.shape[3]
    dev = k_pages.device
    tables = torch.as_tensor(tables, device=dev)
    done = torch.as_tensor(done, device=dev).long()
    npp = tables.shape[1]
    # (L, hk) as one head axis: the kernel's layer 0 of L * hk heads
    flat = [None if t is None else t.view(1, L * hk, *t.shape[2:])
            for t in (k_pages, v_pages, k_scales, v_scales)]
    for j in range(c):
        pos = done + j
        wpage = tables.gather(1, (pos // ps).clamp(0, npp - 1)[:, None])[:, 0]
        wpage, woff = wpage.int(), (pos % ps).int()
        kj = ks[:, :, j].transpose(0, 1).reshape(b, L * hk, hd)
        vj = vs[:, :, j].transpose(0, 1).reshape(b, L * hk, hd)
        if k_scales is None:
            write_token_kv(flat[0], flat[1], None, None, kj.to(k_pages.dtype),
                           vj.to(v_pages.dtype), None, None, wpage, woff,
                           layer=0)
        else:
            quantize_write_token_kv(*flat, kj, vj, wpage, woff, layer=0)
    return k_pages, v_pages, k_scales, v_scales


def write_prefill_to_pages(k_pages, v_pages, layer_kv, page_ids, batch_idx,
                           page_in_seq, page_size: int, k_scales=None,
                           v_scales=None):
    """Scatter a whole prefill batch's K/V into pages, in place.

    layer_kv: (ks, vs) each (L, bsz, bucket, hk, hd) from ``prefill``.
    page_ids (N,): destination pages (padding entries may aim at the trash
    page; duplicate destinations there are allowed and left as garbage).
    batch_idx (N,): source batch row per page; page_in_seq (N,): source page
    index within the row (tokens [p * page_size, (p+1) * page_size)). Slots
    past a sequence's length hold pad-position values that are never read.
    With k_scales/v_scales (L, hk, P, 8, 128) fp32 the cache is int8 or fp8
    (page_size <= 128): each page is quantized per token and its scales set
    as its tile's lanes (lanes past the page size 1.0), a layer at a time,
    so no fp32 copy of the whole batch's K/V exists.
    Returns (k_pages, v_pages, k_scales, v_scales)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    ks, vs = layer_kv
    L, bsz, bucket, hk, hd = ks.shape
    bucket_pad = -(-bucket // page_size) * page_size
    dev = k_pages.device
    bidx, pidx = batch_idx.to(dev).long(), page_in_seq.to(dev).long()
    dest = page_ids.to(dev).long()

    width = k_pages.shape[-1]  # >= hd: the cache's (kernel) head dim

    def prep(x):  # (l, bsz, bucket, hk, hd) -> (l, hk, N, page_size, width)
        if bucket_pad != bucket:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, bucket_pad - bucket))
        x = x.reshape(-1, bsz, bucket_pad // page_size, page_size, hk, hd)
        return pad_head_dim(x[:, bidx, pidx].permute(0, 3, 1, 2, 4), width)

    if k_scales is None:
        k_pages[:, :, dest] = prep(ks).to(k_pages.dtype)
        v_pages[:, :, dest] = prep(vs).to(v_pages.dtype)
        return k_pages, v_pages, k_scales, v_scales

    def pack(sc):  # (hk, N, page_size) -> (hk, N, 8, 128): lane = token
        sc = torch.nn.functional.pad(sc, (0, 128 - page_size), value=1.0)
        return sc[:, :, None, :].expand(*sc.shape[:2], 8, 128)

    for pages, scales, x in ((k_pages, k_scales, ks), (v_pages, v_scales, vs)):
        for i in range(L):
            q, sc = _quantize_token(prep(x[i:i + 1])[0], pages.dtype)
            pages.view(torch.uint8)[i, :, dest] = q.view(torch.uint8)
            scales[i, :, dest] = pack(sc)
    return k_pages, v_pages, k_scales, v_scales
