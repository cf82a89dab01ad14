"""PyTorch port of flash_attention_tpu for NVIDIA Hopper (H100).

The serving path (dense flash attention for prefill, the in-place paged KV
write and paged attention for decode) and the training path (the
differentiable ``flash_attention`` with its three backward kernels, under
``models.llama.train_loss``), the Mixtral MoE feed-forward on both
(``ops.moe``: routing, dispatch and the grouped-matmul kernels with their
backward), weight-only int8/int4 quantized serving (``ops.quant``: the
quantizers and the quantized matmul, under ``llama.quantize_params``), and
the int8/fp8 KV cache (``quantize_kv_pages``, ``Engine(kv_quant=True)``:
the quantized instances of the kv write and paged-attention kernels). Each
kernel is hand-written CUDA on the card and a plain PyTorch version on the
CPU, under the Llama model and the continuous-batching engine. Packed
variable-length batches (``varlen_fwd``, ``varlen_bwd``, ``SegmentIds``,
``segs``) run the attention kernels' segmented instances, and the engine's
chunked prefill (``Engine(chunk_size=)``) runs on them. Long K/V (above
``KV_SPLIT`` keys, or ``fwd(kv_split=)``) runs the forward kernel per chunk
of keys and merges the chunks with ``merge_partials``. The engine's
decode-side options run on the same kernels: multi-step decode
(``Engine(decode_block=)``), prefix caching (``Engine(prefix_cache=True)``)
and speculative decoding (``Engine(draft_cfg=, draft_params=, n_draft=)``).
Multi-LoRA (``models.lora``, ``Engine(lora_rank=)``, ``lora_ids``) serves
and fine-tunes many adapters over one base, and ``models.import_hf`` builds
the params from an HF state dict. ``parallel`` serves tensor-parallel
(``make_mesh``, ``tp_prefill``, ``tp_decode_step``, ``Engine(mesh=)``), one
process a rank over ``torch.distributed``. Imports no JAX.
"""

from flash_attention_tpu_torch.ops.attention import (SegmentIds, bwd,
                                                     flash_attention, fwd,
                                                     merge_partials,
                                                     varlen_bwd, varlen_fwd)
from flash_attention_tpu_torch.ops.kv_update import write_token_kv
from flash_attention_tpu_torch.ops.paged_attention import paged_attention
from flash_attention_tpu_torch.ops.quant import (QuantizedTensor, dequantize,
                                                 quantize_int4, quantize_int8,
                                                 quantize_kv_pages,
                                                 quantized_matmul)
from flash_attention_tpu_torch.serving.engine import Engine

__all__ = ["Engine", "QuantizedTensor", "SegmentIds", "bwd", "dequantize",
           "flash_attention", "fwd", "merge_partials", "paged_attention",
           "quantize_int4",
           "quantize_int8", "quantize_kv_pages", "quantized_matmul", "varlen_bwd", "varlen_fwd",
           "write_token_kv"]
