"""Parallelism in the PyTorch port: the mesh and its transport, tensor-
parallel serving, ring and sharded attention, and the training pipeline."""
from flash_attention_tpu_torch.ops.attention import merge_partials
from flash_attention_tpu_torch.parallel.mesh import make_mesh, ppermute
from flash_attention_tpu_torch.parallel.pipeline import (pipeline_train_loss,
                                                         stage_specs)
from flash_attention_tpu_torch.parallel.sharded_attention import (
    ring_flash_attention, shard_flash_attention)
from flash_attention_tpu_torch.parallel.tp_inference import (tp_decode_step,
                                                             tp_prefill)

__all__ = ["make_mesh", "merge_partials", "pipeline_train_loss", "ppermute",
           "ring_flash_attention", "shard_flash_attention", "stage_specs",
           "tp_decode_step", "tp_prefill"]
