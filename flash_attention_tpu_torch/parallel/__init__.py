"""Tensor-parallel serving of the PyTorch port: the mesh, its collectives
and the sharded prefill and decode steps (the ring attention, sharded
attention and pipeline of the JAX package are not ported yet)."""
from flash_attention_tpu_torch.ops.attention import merge_partials
from flash_attention_tpu_torch.parallel.mesh import make_mesh
from flash_attention_tpu_torch.parallel.tp_inference import (tp_decode_step,
                                                             tp_prefill)

__all__ = ["make_mesh", "merge_partials", "tp_decode_step", "tp_prefill"]
