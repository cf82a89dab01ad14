"""Attention operators of the PyTorch port and their CUDA kernels."""
from flash_attention_tpu_torch.ops.attention import (bwd, flash_attention, fwd,
                                                     varlen_bwd, varlen_fwd)
from flash_attention_tpu_torch.ops.reference import reference_attention

__all__ = ["flash_attention", "fwd", "bwd", "varlen_fwd", "varlen_bwd",
           "reference_attention"]
