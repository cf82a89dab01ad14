"""Utilities of the PyTorch port: the parity gates."""
from flash_attention_tpu_torch.utils.metrics import assert_metrics, error_metrics

__all__ = ["error_metrics", "assert_metrics"]
