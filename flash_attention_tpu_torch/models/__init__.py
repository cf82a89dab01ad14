"""Models of the PyTorch port."""
from flash_attention_tpu_torch.models import llama

__all__ = ["llama"]
