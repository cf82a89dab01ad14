"""Serving stack of the PyTorch port: allocator, scheduler, sampling, engine."""
from flash_attention_tpu_torch.serving.engine import Engine
from flash_attention_tpu_torch.serving.native import PagedRuntime
from flash_attention_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "PagedRuntime", "Request", "Scheduler"]
