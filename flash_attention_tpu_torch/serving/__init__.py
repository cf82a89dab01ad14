"""Serving stack of the PyTorch port: allocator, scheduler, sampling, engine."""
