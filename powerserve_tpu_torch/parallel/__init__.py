"""Tensor and data parallelism over torch.distributed: one process a rank."""
