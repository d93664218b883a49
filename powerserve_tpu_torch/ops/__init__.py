"""Quantized matmul, fused head and attention: kernels and plain twins."""
