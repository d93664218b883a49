"""The sampler chain."""
