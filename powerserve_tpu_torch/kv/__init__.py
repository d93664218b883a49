"""The int8 KV cache: dense per-slot slabs or the paged pool."""
