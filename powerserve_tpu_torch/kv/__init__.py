"""The int8 KV cache."""
