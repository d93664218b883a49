"""Llama-family model and GGUF loader."""
