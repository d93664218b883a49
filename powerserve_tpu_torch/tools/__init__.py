"""Synthetic GGUF workspaces and random device parameters."""
