"""Config, GGUF I/O, quantization codecs, logging, device selection."""
