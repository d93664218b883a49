"""powerserve_tpu_torch — the PyTorch/CUDA port of powerserve_tpu.

Runs the greedy GGUF generation path on an NVIDIA H100 through
hand-written CUDA kernels (csrc/): the quantized matmul, the fused
norm + lm_head (+ argmax) decode head and the int8-cache flash-decode
attention. Every kernel has a plain PyTorch twin that CPU tensors run.
It imports torch and never jax, and nothing of powerserve_tpu: the
jax-free host modules it needs (core/, tokenizer/, tools/synthetic.py)
are its own copies.
"""

__version__ = "0.1.0"
