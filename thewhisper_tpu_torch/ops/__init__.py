"""Hand-written CUDA kernels (``csrc/``) and their plain torch versions."""
