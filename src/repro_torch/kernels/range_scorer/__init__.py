"""Range scorer: plain versions (ref), CUDA kernels (kernel), entry point (ops)."""
