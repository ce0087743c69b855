"""Embedding-bag reduce: plain versions (ref), CUDA kernel (kernel), entry point (ops)."""
