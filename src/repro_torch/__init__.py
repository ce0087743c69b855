"""PyTorch/CUDA port of the anytime cluster-skipping engine (see README)."""
