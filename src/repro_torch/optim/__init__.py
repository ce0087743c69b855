"""Optimizer substrate: AdamW with fp32, bf16 or int8 moments, learning-rate
schedules, and int8 gradient compression (its mesh exchange waits for
ROADMAP A7); submodules are imported by name."""
