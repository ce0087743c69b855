"""Optimizer substrate: AdamW with fp32, bf16 or int8 moments, learning-rate
schedules, and int8 gradient compression with its exchange over a mesh's
pod axis; submodules are imported by name."""
