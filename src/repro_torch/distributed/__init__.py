"""Meshes over ``torch.distributed``: ``distributed.sharding``."""
