"""Architecture configs and the registry (``configs.registry.ARCHS``)."""
