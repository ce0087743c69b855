"""Training substrate: the train step and host loop (``trainer``) and
atomic, asynchronous checkpoints (``checkpoint``); submodules are imported
by name."""
