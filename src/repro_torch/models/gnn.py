"""GraphSAGE's configuration (the model comes with the training slice).

The counterpart of the JAX package's ``models/gnn.py``: only
``SAGEConfig``, so that ``GNNArch``'s configurations and input specs exist.
GraphSAGE has only ``train`` shapes; ``init_sage`` and the forward passes
come with training (ROADMAP A5b).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["SAGEConfig"]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    sample_sizes: tuple[int, ...] = (25, 10)
    dtype: Any = torch.float32
