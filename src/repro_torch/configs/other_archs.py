"""GNN and RecSys architectures — exact published configs.

The counterpart of the JAX package's ``configs/other_archs.py``, unchanged
but for its imports.
"""

from __future__ import annotations

from repro_torch.configs.base import GNNArch, RecArch
from repro_torch.models.recsys import RecConfig


def _bst() -> RecConfig:
    # Behavior Sequence Transformer [arXiv:1905.06874]
    return RecConfig(
        name="bst", arch="bst", n_items=4_194_304, embed_dim=32, seq_len=20,
        n_fields=8, field_vocab=100_000, n_blocks=1, n_heads=8,
        mlp=(1024, 512, 256),
    )


def _bst_reduced() -> RecConfig:
    return RecConfig(
        name="bst-smoke", arch="bst", n_items=1000, embed_dim=16, seq_len=8,
        n_fields=4, field_vocab=100, n_blocks=1, n_heads=4, mlp=(64, 32),
    )


def _mind() -> RecConfig:
    # MIND multi-interest [arXiv:1904.08030]
    return RecConfig(
        name="mind", arch="mind", n_items=8_388_608, embed_dim=64, seq_len=50,
        n_interests=4, capsule_iters=3,
    )


def _mind_reduced() -> RecConfig:
    return RecConfig(
        name="mind-smoke", arch="mind", n_items=1000, embed_dim=16, seq_len=8,
        n_interests=2, capsule_iters=2,
    )


def _autoint() -> RecConfig:
    # AutoInt [arXiv:1810.11921]: 39 sparse fields, 3 attn layers, 2 heads.
    return RecConfig(
        name="autoint", arch="autoint", n_items=16, embed_dim=16, n_fields=39,
        field_vocab=1_000_000, n_attn_layers=3, d_attn=32,
    )


def _autoint_reduced() -> RecConfig:
    return RecConfig(
        name="autoint-smoke", arch="autoint", n_items=16, embed_dim=8,
        n_fields=6, field_vocab=100, n_attn_layers=2, d_attn=8,
    )


def _bert4rec() -> RecConfig:
    # BERT4Rec [arXiv:1904.06690]
    return RecConfig(
        name="bert4rec", arch="bert4rec", n_items=1_048_576, embed_dim=64,
        seq_len=200, n_blocks=2, n_heads=2,
    )


def _bert4rec_reduced() -> RecConfig:
    return RecConfig(
        name="bert4rec-smoke", arch="bert4rec", n_items=500, embed_dim=16,
        seq_len=16, n_blocks=2, n_heads=2,
    )


OTHER_ARCHS = [
    GNNArch("graphsage-reddit"),
    RecArch("bst", _bst, _bst_reduced),
    RecArch("mind", _mind, _mind_reduced),
    RecArch("autoint", _autoint, _autoint_reduced),
    RecArch("bert4rec", _bert4rec, _bert4rec_reduced),
]
