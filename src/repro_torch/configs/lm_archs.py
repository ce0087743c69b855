"""The five LM architectures — exact published configs.

The counterpart of the JAX package's ``configs/lm_archs.py``: the same
configs with torch dtypes. Sources: qwen3-4b / qwen2.5-3b [hf],
deepseek-67b [arXiv:2401.02954], deepseek-v3-671b [arXiv:2412.19437],
moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]. Reduced configs keep the same family
features (qk-norm / bias / MLA / MoE / MTP) at smoke-test width.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.attention import GQAConfig, MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def _qwen3_4b() -> LMConfig:
    return LMConfig(
        name="qwen3-4b",
        n_layers=36,
        d_model=2560,
        vocab=151936,
        attn=GQAConfig(
            d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
            qk_norm=True, rope_theta=1_000_000.0,
        ),
        d_ff=9728,
        max_seq=32768,
    )


def _qwen3_4b_reduced() -> LMConfig:
    return LMConfig(
        name="qwen3-4b-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        attn=GQAConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
        d_ff=128,
        max_seq=64,
        dtype=torch.float32,
        attn_chunk=32,
        loss_chunk=64,
    )


def _qwen25_3b() -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        vocab=151936,
        attn=GQAConfig(
            d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
            qkv_bias=True, rope_theta=1_000_000.0,
        ),
        d_ff=11008,
        max_seq=32768,
    )


def _qwen25_3b_reduced() -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        attn=GQAConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
        d_ff=160,
        max_seq=64,
        dtype=torch.float32,
        attn_chunk=32,
        loss_chunk=64,
    )


def _deepseek_67b() -> LMConfig:
    return LMConfig(
        name="deepseek-67b",
        n_layers=95,
        d_model=8192,
        vocab=102400,
        attn=GQAConfig(d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128),
        d_ff=22016,
        max_seq=32768,
    )


def _deepseek_67b_reduced() -> LMConfig:
    return LMConfig(
        name="deepseek-67b-smoke",
        n_layers=3,
        d_model=64,
        vocab=512,
        attn=GQAConfig(d_model=64, n_heads=8, n_kv_heads=2, head_dim=8),
        d_ff=192,
        max_seq=64,
        dtype=torch.float32,
        attn_chunk=32,
        loss_chunk=64,
    )


def _deepseek_v3() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b",
        n_layers=61,
        d_model=7168,
        vocab=129280,
        attn=MLAConfig(
            d_model=7168, n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        ),
        d_ff=18432,  # the 3 leading dense layers
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1),
        n_dense_layers=3,
        max_seq=32768,
        mtp=True,
    )


def _deepseek_v3_reduced() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke",
        n_layers=3,
        d_model=64,
        vocab=512,
        attn=MLAConfig(
            d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        ),
        d_ff=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1),
        n_dense_layers=1,
        max_seq=64,
        dtype=torch.float32,
        mtp=True,
        attn_chunk=32,
        loss_chunk=64,
    )


def _moonshot_16b() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48,
        d_model=2048,
        vocab=163840,
        attn=GQAConfig(d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128),
        d_ff=11264,  # dense first layer (moonlight-style)
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2),
        n_dense_layers=1,
        max_seq=32768,
    )


def _moonshot_16b_reduced() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke",
        n_layers=3,
        d_model=64,
        vocab=512,
        attn=GQAConfig(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16),
        d_ff=128,
        moe=MoEConfig(n_experts=8, top_k=3, d_ff=32, n_shared=2),
        n_dense_layers=1,
        max_seq=64,
        dtype=torch.float32,
        attn_chunk=32,
        loss_chunk=64,
    )


LM_ARCHS = [
    LMArch("qwen3-4b", _qwen3_4b, _qwen3_4b_reduced),
    LMArch("qwen2.5-3b", _qwen25_3b, _qwen25_3b_reduced),
    LMArch("deepseek-67b", _deepseek_67b, _deepseek_67b_reduced, fsdp=True),
    LMArch(
        "deepseek-v3-671b", _deepseek_v3, _deepseek_v3_reduced,
        moments="int8", fsdp=True,
    ),
    LMArch("moonshot-v1-16b-a3b", _moonshot_16b, _moonshot_16b_reduced, fsdp=True),
]
