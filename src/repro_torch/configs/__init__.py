"""Assigned architectures (exact public configs) + the paper's own workload
(copied as data from the JAX package's ``configs/``).

``get_config(name)`` returns the full-size ModelConfig; ``smoke_config(name)``
returns a reduced same-family config for CPU smoke tests (small depth/width,
few experts, tiny vocab — the full sizes are exercised only via the dry-run).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig

from repro_torch.configs.qwen3_32b import CONFIG as qwen3_32b
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.granite_8b import CONFIG as granite_8b
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from repro_torch.configs.phi3_5_moe_42b import CONFIG as phi3_5_moe_42b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.mamba2_780m import CONFIG as mamba2_780m
from repro_torch.configs.whisper_base import CONFIG as whisper_base
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl_7b
from repro_torch.configs.wfa_paper import CONFIG as wfa_paper  # alignment workload

CONFIGS: dict[str, ModelConfig] = {
    "qwen3-32b": qwen3_32b,
    "qwen3-0.6b": qwen3_0_6b,
    "granite-34b": granite_34b,
    "granite-8b": granite_8b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "zamba2-7b": zamba2_7b,
    "mamba2-780m": mamba2_780m,
    "whisper-base": whisper_base,
    "qwen2-vl-7b": qwen2_vl_7b,
}

ARCH_NAMES = list(CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return CONFIGS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: runnable forward/train step on 1 CPU."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_head=64,
        d_ff=512,
        vocab_size=512,
        microbatch_tokens=1 << 30,  # no microbatching in smoke tests
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=2, d_expert=128,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_k_dense=min(cfg.first_k_dense, 1),
                  dense_layer_ff=256 if cfg.first_k_dense else 0)
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                  v_head_dim=32)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, enc_frames=64)
    if cfg.family == "vlm":
        kw.update(n_patches=16, mrope_sections=(8, 12, 12))  # sums to d_head/2
    return dataclasses.replace(cfg, **kw)
