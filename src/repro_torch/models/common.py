"""Model configuration shared by every assigned architecture (the JAX
package's ``models/common.py``; ``pdtype()`` / ``cdtype()`` give torch
dtypes)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qk_norm: bool = False
    mlp_gated: bool = True           # SwiGLU vs plain GELU MLP
    rope_theta: float = 1e4
    attn_kind: str = "gqa"           # gqa | mla
    tie_embeddings: bool = False
    rms_eps: float = 1e-6

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = False         # absorbed decode matmuls (perf iteration)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    first_k_dense: int = 0           # leading dense layers (deepseek: 1)
    dense_layer_ff: int = 0          # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # expert-parallel dispatch (shard_map + all_to_all) instead of the pjit
    # global-scatter dispatch.  The global scatter forces SPMD to all-reduce
    # the full [E*C, D] fp32 expert buffer every MoE layer (§Perf cell 3);
    # EP moves only the routed tokens (all-to-all), the standard MoE pattern.
    moe_ep: bool = False

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_groups: int = 1
    # split x/B/C projections (TP-clean: slicing the fused xBC output at
    # non-shard-aligned channel boundaries forces per-layer resharding —
    # §Perf cell 2).  False = legacy fused in_proj (the recorded baseline).
    ssm_split_proj: bool = True

    # hybrid (zamba2): a shared attention+MLP block applied every k-th layer
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper): frontend is a stub; encoder sees frame embeds
    enc_layers: int = 0
    enc_frames: int = 1500

    # VLM (qwen2-vl): M-RoPE + stubbed patch embeddings
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_patches: int = 256

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"

    # training
    remat_policy: str = "nothing"    # nothing | dots | everything
    microbatch_tokens: int = 8192    # target per-device tokens per microbatch
    max_microbatches: int = 16

    # lowering mode (dry-run roofline pass flips these; see DESIGN.md §7):
    # scan bodies are counted ONCE by XLA cost_analysis, so the roofline pass
    # unrolls the layer scan and disables attention q-chunking to make the
    # compiled FLOP/collective counts exact; the memory pass keeps production
    # scan + microbatching so memory_analysis proves the step fits.
    unroll_layers: bool = False
    q_chunk: int = 4096

    # perf experiment (§Perf): shard the sequence axis of between-layer
    # activations over the mesh 'model' axis (Megatron-style sequence
    # parallelism) instead of replicating them across it.
    seq_shard: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def head_dim(self) -> int:
        return self.d_head

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for archs with sub-quadratic decode state."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def scan_unroll(self):
        """unroll= for layer-stack scans (True = exact HLO flop counts)."""
        return True if self.unroll_layers else 1

    # ---------------- parameter count (for 6ND roofline bookkeeping) --------
    def param_count(self) -> int:
        tree = None
        # analytic count, no allocation
        D, H, KV, dh, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.d_ff, self.vocab_padded)
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D

        def attn_params():
            if self.attn_kind == "mla":
                r, rd, nd, vd = (self.kv_lora_rank, self.qk_rope_dim,
                                 self.qk_nope_dim, self.v_head_dim)
                return (D * H * (nd + rd) + D * (r + rd)
                        + r * H * (nd + vd) + H * vd * D)
            return D * H * dh + 2 * D * KV * dh + H * dh * D

        def mlp_params(ff):
            return (3 if self.mlp_gated else 2) * D * ff

        def moe_params():
            n = D * self.n_experts
            n += self.n_experts * mlp_params(self.d_expert) // 1
            n += self.n_shared_experts * mlp_params(self.d_expert)
            return n

        def ssm_params():
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            xbc = di + 2 * self.ssm_groups * N
            return (D * di + D * xbc + D * Hs + self.ssm_conv * xbc
                    + 3 * Hs + di + di * D)

        for li in range(self.n_layers):
            if self.family == "ssm":
                n += ssm_params() + D
            elif self.family == "hybrid":
                n += ssm_params() + D
            elif self.family in ("dense", "vlm", "encdec"):
                n += attn_params() + mlp_params(F) + 2 * D
            elif self.family == "moe":
                if li < self.first_k_dense:
                    n += attn_params() + mlp_params(self.dense_layer_ff) + 2 * D
                else:
                    n += attn_params() + moe_params() + 2 * D
        if self.family == "hybrid" and self.hybrid_attn_every:
            n += attn_params() + mlp_params(F) + 2 * D  # one shared block
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                n += attn_params() + mlp_params(F) + 2 * D
            n += self.n_layers * (attn_params() + D)  # cross-attn
        del tree
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        D = self.d_model
        per_expert = (3 if self.mlp_gated else 2) * D * self.d_expert
        inactive = (self.n_experts - self.top_k) * per_expert
        return full - (self.n_layers - self.first_k_dense) * inactive


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D with N = active params, D = tokens processed."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def num_microbatches(cfg: ModelConfig, shape: ShapeSpec, n_data_shards: int) -> int:
    if shape.kind != "train":
        return 1
    per_dev_batch = max(1, shape.global_batch // max(1, n_data_shards))
    per_dev_tokens = per_dev_batch * shape.seq_len
    n = max(1, per_dev_tokens // cfg.microbatch_tokens)
    n = min(n, cfg.max_microbatches, per_dev_batch)
    while shape.global_batch % n or (shape.global_batch // n) % 1:
        n -= 1
    return max(1, n)
