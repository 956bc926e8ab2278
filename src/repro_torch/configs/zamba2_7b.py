"""zamba2-7b [hybrid]: 81 Mamba2 layers d_model=3584, ssm_state=64, with a
SHARED attention+MLP block (32H kv=32, d_ff=14336) applied every 6th layer
— structural simplification of Zamba2's dual alternating shared blocks
(recorded in DESIGN.md §9).  vocab=32000.  [arXiv:2411.15242; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    hybrid_attn_every=6,
    rope_theta=1e4,
    remat_policy="dots",
)
