"""mamba2-780m [ssm]: 48L d_model=1536, attn-free, ssm_state=128 — SSD
(state-space duality) blocks.  vocab=50280.  [arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, d_head=64, tie_embeddings=True,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    remat_policy="dots",
)
