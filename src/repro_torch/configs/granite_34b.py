"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — code model. [arXiv:2405.04324; hf]

granite-34b-code is GPT-BigCode-style: MQA + plain (non-gated) 4x MLP —
with SwiGLU the param count would be 47B, not the published 34B.  We keep
RoPE per the assignment's "llama-arch" label (deviation noted in
DESIGN.md §9)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab_size=49152,
    mlp_gated=False,
    rope_theta=1e4,
    remat_policy="dots",
)
