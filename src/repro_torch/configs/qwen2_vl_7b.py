"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE over (temporal, height, width) sections (16,24,24);
the vision frontend is a STUB: input_specs() supplies merged patch
embeddings + 3-D position ids.  [arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab_size=152064,
    mrope=True, mrope_sections=(16, 24, 24), n_patches=256,
    rope_theta=1e6,
    remat_policy="dots",
)
