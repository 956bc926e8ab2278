"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400 — MLA kv_lora=512 + 64-dim decoupled rope key; MoE 64 routed
top-6 + 2 shared experts; first layer dense (d_ff=10944).
[arXiv:2405.04434; hf]  (The assignment note "160 routed" contradicts its
own primary spec "MoE 64e top-6"; we implement the primary spec, which
matches the released DeepSeek-V2-Lite.)"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    first_k_dense=1, dense_layer_ff=10944,
    rope_theta=1e4,
    remat_policy="dots",
)
