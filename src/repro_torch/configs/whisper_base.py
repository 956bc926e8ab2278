"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec with sinusoidal positions (rope disabled); the
conv/mel frontend is a STUB per the assignment: input_specs() supplies
precomputed frame embeddings [B, 1500, 512].  [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, enc_frames=1500,
    d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, vocab_size=51865,
    mlp_gated=False, rope_theta=0.0, tie_embeddings=True,
    remat_policy="dots",
)
