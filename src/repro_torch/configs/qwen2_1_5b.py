"""Qwen2-1.5B — dense GQA with QKV bias [arXiv:2407.10671]."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True, pattern_nb=128)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
    qkv_bias=True, tie_embeddings=True, pattern_nb=8, dtype="float32")
