"""qwen2.5-3b — dense GQA with QKV bias, tied embeddings
[hf:Qwen/Qwen2.5-0.5B family; hf]."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True,
        tie_embeddings=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=512, qkv_bias=True,
        tie_embeddings=True, remat="none",
    )
