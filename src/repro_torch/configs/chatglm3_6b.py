"""chatglm3-6b — GQA kv=2, 2d (half-dim) RoPE [arXiv:2406.12793; hf]."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=65024, rope_frac=0.5,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=512, rope_frac=0.5, remat="none",
    )
