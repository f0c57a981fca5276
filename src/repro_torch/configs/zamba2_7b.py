"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified]."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        ssm_state=64, ssm_conv=4, ssm_expand=2,
        ssm_head_dim=64, ssm_chunk=256, ssm_groups=1,
        hybrid_period=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        ssm_head_dim=16, ssm_chunk=16, ssm_groups=1,
        hybrid_period=3, remat="none",
    )
