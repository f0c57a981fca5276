"""mamba2-2.7b — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_conv=4, ssm_expand=2,
        ssm_head_dim=64, ssm_chunk=256, ssm_groups=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        ssm_head_dim=16, ssm_chunk=16, ssm_groups=1,
        remat="none",
    )
