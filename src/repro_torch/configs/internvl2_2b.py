"""internvl2-2b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

VLM: the transformer BACKBONE only; the vision frontend is a stub
(callers pass precomputed patch embeddings, projected in-model).
"""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92553, head_dim=128,
        vlm_image_tokens=256, vlm_vision_dim=1024,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        vlm_image_tokens=8, vlm_vision_dim=32,
        remat="none",
    )
