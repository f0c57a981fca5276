"""qwen3-moe-30b-a3b — 128 experts, top-8, per-expert ff 768
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab_size=151936, head_dim=128,
        n_experts=128, experts_per_token=8,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=16,
        n_experts=8, experts_per_token=2, moe_group_size=64,
        remat="none",
    )
