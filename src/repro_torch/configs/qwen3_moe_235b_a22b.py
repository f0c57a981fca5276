"""qwen3-moe-235b-a22b — 128 experts, top-8, per-expert ff 1536
[hf:Qwen/Qwen3-30B-A3B family; hf].

At full width its ~235 B parameters take ~470 GB in bf16, past one
card's 80 GB: the port runs it at smoke size, and at full width on the
``meta`` device only (parameter counts), until the sharded slice
(ROADMAP Queue 1, C2)."""
import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab_size=151936, head_dim=128,
        n_experts=128, experts_per_token=8,
        rope_theta=1_000_000.0,
        param_dtype=torch.bfloat16,  # the reference's: bf16 params
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=16,
        n_experts=8, experts_per_token=2, moe_group_size=64,
        remat="none",
    )
