"""hubert-xlarge — encoder-only audio backbone (w2v2 arch)
[arXiv:2106.07447; unverified]. Conv frontend is a stub: inputs are
precomputed frame features (B, S, 512)."""
from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504, causal=False,
        audio_feat_dim=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="encoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=64, causal=False,
        audio_feat_dim=32, remat="none",
    )
