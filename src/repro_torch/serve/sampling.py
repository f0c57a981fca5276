"""Token sampling: greedy / temperature (twin of ``repro.serve.sampling``)."""
from __future__ import annotations

import torch


def sample(generator: torch.Generator, logits: torch.Tensor,
           temperature: torch.Tensor) -> torch.Tensor:
    """logits (B, V); temperature (B,) with 0 == greedy. Returns (B,) ids.

    Greedy is the first argmax. A row with temperature t > 0 draws from
    softmax(logits / t) with ``generator``, which must live on the logits'
    device. The draws are reproducible for a given generator state but are
    not JAX's: ``jax.random.categorical``'s stream is not reproduced.
    """
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperature.to(logits.device, torch.float32),
                    min=1e-6)[:, None]
    probs = torch.softmax(logits.to(torch.float32) / t, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature.to(logits.device) > 0, sampled,
                       greedy).to(torch.int32)
