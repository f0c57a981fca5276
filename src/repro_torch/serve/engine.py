"""Serving engine: batched prefill + decode (twin of ``repro.serve.engine``).

``ServeEngine`` serves requests in waves of ``batch_size``: each wave's
prompts are left-padded with token 0 to the longest, prefilled into a
fresh cache (a KV cache, an SSM's state and conv tail, or a hybrid's
both; logits of the last position only), then decoded one token per step for every slot
until each request has ``max_new_tokens`` or has emitted ``eos_id``. The
model updates the cache in place, which stands in for the reference's
buffer donation. Pads are seen like any token (the reference has no pad
mask either).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.serve.sampling import sample


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 -> greedy
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Waves of ``batch_size`` requests through ``model`` (a ``DecoderLM``,
    ``MambaLM`` or ``HybridLM``: any model with ``init_cache``, ``forward``
    and ``device``).

    Sampling draws from ``generator`` (on the model's device); by default
    one seeded with ``rng_seed``.
    """

    def __init__(self, model, batch_size: int, max_len: int,
                 eos_id: int | None = None, rng_seed: int = 0,
                 generator: torch.Generator | None = None):
        self.model = model
        self.batch = batch_size
        self.max_len = max_len
        self.eos = eos_id
        self.generator = generator or torch.Generator(
            model.device).manual_seed(rng_seed)

    # --------------- prefill and decode ---------------

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor):
        cache = self.model.init_cache(tokens.shape[0], self.max_len)
        logits, cache, _ = self.model.forward({"tokens": tokens}, cache,
                                              last_only=True)
        return logits[:, 0], cache

    @torch.no_grad()
    def _decode(self, cache, tokens: torch.Tensor):
        logits, cache, _ = self.model.forward({"tokens": tokens}, cache)
        return logits[:, 0], cache

    # --------------- request loop ---------------

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests with a shared fixed batch.

        Requests are grouped into waves of ``batch_size`` with equal-length
        left-padded prompts (simplified admission policy).
        """
        out = []
        for i in range(0, len(requests), self.batch):
            out.extend(self._wave(requests[i:i + self.batch]))
        return out

    def _wave(self, reqs: List[Request]) -> List[Request]:
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch, plen), np.int64)
        for j, r in enumerate(reqs):
            toks[j, plen - len(r.prompt):] = r.prompt  # left pad with 0
        dev = self.model.device
        logits, cache = self._prefill(torch.from_numpy(toks).to(dev))

        max_new = max(r.max_new_tokens for r in reqs)
        cur = self._pick(logits, reqs)
        for j, r in enumerate(reqs):
            r.generated.append(int(cur[j]))
        for _ in range(max_new - 1):
            step = torch.from_numpy(cur.astype(np.int64))[:, None].to(dev)
            logits, cache = self._decode(cache, step)
            cur = self._pick(logits, reqs)
            alive = 0
            for j, r in enumerate(reqs):
                if r.done or len(r.generated) >= r.max_new_tokens:
                    r.done = True
                    continue
                t = int(cur[j])
                r.generated.append(t)
                if self.eos is not None and t == self.eos:
                    r.done = True
                else:
                    alive += 1
            if alive == 0:
                break
        for r in reqs:
            r.done = True
        return reqs

    def _pick(self, logits: torch.Tensor, reqs) -> np.ndarray:
        temps = np.zeros((self.batch,), np.float32)
        for j, r in enumerate(reqs):
            temps[j] = r.temperature
        ids = sample(self.generator, logits, torch.from_numpy(temps))
        return ids.cpu().numpy()
