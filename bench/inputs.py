"""Grids from the seed, and the traffic a mix file describes.

Every input is made from ``--seed`` and a stream tag, so the same seed
gives the same inputs and no two inputs of a run share a stream. A grid
is the configuration's ringed domain: the fixed Dirichlet ring, and an
interior of values in [0, 1) in the configuration's dtype, drawn on the
device by one ``torch.rand`` call.

A traffic file sets the mix: its ``entry`` (``run`` or ``serve``), the
callers of a closed loop, and for served solves the budget, block depth
and how the tolerances spread over a solo residual curve. :class:`Mix` turns it and
the seed into each request's parameters.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from bench.reference import jacobi as ref

#: Stream tags: which input a seed is drawn for.
TIMED, WARM, CURVE, SAMPLE, DECK = range(5)


def stream_seed(seed: int, tag: int, idx: int = 0) -> int:
    """A 63-bit seed for input ``idx`` of stream ``tag`` of run ``seed``."""
    words = [int(seed) & (2 ** 64 - 1), tag, idx]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def radius(cfg: dict) -> int:
    return ref.radius(cfg["stencil"]["offsets"])


def make_grid(cfg: dict, seed: int, tag: int, idx: int,
              device: torch.device) -> torch.Tensor:
    """The ringed grid of input ``idx`` of stream ``tag``."""
    r = radius(cfg)
    ny, nx = cfg["ny"], cfg["nx"]
    dtype = getattr(torch, cfg["dtype"])
    ring = cfg["ring"]
    u = torch.empty((ny + 2 * r, nx + 2 * r), dtype=dtype, device=device)
    u[:, :r] = ring["left"]
    u[:, -r:] = ring["right"]
    u[:r, :] = ring["top"]
    u[-r:, :] = ring["bottom"]
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, tag, idx))
    u[r:-r, r:-r] = torch.rand((ny, nx), generator=g, device=device,
                               dtype=dtype)
    return u


def spread_tols(curve: list[float], n: int) -> list[tuple[int, float]]:
    """``n`` (blocks, tol) pairs over a solo residual curve (the residual
    after each block): blocks spread geometrically from the 12th (or the
    first new low of a curve that stops falling before it) to the first
    whose residual is a tenth of its, each a new low of the curve, and
    each tol halfway between that low and the lowest residual before it,
    so that the solve the curve came from converges at exactly that many
    blocks."""
    lows = [b for b in range(1, len(curve)) if curve[b] < min(curve[:b])]
    if not lows:
        raise ValueError("the residual curve never falls")
    b0 = min((b for b in lows if b >= 11), default=lows[0])
    end = next((b for b in lows if curve[b] <= curve[b0] / 10), lows[-1])
    picks = sorted({min(lows, key=lambda b: abs(
        b - b0 * (end / b0) ** (i / max(n - 1, 1)))) for i in range(n)})
    if len(picks) != n:
        raise ValueError(f"no {n} distinct eviction blocks: {picks}")
    return [(b + 1, (min(curve[:b]) + curve[b]) / 2) for b in picks]


class Mix:
    """Each request's parameters for a served mix.

    The tolerances form a deck: ``tols`` values spread over the solo
    residual ``curve`` and ``untimed`` requests with ``tol=None``. Every
    run of ``len(deck)`` consecutive requests deals the whole deck, in an
    order drawn from the seed, so every seed serves the same work in
    another order.
    """

    def __init__(self, traffic: dict, seed: int, curve: list[float]):
        self.seed = seed
        spread = traffic["tolerances"]
        self.deck = ([tol for _, tol in spread_tols(curve, spread["tols"])]
                     + [None] * spread["untimed"])

    def tol(self, k: int):
        """The tolerance of the ``k``-th request submitted."""
        n = len(self.deck)
        order = list(range(n))
        random.Random(stream_seed(self.seed, DECK, k // n)).shuffle(order)
        return self.deck[order[k % n]]


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the
    seed, holding at most ``k`` at a time."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(stream_seed(seed, SAMPLE))
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item
