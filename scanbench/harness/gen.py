"""Seeding: every input of a run comes from ``--seed`` through
generators derived here, one per purpose, so that adding a purpose does
not move the inputs of another."""

from __future__ import annotations

import numpy as np
import torch


def derive(seed: int, *purpose: int) -> int:
    """A 63-bit seed for (seed, purpose...): any whole ``seed``, negative
    or past 64 bits included."""
    words = [int(seed) & (2**64 - 1), int(seed) < 0, *purpose]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def torch_generator(device, seed: int, *purpose: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for (seed, purpose)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive(seed, *purpose))
    return g


def numpy_generator(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *purpose))


def to_bytes(t: torch.Tensor) -> bytes:
    """A uint8 tensor's bytes on the host."""
    return t.to("cpu", torch.uint8).numpy().tobytes()
