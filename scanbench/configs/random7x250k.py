"""random7x250k: upstream Test 3 (``random7x250k.json``): increments of
random fixed-length keywords over an alphabet, and texts of random letters
from the same alphabet, all drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch

from scanbench.harness.gen import to_bytes, torch_generator


class Deployment:
    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._letters = torch.from_numpy(np.frombuffer(
            cfg["alphabet"].encode(), np.uint8).copy()).to(self.device)
        g = torch_generator(self.device, seed, 1)
        n, m, k = (cfg["increments"], cfg["keywords_per_increment"],
                   cfg["keyword_letters"])
        draw = torch.randint(0, len(self._letters), (n, m, k), generator=g,
                             device=self.device)
        flat = to_bytes(self._letters[draw])
        self.increments = [[flat[(i * m + j) * k:(i * m + j + 1) * k]
                            for j in range(m)] for i in range(n)]

    def texts(self, n: int, nbytes: int, stream: int = 0) -> list:
        """``n`` texts of ``nbytes`` letters drawn uniformly."""
        out = []
        for i in range(n):
            g = torch_generator(self.device, self.seed, 2, stream, i)
            draw = torch.randint(0, len(self._letters), (nbytes,),
                                 generator=g, device=self.device)
            out.append(to_bytes(self._letters[draw]))
        return out


def make(cfg: dict, seed: int, device) -> Deployment:
    return Deployment(cfg, seed, device)
