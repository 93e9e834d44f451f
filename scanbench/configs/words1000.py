"""words1000: upstream Test 2's shape with the text's 1,000 most frequent
words as ` word ` byte keywords, over English-like text drawn from the
seed (``words1000.json`` says what is assumed and why)."""

from __future__ import annotations

import numpy as np
import torch

from scanbench.harness.gen import numpy_generator, to_bytes, torch_generator


def zipf_mass(cfg: dict) -> np.ndarray:
    """Each rank's share of the text's tokens (Zipf over the vocabulary)."""
    r = np.arange(1, cfg["vocabulary_words"] + 1, dtype=np.float64)
    pdf = r ** -cfg["zipf_s"]
    return pdf / pdf.sum()


def word_lengths(cfg: dict) -> np.ndarray:
    """The length of the word at each rank, the same for every seed: the
    by-token length distribution read at the middle of each rank's share
    of the tokens, the most frequent ranks first, so that frequent words
    are the short ones and the text's token lengths follow the
    distribution."""
    share = cfg["word_length_percent"]
    lens = np.array(sorted(int(k) for k in share), np.int64)
    cum = np.cumsum([share[str(n)] for n in lens])
    mass = zipf_mass(cfg)
    mid = (np.cumsum(mass) - mass / 2) * cum[-1]
    return lens[np.minimum(np.searchsorted(cum, mid, side="right"),
                           len(lens) - 1)]


class Deployment:
    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        lengths = word_lengths(cfg)
        letters = np.frombuffer(cfg["alphabet"].encode(), np.uint8)
        p = np.array([cfg["letter_percent"][chr(c)] for c in letters])
        p /= p.sum()
        rng = numpy_generator(seed, 1)
        words: list = [b""] * len(lengths)
        todo = np.arange(len(lengths))
        seen: set = set()
        while len(todo):
            # draw the words still missing; a word drawn before is drawn
            # again
            n = lengths[todo]
            flat = letters[rng.choice(len(letters), int(n.sum()), p=p)]
            ends = np.cumsum(n)
            again = []
            for i, e, k in zip(todo.tolist(), ends.tolist(), n.tolist()):
                w = flat[e - k:e].tobytes()
                if w in seen:
                    again.append(i)
                else:
                    seen.add(w)
                    words[i] = w
            todo = np.asarray(again, np.int64)
        self.words = words
        self.increments = [[b" " + w + b" " for w in words[:cfg["keywords"]]]]
        width = int(lengths.max()) + 1
        table = np.full((len(words), width), ord(" "), np.uint8)
        for i, w in enumerate(words):
            table[i, :len(w)] = np.frombuffer(w, np.uint8)
        self._table = torch.from_numpy(table).to(self.device)
        self._width = width
        self._tok_len = torch.from_numpy(lengths + 1).to(self.device)
        mass = zipf_mass(cfg)
        self._cdf = torch.from_numpy(np.cumsum(mass)).to(self.device)
        self._mean_tok = float((mass * (lengths + 1)).sum())

    def texts(self, n: int, nbytes: int, stream: int = 0) -> list:
        """``n`` documents of ``nbytes`` bytes: words drawn by Zipf rank,
        one space after each, the last word cut at ``nbytes``."""
        out = []
        for i in range(n):
            g = torch_generator(self.device, self.seed, 2, stream, i)
            n_tok = int(nbytes / self._mean_tok * 1.05) + 64
            while True:
                u = torch.rand(n_tok, generator=g, device=self.device,
                               dtype=torch.float64)
                rank = torch.searchsorted(self._cdf, u).clamp_(
                    max=len(self.words) - 1)
                lens = self._tok_len[rank]
                if int(lens.sum()) >= nbytes:
                    break
                n_tok *= 2
            start = torch.cumsum(lens, 0) - lens
            keep = int(torch.searchsorted(start, nbytes))
            rank, lens, start = rank[:keep], lens[:keep], start[:keep]
            tok = torch.repeat_interleave(
                torch.arange(keep, device=self.device), lens)[:nbytes]
            off = torch.arange(nbytes, device=self.device) - start[tok]
            out.append(to_bytes(
                self._table.view(-1)[rank[tok] * self._width + off]))
        return out


def make(cfg: dict, seed: int, device) -> Deployment:
    return Deployment(cfg, seed, device)
