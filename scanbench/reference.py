"""The plain reference: Aho-Corasick (1975) over byte keywords, in NumPy
and plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it is given the same keywords and texts as the program and works out
the automaton itself. The trie is built level by level with ``np.unique``,
the failure links and the full transition table row by row in breadth-first
order (Aho and Corasick's algorithm 3, vectorised over one level at a
time), and a text is scanned as many overlapping streams at once: each
stream starts at the root ``max_len - 1`` bytes before its first counted
position, so that every occurrence is seen whole by exactly one stream.

Keyword ids are the order of first insertion of each distinct keyword, as
the C reference's ``rank`` (a repeated keyword keeps its first id). An
occurrence is (end position, keyword id); ``matches`` orders them by end
position, the longest first at one position, as ``acm_get_match`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Reference:
    """The automaton of ``keywords`` (bytes, non-empty), scanned on
    ``device`` with plain tensor operations."""

    def __init__(self, keywords: Sequence[bytes], device="cpu"):
        ids: dict = {}
        for kw in keywords:
            if not kw:
                raise ValueError("empty keyword")
            ids.setdefault(bytes(kw), len(ids))
        self.keywords = list(ids)
        self.device = torch.device(device)
        self.max_len = max(map(len, self.keywords))
        alphabet = sorted(set(b"".join(self.keywords)))
        self.n_classes = len(alphabet) + 1          # class 0: any other byte
        byte_class = np.zeros(256, np.int64)
        byte_class[alphabet] = np.arange(1, len(alphabet) + 1)
        self._byte_class = torch.from_numpy(byte_class).to(self.device)
        self._build(byte_class)

    def _build(self, byte_class: np.ndarray) -> None:
        n, A = len(self.keywords), self.n_classes
        lens = np.fromiter(map(len, self.keywords), np.int64, n)
        K = np.zeros((n, self.max_len), np.int64)
        for i, kw in enumerate(self.keywords):
            K[i, :len(kw)] = byte_class[np.frombuffer(kw, np.uint8)]
        # The trie, one level at a time: states numbered in breadth-first
        # order, each with its parent and the class on its edge.
        parent, label, level_start = [np.zeros(1, np.int64)], \
            [np.zeros(1, np.int64)], [0, 1]
        cur = np.zeros(n, np.int64)                 # each keyword's prefix
        end_state = np.zeros(n, np.int64)
        for d in range(self.max_len):
            act = np.nonzero(lens > d)[0]
            key = cur[act] * A + K[act, d]
            uniq, inv = np.unique(key, return_inverse=True)
            first = level_start[-1]
            parent.append(uniq // A)
            label.append(uniq % A)
            cur[act] = first + inv
            level_start.append(first + len(uniq))
            done = act[lens[act] == d + 1]
            end_state[done] = cur[done]
        parent = np.concatenate(parent)
        label = np.concatenate(label)
        S = level_start[-1]
        kw_of = np.full(S, -1, np.int64)
        kw_of[end_state] = np.arange(n)     # distinct keywords, distinct ends
        delta = np.zeros((S, A), np.int32)
        fail = np.zeros(S, np.int64)
        nout = np.zeros(S, np.int64)
        olink = np.full(S, -1, np.int64)  # nearest terminal proper suffix
        child = np.arange(1, S)
        for d in range(len(level_start) - 1):
            lo, hi = level_start[d], level_start[d + 1]
            states = np.arange(lo, hi)
            if d >= 2:
                fail[states] = delta[fail[parent[states]], label[states]]
            elif d == 1:
                fail[states] = 0
            if d >= 1:
                delta[states] = delta[fail[states]]
                f = fail[states]
                olink[states] = np.where(kw_of[f] >= 0, f, olink[f])
                nout[states] = (kw_of[states] >= 0) + nout[f]
            edges = child[(parent[child] >= lo) & (parent[child] < hi)]
            delta[parent[edges], label[edges]] = edges
        self.n_states = S
        dev = self.device
        self._delta = torch.from_numpy(delta.reshape(-1)).to(dev)
        self._nout = torch.from_numpy(nout).to(dev)
        self._kw_of = torch.from_numpy(kw_of).to(dev)
        self._olink = torch.from_numpy(olink).to(dev)

    # -- scanning --------------------------------------------------------

    def _streams(self, text: bytes, n_streams: int):
        """(symbols [B, O + Lb] as classes, O, Lb, T): stream b counts
        positions [b*Lb, (b+1)*Lb) and starts at the root O = max_len - 1
        bytes earlier; class 0 before the text and past its end."""
        T = len(text)
        B = max(1, min(n_streams, -(-T // 64)))
        Lb = -(-T // B)
        O = self.max_len - 1
        raw = torch.frombuffer(bytearray(text), dtype=torch.uint8) if T \
            else torch.zeros(0, dtype=torch.uint8)
        sym = torch.zeros(O + B * Lb, dtype=torch.int64, device=self.device)
        sym[O:O + T] = self._byte_class[raw.to(self.device).long()]
        idx = (torch.arange(B, device=self.device) * Lb)[:, None] \
            + torch.arange(O + Lb, device=self.device)[None, :]
        return sym[idx], O, Lb, T

    def _walk(self, text: bytes, n_streams: int, keep_states: bool):
        sym, O, Lb, T = self._streams(text, n_streams)
        B = sym.shape[0]
        A = self.n_classes
        state = torch.zeros(B, dtype=torch.int64, device=self.device)
        for t in range(O):
            state = self._delta[state * A + sym[:, t]].long()
        pos = torch.arange(B, device=self.device) * Lb
        if keep_states:
            states = torch.empty((B, Lb), dtype=torch.int64,
                                 device=self.device)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for t in range(Lb):
            state = self._delta[state * A + sym[:, O + t]].long()
            if keep_states:
                states[:, t] = state
            else:
                total += torch.where(pos + t < T, self._nout[state], 0).sum()
        if keep_states:
            return states.reshape(-1)[:T]
        return int(total)

    def count(self, text: bytes, n_streams: int = 65536) -> int:
        """The number of keyword occurrences in ``text``."""
        return self._walk(text, n_streams, keep_states=False)

    def matches(self, text: bytes, n_streams: int = 65536,
                ) -> "tuple[np.ndarray, np.ndarray]":
        """(ends int64, keyword ids int64) of every occurrence, by end
        position and the longest first at one position."""
        states = self._walk(text, n_streams, keep_states=True)
        pos = torch.nonzero(self._nout[states] > 0).squeeze(1)
        cur = states[pos]
        cur = torch.where(self._kw_of[cur] >= 0, cur, self._olink[cur])
        ends, ids, level = [], [], []
        lvl = 0
        while cur.numel():
            ends.append(pos)
            ids.append(self._kw_of[cur])
            level.append(torch.full_like(pos, lvl))
            nxt = self._olink[cur]
            keep = nxt >= 0
            pos, cur = pos[keep], nxt[keep]
            lvl += 1
        if not ends:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ends_t, ids_t, level_t = (torch.cat(x) for x in (ends, ids, level))
        order = torch.argsort(ends_t * (self.max_len + 1) + level_t,
                              stable=True)
        return ends_t[order].cpu().numpy(), ids_t[order].cpu().numpy()

    def count_by(self, text: bytes, weight: np.ndarray,
                 n_streams: int = 65536) -> int:
        """The occurrences of the keywords whose ``weight[id]`` is 1 (a 0/1
        mask over keyword ids): the count of a dictionary that holds only
        those keywords, since one keyword's occurrences do not depend on
        the others."""
        _, ids = self.matches(text, n_streams)
        return int(np.asarray(weight)[ids].sum())


def brute_force(keywords: Sequence[bytes], text: bytes,
                limit: Optional[int] = None):
    """Every (end, keyword id) by direct comparison at every position: the
    check of ``Reference`` on tiny inputs."""
    ids: dict = {}
    for kw in keywords:
        ids.setdefault(bytes(kw), len(ids))
    out = []
    for e in range(len(text)):
        here = [(len(kw), i) for kw, i in ids.items()
                if len(kw) <= e + 1 and text[e + 1 - len(kw):e + 1] == kw]
        out += [(e, i) for _, i in sorted(here, reverse=True)]
        if limit is not None and len(out) > limit:
            break
    return out
