"""The associative-scan formulation: composition of transition functions;
K12, its hand-written kernel (csrc/assoc_scan.cu), beside its plain
PyTorch version.

The port of ``ops/scan_assoc.py``. The recurrence s' = delta(s, c) is
associative under composition of the per-symbol transition functions
f_c = delta[:, c] (an [S] vector each; (f o g)[s] = f[g[s]]), so every
prefix can be evaluated in log T steps: the simultaneous-DFA construction.
It does T*S lookups (with the log-step plain version, T*S*log T) where the
blocked scan (K2) does T, so K2 stays the production path; this formulation
is exact for any automaton without a halo argument and is kept, with its
own entry point, as the JAX package keeps it. No scanner calls it.

* The plain version mirrors ``lax.associative_scan``: the [T, S] function
  vectors, composed by log-step doubling with ``torch.gather``.
* K12 keeps no [T, S] array: it composes each chunk of CHUNK ids into its
  function at every state (T*S lookups over B*S threads), composes tiles
  of ``tile_for(B)`` chunks into theirs, and re-runs each chunk from the
  start state that the tiles' and its tile's functions give, so that no
  chain is longer than a chunk, a tile or the tiles (the kernel's header
  says how).

``make_assoc_scan(V)`` returns ``scan(delta, ids) -> states[T]``: delta the
int32 [S, V] fail-collapsed table, ids int32 letter ids [T]; the kernel on
a CUDA tensor, the plain version on a CPU one.
"""

from __future__ import annotations

import torch

from . import build

# Symbols per chunk of K12: each (chunk, state) pair of its first phase is
# one thread's chain of CHUNK lookups, so that the B*S pairs fill the card
# (at 2^20 ids and 26 states, 8,192 chunks: 213,000 threads), and its last
# phase re-runs each chunk in one thread.
CHUNK = 128


def tile_for(n_chunks: int) -> int:
    """K12's chunks a tile: the least power of two from 32 (a warp) whose
    square covers n_chunks, at most 1,024 (a block), so that a tile's chain
    and the tiles' chain are both about sqrt(n_chunks) long."""
    tile = 32
    while tile * tile < n_chunks and tile < 1024:
        tile *= 2
    return tile


def _check(delta: torch.Tensor, ids: torch.Tensor, V: int) -> torch.device:
    if delta.dim() != 2 or delta.shape[1] != V or delta.dtype != torch.int32:
        raise ValueError(f"delta must be int32 [S, {V}] (got {delta.dtype} "
                         f"{tuple(delta.shape)})")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be 1-D int32 (got {ids.dtype} "
                         f"{tuple(ids.shape)})")
    if ids.device != delta.device:
        raise ValueError(f"inputs on {ids.device} and {delta.device}")
    if not (delta.is_contiguous() and ids.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    return delta.device


def assoc_scan_plain(delta: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 states [T] by log-step prefix composition over
    the [T, S] function vectors (``lax.associative_scan``'s result)."""
    fns = delta.t().long()[ids.long()]          # [T, S]: f_t = delta[:, c_t]
    d = 1
    while d < fns.shape[0]:
        # prefix t := prefix t-d, then prefix t (time order)
        fns = torch.cat([fns[:d], torch.gather(fns[d:], 1, fns[:-d])])
        d *= 2
    return fns[:, 0].to(torch.int32)            # from the root


def launch_fields(delta: torch.Tensor, ids: torch.Tensor,
                  out: torch.Tensor) -> dict:
    """K12's launch fields for the states ``out`` of ``ids`` (T > 0):
    chunks of CHUNK ids, tiles of ``tile_for`` chunks, and its scratch,
    the chunks' then the tiles' functions ``compose`` [B + n_tiles, S] and
    the chunks' start states ``starts`` [B]."""
    (S, V), T = delta.shape, ids.numel()
    n_chunks = -(-T // CHUNK)
    tile = tile_for(n_chunks)
    n_tiles = -(-n_chunks // tile)
    return dict(
        table=delta, ext=ids, out=out, L=CHUNK, B=n_chunks, V=V, doc_len=T,
        n_states=S, tile=tile,
        compose=torch.empty((n_chunks + n_tiles, S), dtype=torch.int32,
                            device=delta.device),
        starts=torch.empty(n_chunks, dtype=torch.int32, device=delta.device))


def assoc_scan(delta: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K12: int32 states [T] after every symbol from the root."""
    V = delta.shape[1] if delta.dim() == 2 else -1
    dev = _check(delta, ids, V)
    if dev.type == "cpu":
        return assoc_scan_plain(delta, ids)
    out = torch.empty(ids.numel(), dtype=torch.int32, device=dev)
    if ids.numel():
        build.launch("ac_assoc_scan", dev, **launch_fields(delta, ids, out))
    return out


def make_assoc_scan(V: int):
    """Returns scan(delta, ids) -> states[T] through associative
    composition (the JAX package's ``make_assoc_scan``)."""
    def scan(delta: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        _check(delta, ids, V)
        return assoc_scan(delta, ids)
    return scan
