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
* K12 composes chunk by chunk and keeps no [T, S] array (the kernel's
  header says how).

``make_assoc_scan(V)`` returns ``scan(delta, ids) -> states[T]``: delta the
int32 [S, V] fail-collapsed table, ids int32 letter ids [T]; the kernel on
a CUDA tensor, the plain version on a CPU one.
"""

from __future__ import annotations

import torch

from . import build

# Symbols per chunk of K12: its chain (phase 2) walks T / CHUNK chunks one
# after another, its chunks (phase 3) walk CHUNK symbols each.
CHUNK = 2048


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


def assoc_scan(delta: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K12: int32 states [T] after every symbol from the root."""
    V = delta.shape[1] if delta.dim() == 2 else -1
    dev = _check(delta, ids, V)
    if dev.type == "cpu":
        return assoc_scan_plain(delta, ids)
    T, S = ids.numel(), delta.shape[0]
    out = torch.empty(T, dtype=torch.int32, device=dev)
    if not T:
        return out
    n_chunks = -(-T // CHUNK)
    compose = torch.empty((n_chunks, S), dtype=torch.int32, device=dev)
    starts = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    build.launch("ac_assoc_scan", dev, table=delta, ext=ids, out=out,
                 L=CHUNK, B=n_chunks, V=V, doc_len=T, n_states=S,
                 compose=compose, starts=starts)
    return out


def make_assoc_scan(V: int):
    """Returns scan(delta, ids) -> states[T] through associative
    composition (the JAX package's ``make_assoc_scan``)."""
    def scan(delta: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        _check(delta, ids, V)
        return assoc_scan(delta, ids)
    return scan
