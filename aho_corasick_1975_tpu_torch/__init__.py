"""aho_corasick_1975_tpu_torch — the PyTorch and CUDA port of
``aho_corasick_1975_tpu`` for NVIDIA Hopper GPUs.

The automaton is built on the host by the JAX package's own jax-free
modules (loaded through ``_host``); counting and match retrieval run on
the GPU through hand-written CUDA kernels (``csrc/``), each with a plain
PyTorch version that tensors on the CPU take instead.

Quick start::

    import aho_corasick_1975_tpu_torch as act
    m = act.Machine()
    for kw in [b"he", b"she", b"his", b"hers"]:
        m.insert_keyword(kw)
    scanner = m.scanner()                  # device="cuda" by default
    scanner.count(b"To ushers: he found his pencil ...")
    scanner.find_matches(b"ushers")        # MatchSet
"""

from ._host import Machine, MatchSet
from .models.scanner import DenseScanner

__all__ = ["Machine", "MatchSet", "DenseScanner"]
