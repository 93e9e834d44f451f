"""aho_corasick_1975_tpu_torch — the PyTorch and CUDA port of
``aho_corasick_1975_tpu`` for NVIDIA Hopper GPUs.

The automaton is built on the host by the JAX package's own jax-free
modules (loaded through ``_host``, with checkpointing); counting, match
retrieval, streaming sessions, online refresh and batch scoring run on
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
    scanner.count_many([b"she", b"his hers"])   # per-document counts
    s = scanner.session()                  # chunked, exact across edges
    s.feed_count(b"ush"); s.feed_count(b"ers")
    m.insert_keyword(b"hish"); scanner.refresh()  # online, in place
"""

from ._host import (ByteMachine, Machine, MatchSet, UnicodeMachine,
                    load_machine, save_machine)
from .models.scanner import DenseScanner, StreamSession

__all__ = ["Machine", "ByteMachine", "UnicodeMachine", "MatchSet",
           "DenseScanner", "StreamSession", "save_machine", "load_machine"]
