"""aho_corasick_1975_tpu_torch — the PyTorch and CUDA port of
``aho_corasick_1975_tpu`` for NVIDIA Hopper GPUs.

The automaton is built on the host by the port's own copies of the JAX
package's jax-free modules (``core/``, ``models/machine.py``,
``models/bytes_machine.py``, ``models/results.py``, ``ops/decode.py``,
``utils/``, ``api.py``), with checkpoints the two packages share; counting,
match retrieval, streaming sessions, online refresh and batch scoring run
on the GPU through hand-written CUDA kernels (``csrc/``), each with a plain
PyTorch version that tensors on the CPU take instead. ``parallel/`` shards a
corpus over a mesh of devices (``ShardedScanner``).

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

from .api import (ACM_CMP_DEFAULT, ACM_INCREMENTAL_STRING_MATCHING,
                  MatchHolder, acm_create, acm_foreach_keyword, acm_get_match,
                  acm_initiate, acm_insert_end_of_keyword,
                  acm_insert_letter_of_keyword, acm_match, acm_matcher_init,
                  acm_matcher_release, acm_nb_keywords, acm_print,
                  acm_release)
from .core.builder import Builder, DenseTables
from .models.bytes_machine import ByteMachine, UnicodeMachine
from .models.machine import Cursor, Machine, Match
from .models.results import MatchSet
from .models.scanner import DenseScanner, StreamSession
from .utils.checkpoint import (load_machine, load_tables, save_machine,
                               save_tables)
from .utils.config import MachineConfig, MeshConfig, ScanConfig

__version__ = "0.1.0"

__all__ = [
    "Machine", "Cursor", "Match", "MatchSet", "DenseScanner", "Builder",
    "DenseTables", "ByteMachine", "UnicodeMachine", "StreamSession",
    "save_machine", "load_machine", "save_tables", "load_tables",
    "MachineConfig", "ScanConfig", "MeshConfig",
    "acm_create", "acm_release", "acm_initiate",
    "acm_insert_letter_of_keyword", "acm_insert_end_of_keyword", "acm_match",
    "acm_matcher_init", "acm_get_match", "acm_matcher_release",
    "acm_nb_keywords", "acm_foreach_keyword", "acm_print", "MatchHolder",
    "ACM_CMP_DEFAULT", "ACM_INCREMENTAL_STRING_MATCHING", "__version__",
]
