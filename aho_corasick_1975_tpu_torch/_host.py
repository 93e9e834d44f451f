"""The JAX package's host layer, loaded without JAX.

The host side of ``aho_corasick_1975_tpu`` (automaton builders, vocabulary,
match decoding, ``MatchSet``) is numpy and C++ and is shared with the port
rather than copied. It cannot be imported the usual way on a GPU machine:
there is no ``jax`` there, and ``aho_corasick_1975_tpu/__init__.py`` imports
``models.scanner``, which imports ``jax.numpy`` at the top.

So this module registers an alias package, ``aho_corasick_1975_tpu_torch._ref``:
a bare module whose ``__path__`` is the JAX package's directory. Submodules
imported through it are the JAX package's own source files, but the JAX
package's ``__init__.py`` never runs. The alias only ever loads the jax-free
modules below; it never touches ``models.scanner``, ``models.snapshot`` or
anything under ``ops/`` other than ``decode`` and ``blocking``.

The machine classes here are the JAX package's with ``scanner()`` building
the port's scanner, and ``load_machine`` returns them.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

_REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "aho_corasick_1975_tpu")
_ALIAS = __name__.rpartition(".")[0] + "._ref"


def _alias_package() -> types.ModuleType:
    pkg = sys.modules.get(_ALIAS)
    if pkg is None:
        if not os.path.isfile(os.path.join(_REF_DIR, "core", "builder.py")):
            raise ImportError(
                f"the JAX package's host layer is missing at {_REF_DIR}")
        pkg = types.ModuleType(_ALIAS, "alias of aho_corasick_1975_tpu's "
                               "jax-free host modules")
        pkg.__path__ = [_REF_DIR]
        pkg.__package__ = _ALIAS
        sys.modules[_ALIAS] = pkg
    return pkg


def _ref(name: str) -> types.ModuleType:
    _alias_package()
    return importlib.import_module(f"{_ALIAS}.{name}")


_builder = _ref("core.builder")
_native = _ref("core.native")
_machine = _ref("models.machine")
_bytes_machine = _ref("models.bytes_machine")
_checkpoint = _ref("utils.checkpoint")
_decode = _ref("ops.decode")

Builder = _builder.Builder
DenseTables = _builder.DenseTables
round_cap = _builder.round_cap
NativeBuilder = _native.NativeBuilder
compose_pack = _native.compose_pack
Vocab = _ref("utils.vocab").Vocab
expand_hits_arrays = _decode.expand_hits_arrays
decode_matches_arrays = _decode.decode_matches_arrays
MatchSet = _ref("models.results").MatchSet


class _PortScanner:
    def scanner(self, **kwargs):
        """Build a device scanner over the current snapshot
        (``aho_corasick_1975_tpu_torch.models.scanner``)."""
        from .models.scanner import DenseScanner
        return DenseScanner(self, **kwargs)


class Machine(_PortScanner, _machine.Machine):
    """The JAX package's ``Machine``; ``scanner()`` builds the port's
    scanner."""


class ByteMachine(_PortScanner, _bytes_machine.ByteMachine):
    """The JAX package's ``ByteMachine`` (fixed 256-byte alphabet);
    ``scanner()`` builds the port's scanner."""


class UnicodeMachine(_PortScanner, _bytes_machine.UnicodeMachine):
    """The JAX package's ``UnicodeMachine`` (codepoints, optional case
    folding); ``scanner()`` builds the port's scanner."""


save_machine = _checkpoint.save_machine
_PORT_CLASS = {_machine.Machine: Machine,
               _bytes_machine.ByteMachine: ByteMachine}


def load_machine(path_or_file, key_fn="saved", cmp_fn="saved",
                 backend: str = "auto"):
    """``utils/checkpoint.py:load_machine``, returning the port's
    ``Machine`` or ``ByteMachine``: the checkpoint module builds its own
    package's classes, whose ``scanner()`` would import the JAX scanner.
    The port's classes only add ``scanner()``, so the loaded machine takes
    the port's class as it is."""
    m = _checkpoint.load_machine(path_or_file, key_fn=key_fn, cmp_fn=cmp_fn,
                                 backend=backend)
    m.__class__ = _PORT_CLASS[type(m)]
    return m
