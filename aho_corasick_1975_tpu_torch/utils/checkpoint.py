"""Checkpoint / resume — a capability the reference cannot express.

The port's copy of ``aho_corasick_1975_tpu/utils/checkpoint.py``. It builds
the port's classes, and it unpickles a name of the JAX package
(``aho_corasick_1975_tpu.X``, such as the default key function
``aho_corasick_1975_tpu.utils.vocab.identity_key``) as the port's copy of
it (``aho_corasick_1975_tpu_torch.X``), so that a machine saved by the JAX
package loads here to the same automaton without importing that package.
A machine saved here names the port's modules; the JAX package loads it
wherever the port is importable. The file format is the JAX package's.

The reference automaton lives only in process RAM (SURVEY.md §5: no
serialization exists). Here the machine serializes losslessly:

* the trie is stored as its creation-order edge list (prev_state/prev_letter
  per state) — replaying edges in state-id order reconstructs the *identical*
  automaton, including state ids, Meyer inverse-fail sets and output counts;
* the vocabulary serializes BY KIND (checkpointing is total over the model
  family):
    - "hash"  — the default key_fn Vocab: (key, representative sign) pairs
      via pickle (signs must be picklable — true for str/bytes/int/tuple
      alphabets);
    - "cmp"   — comparator-only Vocab (the reference's full genericity
      contract, aho_corasick.h:33-38: keys need not be hashable): the same
      (key, sign) pairs, restored into cmp mode. The comparator itself is
      code: it round-trips when picklable, otherwise the caller re-supplies
      it at load (``cmp_fn=``), mirroring the ``key_fn="saved"`` contract.
      A cmp checkpoint NEVER silently degrades to hash equivalence — load
      refuses loudly without a comparator;
    - "byte"  — ByteMachine's fixed 256-symbol alphabet: a marker only
      (id = byte + 1 by construction, nothing to store);
* keyword end-states, ranks and user values round-trip as arrays/objects.

``save_machine``/``load_machine`` give a fully *mutable* machine back —
insertion can continue after resume (Meyer mode keeps working because the IF
sets are rebuilt by the replay, not stored).

Scan resume is orthogonal and cheap: a scan is a pure function of (tables,
stream); ``models.scanner.StreamSession`` carries (offset, tail halo) across
chunks, so a crashed shard simply rescans its chunk (SURVEY.md §5, failure
detection: scans are stateless and idempotent given the tables —
exercised end-to-end in tests/test_failure_recovery.py).
"""

from __future__ import annotations

import bisect
import io
import pickle
from typing import Any, BinaryIO, Union

import numpy as np

FORMAT_VERSION = 2   # v1 = hash-vocab only (still loadable)
# v3 is written ONLY when a value needed the per-value marker encoding:
# older readers (which accept 1-2) then fail loudly instead of silently
# loading raw pickle blobs as the values map.
PER_VALUE_FORMAT_VERSION = 3

_NOT_SAVED = b""  # sentinel blob: callable was not picklable at save time

_JAX_PACKAGE = "aho_corasick_1975_tpu"
_PORT_PACKAGE = __name__.split(".")[0]


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a global of the JAX package as the port's copy of it."""

    def find_class(self, module, name):
        root, dot, rest = module.partition(".")
        if root == _JAX_PACKAGE:
            module = _PORT_PACKAGE + dot + rest
        return super().find_class(module, name)


def _loads(blob: bytes) -> Any:
    return _PortUnpickler(io.BytesIO(blob)).load()


def _pickle_or_marker(fn: Any) -> bytes:
    """Pickle a user callable if possible; lambdas/closures get the
    not-saved marker and must be re-supplied at load time."""
    try:
        return pickle.dumps(fn)
    except Exception:
        return _NOT_SAVED


class _ValueNotSaved:
    """Sentinel restored in place of a user value that was not picklable at
    save time (same refuse-loudly-or-marker convention as callables; the
    reference supports arbitrary opaque values, aho_corasick.h:56-59).
    Re-insert the keyword with its value to re-attach it."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<value not saved: unpicklable at checkpoint time>"


VALUE_NOT_SAVED = _ValueNotSaved()


def _pickle_values(values: dict) -> tuple[bytes, str]:
    """Pickle the end-state -> user-value map. Fast path: one dict pickle.
    When any VALUE is unpicklable (open file handle, lambda, ...), fall
    back to per-value pickling with a NOT_SAVED marker for the offenders —
    the save never dies on an opaque value (callables get the same
    marker treatment) instead of raising a raw PicklingError."""
    try:
        return pickle.dumps(values), "dict"
    except Exception:
        pass
    blobs: dict = {}
    for k, v in values.items():
        try:
            blobs[k] = pickle.dumps(v)
        except Exception:
            blobs[k] = None            # marker: restored as VALUE_NOT_SAVED
    return pickle.dumps(blobs), "per-value"


def _vocab_kind(vocab) -> str:
    from ..models.bytes_machine import _ByteVocab
    if isinstance(vocab, _ByteVocab):
        return "byte"
    if getattr(vocab, "cmp_fn", None) is not None:
        return "cmp"
    return "hash"


def save_machine(machine, path_or_file: Union[str, BinaryIO]) -> None:
    b = machine._b
    b.ensure_fail_states()
    S = b.n_states
    prev_state = np.asarray(b.prev_state, np.int32)[:S]
    prev_letter = np.asarray(b.prev_letter, np.int32)[:S]
    is_end = np.asarray(b.is_end, bool)[:S]
    kw_rank = np.asarray(b.kw_rank, np.int32)[:S]
    vocab = machine.vocab
    kind = _vocab_kind(vocab)
    if kind == "byte":
        vocab_blob = pickle.dumps(None)   # fixed alphabet: nothing to store
        key_fn_blob = _NOT_SAVED
        cmp_fn_blob = _NOT_SAVED
    else:
        vocab_blob = pickle.dumps({
            "keys": vocab._keys[1:],
            "signs": vocab._signs[1:],
        })
        key_fn_blob = _pickle_or_marker(vocab.key_fn)
        cmp_fn_blob = (_pickle_or_marker(vocab.cmp_fn)
                       if kind == "cmp" else _NOT_SAVED)
    values_blob, values_mode = _pickle_values(machine._values)
    fmt = (PER_VALUE_FORMAT_VERSION if values_mode == "per-value"
           else FORMAT_VERSION)
    np.savez_compressed(
        path_or_file,
        format_version=np.int64(fmt),
        incremental=np.bool_(machine.incremental),
        values_mode=np.bytes_(values_mode.encode()),
        vocab_kind=np.bytes_(kind.encode()),
        prev_state=prev_state,
        prev_letter=prev_letter,
        is_end=is_end,
        kw_rank=kw_rank,
        version=np.int64(machine.version),
        vocab=np.frombuffer(vocab_blob, np.uint8),
        values=np.frombuffer(values_blob, np.uint8),
        key_fn=np.frombuffer(key_fn_blob, np.uint8),
        cmp_fn=np.frombuffer(cmp_fn_blob, np.uint8),
    )


def _restore_callable(z, name: str, given: Any, required: bool):
    """Resolve a user callable at load: "saved" unpickles the stored one
    (refusing loudly if it was not picklable at save time and ``required``),
    anything else is used verbatim."""
    if given != "saved":
        return given
    blob = z[name].tobytes() if name in z.files else _NOT_SAVED
    if blob == _NOT_SAVED:
        if required:
            raise ValueError(
                f"this checkpoint's {name} was not picklable at save time "
                f"(lambda/closure); pass {name}=<function> to load_machine "
                "— restoring without it would silently change letter "
                "equivalence classes")
        return None
    return _loads(blob)


def load_machine(path_or_file: Union[str, BinaryIO], key_fn: Any = "saved",
                 cmp_fn: Any = "saved", backend: str = "auto"):
    """Reconstruct a mutable Machine (or ByteMachine, per the saved vocab
    kind). ``key_fn``/``cmp_fn``: "saved" unpickles the stored function
    (fails loudly for lambdas/closures — pass the function explicitly
    then). A comparator-mode checkpoint requires a comparator: there is no
    silent fallback to hash equivalence."""
    from ..models.bytes_machine import ByteMachine
    from ..models.machine import Machine

    z = np.load(path_or_file, allow_pickle=False)
    fmt = int(z["format_version"])
    if fmt not in (1, FORMAT_VERSION, PER_VALUE_FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version {fmt}")
    kind = (z["vocab_kind"].tobytes().decode()
            if "vocab_kind" in z.files else "hash")
    incremental = bool(z["incremental"])

    if kind == "byte":
        m = ByteMachine(incremental=incremental, backend=backend)
    elif kind == "cmp":
        # key_fn is required here too: the default identity key pickles
        # fine, so a not-saved marker can only mean a custom unpicklable
        # key function — silently substituting identity would change
        # letter equivalence classes.
        kf = _restore_callable(z, "key_fn", key_fn, required=True)
        cf = _restore_callable(z, "cmp_fn", cmp_fn, required=True)
        if cf is None:
            raise ValueError(
                "comparator-mode checkpoint loaded without a comparator")
        m = Machine(key_fn=kf, cmp_fn=cf, incremental=incremental,
                    backend=backend)
    else:
        kf = _restore_callable(z, "key_fn", key_fn, required=True)
        m = Machine(key_fn=kf, incremental=incremental, backend=backend)

    if kind != "byte":
        vocab_data = _loads(z["vocab"].tobytes())
        # Restore the vocabulary exactly (ids and representatives), into
        # the mode it was saved from: dict map for hash keys, sorted
        # comparator list for cmp mode.
        v = m.vocab
        for k, sign in zip(vocab_data["keys"], vocab_data["signs"]):
            i = len(v._signs)
            if v._cmp_key is None:
                v._ids[k] = i
            else:
                w = v._cmp_key(k)
                pos = bisect.bisect_left(v._sorted_keys, w)
                if (pos < len(v._sorted_keys)
                        and v._sorted_keys[pos] == w):
                    raise ValueError(
                        "checkpoint vocabulary collapses under the supplied "
                        "comparator (two saved keys compare equal) — wrong "
                        "cmp_fn for this checkpoint?")
                v._sorted_keys.insert(pos, w)
                v._sorted_ids.insert(pos, i)
            v._keys.append(k)
            v._signs.append(sign)
        v._version += 1  # invalidate encode LUT caches

    values_mode = (z["values_mode"].tobytes().decode()
                   if "values_mode" in z.files else "dict")
    if values_mode == "per-value":
        blobs = _loads(z["values"].tobytes())
        values = {k: (VALUE_NOT_SAVED if b is None else _loads(b))
                  for k, b in blobs.items()}
        n_lost = sum(1 for b in blobs.values() if b is None)
        if n_lost:
            import warnings
            warnings.warn(
                f"{n_lost} keyword value(s) were not picklable at save "
                "time and restore as checkpoint.VALUE_NOT_SAVED; "
                "re-insert those keywords with their values to re-attach "
                "them", stacklevel=2)
    else:
        values = _loads(z["values"].tobytes())
    prev_state = z["prev_state"]
    prev_letter = z["prev_letter"]
    is_end = z["is_end"]
    kw_rank = z["kw_rank"]
    S = len(prev_state)

    # Replay edges in creation order: child ids are assigned sequentially,
    # so state s recreates as exactly state s (incl. Meyer IF maintenance).
    # The native backend replays the whole trie in one FFI call (one ctypes
    # round-trip per state was minutes at 2.5M states); the Python backend
    # keeps the per-edge loop.
    b = m._b
    if hasattr(b, "restore_machine"):
        b.restore_machine(prev_state, prev_letter, is_end, kw_rank)
    else:
        ends = np.nonzero(is_end)[0]
        rank_order = ends[np.argsort(kw_rank[ends], kind="stable")]
        for s in range(1, S):
            got = b.insert_letter(int(prev_state[s]), int(prev_letter[s]))
            if got != s:
                raise ValueError(f"checkpoint replay diverged at state {s}")
        # Mark keyword ends in rank order so ranks reassign identically.
        for s in rank_order:
            b.insert_end(int(s))
    # Restore the snapshot-version counter exactly: replay only counts
    # distinct end-insertions, but duplicates also bump the version, and
    # StreamSession checkpoints pin on it.
    b.set_version(int(z["version"]))
    m._values = values
    return m


def save_tables(tables, path_or_file: Union[str, BinaryIO]) -> None:
    """Snapshot-only save (scan-capable, not insert-capable): the dense
    device tables as plain arrays — the minimal artifact a serving fleet
    distributes to chips."""
    np.savez_compressed(
        path_or_file,
        format_version=np.int64(FORMAT_VERSION),
        delta=tables.delta, nb_outputs=tables.nb_outputs, fail=tables.fail,
        depth=tables.depth, is_end=tables.is_end, kw_rank=tables.kw_rank,
        prev_state=tables.prev_state, prev_letter=tables.prev_letter,
        emit_start=tables.emit_start, emit_state=tables.emit_state,
        version=np.int64(tables.version),
        n_keywords=np.int64(tables.n_keywords),
    )


def load_tables(path_or_file: Union[str, BinaryIO]):
    from ..core.builder import DenseTables

    z = np.load(path_or_file, allow_pickle=False)
    return DenseTables(
        delta=z["delta"], nb_outputs=z["nb_outputs"], fail=z["fail"],
        depth=z["depth"], is_end=z["is_end"], kw_rank=z["kw_rank"],
        prev_state=z["prev_state"], prev_letter=z["prev_letter"],
        emit_start=z["emit_start"], emit_state=z["emit_state"],
        version=int(z["version"]), n_keywords=int(z["n_keywords"]))
