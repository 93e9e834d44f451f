"""Needle hunting on the PyTorch/CUDA port: the counterpart of
examples/needle_hunt_demo.py, sparse-corpus scanning above the wire floor.

Rare-pattern search (signatures, markers, IDs) through corpora that are
mostly dead bytes:

* `prefilter="on"` — the host filters RAW bytes through a 256-entry LUT
  (no encode of the dead regions) and uploads ONLY the live 128-symbol
  windows: wire bytes = live fraction x corpus;
* retrieval takes the same elided path (`find_matches(max_hits=...)`);
* the stream session carries matches across chunk edges, and its
  checkpoint + the machine checkpoint implement the crash-recovery
  protocol.

Run: python3 examples_torch/needle_hunt_demo.py [--device cuda|cpu]
"""

import argparse
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import aho_corasick_1975_tpu_torch as act
from aho_corasick_1975_tpu_torch.models.scanner import StreamSession
from aho_corasick_1975_tpu_torch.utils import checkpoint as ckpt

SIGNATURES = [b"BEGIN-KEY", b"xyzzy", b"deadbeef", b"s3cr3t"]


def main(device="cuda") -> dict:
    """Runs the hunt; returns its corpus, plants, count, the listed
    events (start, end, value), the restore's offset and the matches
    found across it."""
    # -- build the hunter ---------------------------------------------------
    machine = act.Machine()
    for sig in SIGNATURES:
        machine.insert_keyword(sig, value=sig.decode())
    scanner = machine.scanner(prefilter="on", device=device)

    # -- a mostly-dead corpus with a few planted needles --------------------
    rng = np.random.default_rng(4)
    corpus = bytearray(b"\x00" * (4 << 20))
    plants = []
    for _ in range(12):
        sig = SIGNATURES[rng.integers(0, len(SIGNATURES))]
        p = int(rng.integers(0, len(corpus) - 16))
        corpus[p:p + len(sig)] = sig
        plants.append((p, sig))
    corpus = bytes(corpus)

    total = scanner.count(corpus)
    print(f"count: {total} matches in {len(corpus) >> 20} MiB "
          f"(live fraction {scanner.stats['sparse_live_frac']:.4%}, "
          f"uploaded {scanner.stats['sparse_elided_upload_bytes'] >> 10} "
          f"KiB instead of {len(corpus) >> 10} KiB)")

    events = []
    for ev, match in scanner.find_matches(corpus, max_hits=256):
        print(f"  @{ev.start}: {match.value}")
        events.append((ev.start, ev.end, match.value))

    # -- chunked streaming with a mid-hunt crash + recovery -----------------
    blob = io.BytesIO()
    ckpt.save_machine(machine, blob)
    session = scanner.session()
    mid = len(corpus) // 2 + 3
    found = len(session.feed_matches(corpus[:mid], max_hits=256))
    state = session.checkpoint()
    del session, scanner, machine          # "the worker dies"

    blob.seek(0)
    machine = ckpt.load_machine(blob)      # "a new worker takes over"
    scanner = machine.scanner(prefilter="on", device=device)
    session = StreamSession.restore(scanner, state)
    found += len(session.feed_matches(corpus[mid:], max_hits=256))
    assert found == total, (found, total)
    print(f"recovered mid-hunt at offset {state['offset']}: "
          f"{found}/{total} matches after restore — exact")
    return {"corpus": corpus, "plants": plants, "total": total,
            "events": events, "offset": state["offset"], "found": found}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
