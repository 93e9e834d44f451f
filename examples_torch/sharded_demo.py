"""Multi-device demo on the PyTorch/CUDA port: the counterpart of
examples/sharded_demo.py, a data-parallel scan over a device mesh.

Shards a corpus across every CUDA device when there are several, or across
8 logical shards of one device (the card, or the CPU under --device cpu)
when there is one, replicates the automaton tables, hands each shard the
halo before its edge and sums the shards' counts.

Run: python3 examples_torch/sharded_demo.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import aho_corasick_1975_tpu_torch as act
from aho_corasick_1975_tpu_torch.ops.decode import decode_matches
from aho_corasick_1975_tpu_torch.parallel.mesh import make_mesh
from aho_corasick_1975_tpu_torch.parallel.sharded_scan import ShardedScanner


def main(device="cuda") -> dict:
    """Runs the scan; returns the machine, text, mesh, total and the
    first events (start, keyword)."""
    if device == "cuda" and torch.cuda.device_count() != 1:
        mesh = make_mesh()    # every card; raises where there is none
    else:
        mesh = make_mesh(devices=[device] * 8)
    print(f"devices: {[str(d) for d in mesh.devices]}")
    m = act.Machine()
    for kw in ["needle", "haystack", "spanner"]:
        m.insert_keyword(kw)

    rng = np.random.default_rng(0)
    words = ["needle", "haystack", "spanner", "filler", "noise", "words"]
    text = " ".join(rng.choice(words) for _ in range(200_000))

    scanner = ShardedScanner(m, mesh)
    total = scanner.count(text)
    print(f"{total} matches across {dict(mesh.shape)} mesh "
          f"(corpus {len(text):,} chars)")

    # positions survive sharding: decode from the sharded states
    events = decode_matches(scanner.scan_states(text[:5000]), scanner.tables)
    first = [(ev.start, m.match_for_state(ev.end_state).text())
             for ev in events[:5]]
    print("first events:", first)
    return {"machine": m, "text": text, "mesh": mesh, "total": total,
            "first": first}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
