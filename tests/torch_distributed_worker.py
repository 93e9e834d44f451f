"""Worker process of tests/test_torch_distributed.py, the port of
tests/distributed_worker.py.

    python torch_distributed_worker.py <process_id> <num_processes> <port>

Each process owns 4 CPU shards; init_distributed (gloo) joins them into one
8-shard mesh, the halo between the processes' shards travelling by
torch.distributed send and receive and the results by all_gather. The same
seeded dictionary, corpus and count_many documents in every process, with
step_k=2; each process checks the mesh's count (from a str and from a
resident ShardedTensor), find_matches, count_many and a session against the
host streaming oracle and a single-device scanner.
"""

import os
import random
import sys

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import aho_corasick_1975_tpu_torch as act  # noqa: E402
from aho_corasick_1975_tpu_torch.parallel.mesh import (  # noqa: E402
    data_sharded, init_distributed, make_mesh)
from aho_corasick_1975_tpu_torch.parallel.sharded_scan import (  # noqa: E402
    ShardedScanner)

init_distributed(coordinator_address=f"localhost:{port}",
                 num_processes=nproc, process_id=proc_id)
assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc

rng = random.Random(1234)  # identical dictionary and corpus in every process
m = act.Machine()
for _ in range(40):
    m.insert_keyword("".join(rng.choice("abcd")
                             for _ in range(rng.randint(1, 6))))
m.insert_keyword("spanner")
text = list("".join(rng.choice("abcd x") for _ in range(4096)))
for edge in (512, 1024, 2048, 3000):  # spans shards, and processes at 2048
    text[edge - 3:edge + 4] = "spanner"
text = "".join(text)

mesh = make_mesh(devices=["cpu"] * 4)
assert mesh.size == 4 * nproc and mesh.local == list(
    range(4 * proc_id, 4 * proc_id + 4)), mesh
scanner = ShardedScanner(m, mesh, n_streams_per_device=4, step_k=2)
single = m.scanner(n_streams=4, step_k=2, device="cpu")
cur = m.initiate()
expected = sum(m.match(cur, ch) for ch in text)

total = scanner.count(text)
assert total == expected, f"proc {proc_id}: {total} != {expected}"
ids = scanner.encode(text)
assert scanner.count(data_sharded(mesh, ids)) == expected
assert scanner.count(data_sharded(mesh, ids), head=ids[-3:]) == \
    single.count(text, head=ids[-3:])
want = single.find_matches(text)
for got in (scanner.find_matches(text),
            scanner.find_matches(data_sharded(mesh, ids)),
            scanner.find_matches(text, max_hits_per_shard=4096)):
    assert np.array_equal(got.ends, want.ends)
    assert np.array_equal(got.indices, want.indices)
np.testing.assert_array_equal(scanner.scan_states(data_sharded(mesh, ids)),
                              single.scan_states(text))

docs = [text[:300], "spanner", "", text[300:900]]
got = scanner.count_many(docs).tolist()
exp = [single.count(d) for d in docs]
assert got == exp, f"proc {proc_id}: count_many {got} != {exp}"

s = scanner.session()
assert sum(s.feed_count(text[i:i + 700])
           for i in range(0, len(text), 700)) == expected

sparse = ShardedScanner(m, mesh, n_streams_per_device=4, prefilter="on")
dead = np.zeros(8 * 128 * 4, np.int32)
dead[2048 - 3:2048 + 4] = sparse.encode("spanner")
assert sparse.count(data_sharded(mesh, dead)) == single.count(dead) > 0

dist.barrier()
dist.destroy_process_group()
print(f"DISTOK proc={proc_id} nproc={nproc} total={total}", flush=True)
