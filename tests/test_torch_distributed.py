"""Two processes, one mesh: the port of tests/test_distributed.py.

Spawns 2 processes of tests/torch_distributed_worker.py, each with 4 CPU
shards, joined by init_distributed over gloo into one 8-shard mesh; in both
the mesh's results must equal the host oracle, and both must report the
same total. This runs the cross-process halo send and receive and the
all_gather that an in-process mesh never reaches. The workers are killed
after 120 s.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh():
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out: " + repr(outs))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err}"
        assert "DISTOK" in out, out
    totals = {line.split("total=")[1] for _, out, _ in outs
              for line in out.splitlines() if "DISTOK" in line}
    assert len(totals) == 1
