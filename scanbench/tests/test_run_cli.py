"""The command the check runs: without a card it exits non-zero and prints
no result; in a directory that holds only BENCHMARK.json and scanbench/
(no program) it does the same; and nothing that a run or the reference
imports is JAX or the JAX package (top-level names compared whole)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from scanbench.harness import guard, spec

ROOT = str(spec.ROOT)
RUN = os.path.join(ROOT, "scanbench", "run.py")
ARGS = ["--workload", "words1000.count_64m", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.strip().splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    _no_result(subprocess.run([sys.executable, RUN, *ARGS], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300))


def test_lone_benchmark_dir_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "scanbench"), tmp_path / "scanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(subprocess.run(
        [sys.executable, "scanbench/run.py", *ARGS], cwd=tmp_path,
        capture_output=True, text=True, timeout=300))


PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

RUN_BODY = """
import time
from scanbench.tests import small
for cell in small.TRAFFIC:
    for trace in (False, True):
        small.run(cell, seconds=0.2, trace=trace)
"""
REF_BODY = """
import numpy as np
from scanbench import reference, roofline
from scanbench.harness import check
r = reference.Reference([b"he", b"she"])
r.matches(b"ushers"); r.count(b"ushers")
"""


def _tops(body):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    tops = _tops(RUN_BODY)
    assert guard.PROGRAM in tops
    assert not tops & set(guard.FORBIDDEN)


def test_the_reference_imports_no_jax_and_no_program():
    tops = _tops(REF_BODY)
    assert not tops & (set(guard.FORBIDDEN) | {guard.PROGRAM})


def test_guard_compares_whole_names():
    assert guard.loaded(modules={"aho_corasick_1975_tpu_torch.ops": 1,
                                 "jaxtyping": 1}) == []
    assert guard.loaded(modules={"aho_corasick_1975_tpu.models": 1,
                                 "jax.numpy": 1}) == [
        "aho_corasick_1975_tpu", "jax"]
