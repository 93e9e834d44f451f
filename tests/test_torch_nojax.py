"""The port imports no JAX: the GPU machine it runs on has none.

A fresh interpreter blocks every ``jax``/``jaxlib`` import with a meta-path
finder, imports ``aho_corasick_1975_tpu_torch`` and runs on the CPU the
golden flow, then a ByteMachine through save_machine/load_machine, a
session, count_many (raw bytes and a resident tensor), refresh(), a
prefilter scanner's count and find_matches (raw bytes, host ids and a
tensor) and scan_states_sequential, an ``engine="mxu"`` and an
``engine="hybrid"`` count (each staged through the scanner's ring,
``models/staging.py``) and a ``calibrate=True`` scanner, a mesh of CPU
shards (a ShardedScanner's count, also of a ShardedTensor, find_matches and
a bounded session), the associative scan and the utils. Then no module
of the JAX package may be loaded, by name or by file: the port keeps its
own copies of the host modules it needs, and its native core builds in
the port's build directory. The card's scripts, ``chip_smoke.py`` and the
``probe_*.py`` scripts, import neither and refuse to run without CUDA. The
examples of ``examples_torch/`` import neither (nor ``examples/``) and run
on the CPU with every such import blocked.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"jax is blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    sys.path.insert(0, sys.argv[1])
    import aho_corasick_1975_tpu_torch as act

    m = act.Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    text = "To ushers: he found his pencil, but she could not find hers."
    for step_k in ("auto", 1):
        sc = m.scanner(device="cpu", step_k=step_k)
        assert sc.count(text) == 9
        ms = sc.find_matches(text)
        assert isinstance(ms, act.MatchSet) and len(ms) == 9
        assert [mt.text() for _, mt in ms][:3] == ["she", "he", "hers"]

    import io
    import numpy as np
    import torch
    bm = act.ByteMachine()
    for kw in [b"he", b"she", b"his", b"hers"]:
        bm.insert_keyword(kw)
    blob = io.BytesIO()
    act.save_machine(bm, blob)
    blob.seek(0)
    bm = act.load_machine(blob)
    assert isinstance(bm, act.ByteMachine)
    sc = bm.scanner(device="cpu", n_streams=4)
    data = text.encode()
    s = sc.session()
    assert sum(s.feed_count(data[i:i + 5]) for i in range(0, len(data), 5)) == 9
    restored = act.StreamSession.restore(sc, s.checkpoint())
    assert restored.total == 9
    docs = [data[:12], data[12:], b""]
    got = sc.count_many(docs)
    assert got.tolist() == [3, 5, 0], got
    tm = torch.zeros((64, 2), dtype=torch.int32)
    tm[:12, 0] = torch.from_numpy(sc.encode(data[:12]))
    assert sc.count_many(tm).tolist() == [3, 0]
    bm.insert_keyword(b"us")
    assert sc.refresh() is True
    assert sc.count(data) == 10
    sparse_text = bytes(5000) + data + bytes(3000)
    for step_k in ("auto", 1):
        sp = bm.scanner(device="cpu", n_streams=4, prefilter="on",
                        step_k=step_k)
        ids = sp.encode(sparse_text)
        for signs in (sparse_text, ids, torch.from_numpy(ids)):
            assert sp.count(signs) == 10
            assert len(sp.find_matches(signs)) == 10
            assert sp.stats["last_op"] == "find_matches_sparse"
        assert len(sp.find_matches(sparse_text, max_hits=16)) == 10
        assert sp.scan_states_sequential(data).shape == (len(data),)
    for engine in ("mxu", "hybrid"):
        se = m.scanner(device="cpu", engine=engine, n_streams=4)
        assert se.count(text) == 9 and se.count(text * 40) == 360
    from aho_corasick_1975_tpu_torch.models import staging
    assert isinstance(se._stager, staging.Stager)
    assert se._stager.slots_used > 0 and sp._stager.slots_used > 0
    import os
    import tempfile
    from aho_corasick_1975_tpu_torch.core import native
    from aho_corasick_1975_tpu_torch.ops import autotune, build
    os.environ["ACX_AUTOTUNE_CACHE"] = os.path.join(tempfile.mkdtemp(),
                                                    "autotune.json")
    autotune.PROBE_SYMBOLS = 1 << 12
    sc = m.scanner(device="cpu", calibrate=True, n_streams=4)
    assert "calibration" in sc.stats and sc.count(text) == 9
    from aho_corasick_1975_tpu_torch.ops.scan_assoc import make_assoc_scan
    from aho_corasick_1975_tpu_torch.parallel.mesh import (data_sharded,
                                                           make_mesh)
    from aho_corasick_1975_tpu_torch.parallel.sharded_scan import (
        ShardedScanner)
    from aho_corasick_1975_tpu_torch.utils import compile_cache, profiling
    from aho_corasick_1975_tpu_torch.utils.config import MachineConfig
    assert act.MachineConfig is MachineConfig
    mesh = make_mesh(devices=["cpu"] * 4)
    sh = ShardedScanner(m, mesh, n_streams_per_device=4)
    ids = sh.encode(text * 4)
    assert sh.count(text * 4) == sh.count(data_sharded(mesh, ids)) == 36
    assert len(sh.find_matches(text)) == 9 and len(sh.session().feed_matches(
        text, max_hits=16)) == 9
    t = m.compile()
    got = make_assoc_scan(t.vocab_size)(
        torch.from_numpy(np.ascontiguousarray(t.delta, np.int32)),
        torch.from_numpy(sc.encode(text)))
    assert got.tolist() == sc.scan_states_sequential(text).tolist()
    timer = profiling.PhaseTimer()
    with timer.phase("scan"):
        pass
    compile_cache.enable_compile_cache()
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib",
                                           "aho_corasick_1975_tpu"))
    assert not loaded, loaded
    ref_dir = os.path.join(os.path.realpath(sys.argv[1]),
                           "aho_corasick_1975_tpu") + os.sep
    files = [os.path.realpath(f) for f in
             (getattr(mod, "__file__", None) for mod in list(
                 sys.modules.values())) if f]
    from_ref = [f for f in files if f.startswith(ref_dir)]
    assert not from_ref, from_ref
    lib = os.path.realpath(native.library_path)
    assert lib.startswith(os.path.realpath(build.BUILD_DIR) + os.sep), lib
    print("NOJAX-OK")
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, ROOT],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout


CHIP_SCRIPT = textwrap.dedent("""
    import importlib
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib",
                                      "aho_corasick_1975_tpu"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    sys.path.insert(0, sys.argv[1])
    import torch
    assert not torch.cuda.is_available()
    assert importlib.import_module(sys.argv[2]).main() == 1
    print("REFUSED")
""")


def test_chip_scripts_refuse_without_cuda_and_import_no_jax():
    """chip_smoke.py, probe_mxu_rows.py, probe_k7_dense.py and
    probe_staging.py import neither JAX nor the JAX package, and their
    main() returns 1 where torch sees no CUDA."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for name in ("chip_smoke", "probe_mxu_rows", "probe_k7_dense",
                 "probe_staging"):
        proc = subprocess.run([sys.executable, "-c", CHIP_SCRIPT, ROOT, name],
                              capture_output=True, text=True, timeout=120,
                              cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "REFUSED" in proc.stdout


EXAMPLES_SCRIPT = textwrap.dedent("""
    import contextlib
    import importlib.util
    import io
    import os
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib",
                                      "aho_corasick_1975_tpu", "examples"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    root = sys.argv[1]
    for name in ("demo", "generic_demo", "needle_hunt_demo", "serving_demo",
                 "sharded_demo", "host_parallel_demo"):
        path = os.path.join(root, "examples_torch", name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(device="cpu")
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in ("jax", "jaxlib",
                                           "aho_corasick_1975_tpu"))
    assert not loaded, loaded
    print("EXAMPLES-NOJAX-OK")
""")


def test_examples_import_and_run_without_jax():
    """Every script of examples_torch/ names no module of JAX, of the JAX
    package or of examples/ in its imports, and all six run on the CPU
    with those imports blocked."""
    paths = sorted(glob.glob(os.path.join(ROOT, "examples_torch", "*.py")))
    assert len(paths) == 6, paths
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "aho_corasick_1975_tpu", "examples"), (
                    path, name)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", EXAMPLES_SCRIPT, ROOT],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "EXAMPLES-NOJAX-OK" in proc.stdout
