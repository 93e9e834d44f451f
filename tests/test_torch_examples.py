"""The port's examples (examples_torch/) against the JAX package's
(examples/), on the CPU.

Each pair runs at the JAX example's own sizes (generic Test 3's 75,000
keywords, the 4 MiB hunt, the 200,000-word sharded corpus, the 4,000,000-
character host-parallel text), the JAX example as it runs (the needle hunt
at import), the port's through ``main(device="cpu")``, each with stdout
captured. Their outputs must be equal line for line once the fields that
differ from run to run are masked: seconds, MB/s and ms, the serving
demo's port, the device list (JAX device objects), the type name of
JAX's mesh shape (``OrderedDict(...)``), and the host-parallel demo's
``counts a..b`` range, which its scanning thread makes vary. Every count,
event and keyword line is compared exactly. Without CUDA, an example's
``main()`` on its default device raises: it never runs on the CPU instead.
"""

import contextlib
import importlib.util
import io
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("demo", "generic_demo", "needle_hunt_demo", "serving_demo",
         "sharded_demo", "host_parallel_demo")
MASKS = [
    (re.compile(r"\d+\.\d+ s\b"), "<s>"),
    (re.compile(r"\d+ MB/s"), "<MB/s>"),
    (re.compile(r"\d+\.\d+ ms\b"), "<ms>"),
    (re.compile(r"serving on 127\.0\.0\.1:\d+"), "serving on <port>"),
    (re.compile(r"^devices: .*$"), "devices: <devices>"),
    (re.compile(r"OrderedDict\((\{[^}]*\})\)"), r"\1"),
    (re.compile(r"counts \d+\.\.\d+"), "counts <range>"),
]


def load(folder: str, name: str):
    """The example ``folder/name.py``, loaded by path and run (at import,
    for the JAX needle hunt) with stdout captured: (module, output)."""
    path = os.path.join(ROOT, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    return mod, out.getvalue()


def captured(fn, *args, **kw):
    """(fn's result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


def masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for pattern, repl in MASKS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


def run_jax(name: str) -> str:
    mod, out = load("examples", name)
    if name == "generic_demo":
        for test in (mod.test1, mod.test2, mod.test3):   # its mask ~0
            out += captured(test)[1]
    elif name == "serving_demo":
        out += captured(mod.demo)[1]
    elif name != "needle_hunt_demo":
        out += captured(mod.main)[1]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_the_jax_example_prints(name):
    want = masked(run_jax(name))
    mod, _ = load("examples_torch", name)
    res, out = captured(mod.main, device="cpu")
    got = masked(out)
    assert got == want
    assert len(got) >= 2 and any(ch.isdigit() for ch in "".join(got))
    if name == "demo":
        assert res == " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers"
    if name == "generic_demo":
        assert [r["total"] for r in res["test3"]] == [4, 8, 9]
        assert res["test3"][-1]["scanner"].tables.n_states == 311_968
    if name == "needle_hunt_demo":
        assert res["total"] == res["found"] == len(res["events"]) == 12
    if name == "serving_demo":
        assert out.rstrip().endswith("demo OK")


# The examples with steps on the device, each with a pattern of the lines
# that only a device step that ran would print.
DEVICE_EXAMPLES = {"generic_demo": r"(?m)^ *\d+ [a-z]+$|Second test",
                   "needle_hunt_demo": r"count:",
                   "serving_demo": r"FEED",
                   "sharded_demo": r"matches across"}


@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_example_on_its_default_device_raises_without_cuda(name):
    import torch
    assert not torch.cuda.is_available()
    mod, _ = load("examples_torch", name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(
            (AssertionError, RuntimeError, ValueError)):
        mod.main()
    assert not re.search(DEVICE_EXAMPLES[name], out.getvalue())
