"""The domains1m deployment (scanbench/configs/domains1m.py) at a small size
on the CPU.

The generator gives the same list and log lines for the same seed, and the
list keeps RFC 1035's label rules (letters, digits and hyphens, 1-63
octets, no hyphen at an end), the lines Squid's native format. A
dictionary past the k-gram budget (here a budget of a few KiB, as 128 MiB
is at a million domains) keeps only its 1-char tables: then the port's
``find_matches()`` takes ``scan_states`` (K2's states read back and
decoded on the host, an ``ac.decode`` of ``on_device`` 0, under the span
``ac.states``) and, with ``count()``, equals the benchmark's plain
reference and the JAX package's scanner element for element, on the
generated lines, on names with 63-character labels and a 69-character
name, an empty text, a text with no hit and with an ``offset``. A tiny
traced run of the cell reads ``retrieve.states_ms``."""

from __future__ import annotations

import functools
import json
import re
import time

import numpy as np
import pytest

from aho_corasick_1975_tpu.models.scanner import DenseScanner as JaxScanner
from aho_corasick_1975_tpu_torch import DenseScanner, Machine
from aho_corasick_1975_tpu_torch.utils import profiling
from scanbench.harness import core, spec
from scanbench.reference import Reference

CELL = "domains1m.retrieve_64m"
CFG_PATH = spec.BENCH_DIR / "configs" / "domains1m.json"
N_DOMAINS = 3000
DOC_BYTES = 1 << 18
# past every small dictionary's k-gram table: only the 1-char tables stay
BUDGET = 4096
SEEDS = [5, 2 ** 31 + 7, 3 * 2 ** 40 + 11]
LINE = re.compile(
    rb"^(\d{10})\.(\d{3}) ( *\d+) 10\.1\.\d{1,3}\.\d{1,3} "
    rb"(TCP_[A-Z_]+)/(\d{3}) (\d+) (CONNECT|GET) (\S+) - "
    rb"(HIER_DIRECT/\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}|HIER_NONE/-) (\S+)$")
LABEL = re.compile(rb"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")


def _cfg(n: int = N_DOMAINS) -> dict:
    with open(CFG_PATH) as f:
        cfg = json.load(f)
    cfg["domains"] = n
    return cfg


@functools.lru_cache(maxsize=None)
def _deployment(seed: int):
    gen = spec.load_module(CFG_PATH.with_name("domains1m.py"),
                           "scanbench_config_domains1m")
    dep = gen.make(_cfg(), seed, "cpu")
    return dep, tuple(dep.texts(2, DOC_BYTES, 10))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_generator_is_seeded(seed):
    dep, docs = _deployment(seed)
    gen = spec.load_module(CFG_PATH.with_name("domains1m.py"), "again")
    again = gen.make(_cfg(), seed, "cpu")
    assert again.domains == dep.domains
    assert tuple(again.texts(2, DOC_BYTES, 10)) == docs
    other = gen.make(_cfg(), seed + 1, "cpu")
    assert other.domains != dep.domains
    assert other.texts(1, DOC_BYTES, 10)[0] != docs[0]
    assert dep.increments == [dep.domains]
    assert docs[0] != docs[1] and [len(d) for d in docs] == [DOC_BYTES] * 2


@pytest.mark.parametrize("seed", SEEDS)
def test_the_list_keeps_the_label_rules(seed):
    dep, _ = _deployment(seed)
    cfg = _cfg()
    domains = dep.domains
    assert len(domains) == N_DOMAINS == len(set(domains))
    suffixes = tuple("." + t for t in cfg["tld_percent"])
    for d in domains:
        s = d.decode()
        tld = next(t for t in suffixes if s.endswith(t))
        label = d[:len(d) - len(tld)]
        assert 3 <= len(label) <= 63 and LABEL.match(label), d


@pytest.mark.parametrize("seed", SEEDS)
def test_the_lines_are_squid_native(seed):
    dep, docs = _deployment(seed)
    listed = set(dep.domains)
    subs = {b""} | {(s + ".").encode() for s in _cfg()["subdomains"]} | {
        b"www."}
    for doc in docs:
        lines = doc.split(b"\n")[:-1]        # the last line is cut
        assert len(lines) > 1000
        stamps = []
        for line in lines:
            m = LINE.match(line)
            assert m, line
            stamps.append(int(m.group(1) + m.group(2)))
            assert len(m.group(3)) == 6
            method, url, kind = m.group(7), m.group(8), m.group(10)
            if method == b"CONNECT":
                assert url.endswith(b":443") and kind == b"-"
                assert m.group(4) == b"TCP_TUNNEL"
                host = url[:-4]
            else:
                assert url.startswith(b"http://") and kind != b"-"
                host, _, path = url[7:].partition(b"/")
                assert b"." not in path
            head, _, rest = host.partition(b".")
            assert host in listed or (head + b"." in subs and rest in listed)
        assert stamps == sorted(stamps)


def _long_names(seed: int) -> list:
    """Names at RFC 1035's limits: 63-character labels (one under .com,
    one under .co.uk: a 69-character name), and one the first's label
    shortened by one."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    label = rng.choice(letters, 63).tobytes()
    other = rng.choice(letters, 63).tobytes()
    return [label + b".com", other + b".co.uk", label[1:] + b".com"]


def _text(case: str, dep, docs, long_names) -> bytes:
    if case in ("log", "offset"):
        return docs[0]
    if case == "empty":
        return b""
    if case == "no_hit":
        return b"TCP_MISS/200 GET HTTP://EXAMPLE.COM/ - HIER_NONE/- \n" * 90
    # the long names requested, each behind www. and inside a longer name
    parts = []
    for name in long_names + dep.domains[:5]:
        parts += [b"CONNECT www." + name + b":443 - ", b"http://x" + name
                  + b"/a ", name[:-1] + b" "]
    return b"\n".join(parts) * 3


@pytest.fixture(scope="module")
def machine():
    """The list of SEEDS[0] with the long names at its end."""
    dep, docs = _deployment(SEEDS[0])
    long_names = _long_names(SEEDS[0])
    assert max(map(len, long_names)) == 69
    m = Machine()
    keywords = dep.domains + long_names
    m.insert_keywords(keywords)
    return m, keywords, dep, docs, long_names


@pytest.fixture(scope="module")
def scanners(machine):
    m, keywords, *_ = machine
    sc = DenseScanner(m, device="cpu", step_budget_bytes=BUDGET)
    jsc = JaxScanner(m, step_budget_bytes=BUDGET)
    return sc, jsc, Reference(keywords)


CASES = ["log", "long", "empty", "no_hit", "offset"]


@pytest.mark.parametrize("case", CASES)
def test_no_packed_retrieval_equals_the_references(machine, scanners, case):
    m, keywords, dep, docs, long_names = machine
    sc, jsc, ref = scanners
    assert sc._snap.packed is None and sc.step_k == 1
    assert sc.halo == 68 == ref.max_len - 1
    text = _text(case, dep, docs, long_names)
    offset = 12345 if case == "offset" else 0
    profiling.reset()
    with profiling.tracing():
        got = sc.find_matches(text, offset=offset)
    want_ends, want_ids = ref.matches(text)
    np.testing.assert_array_equal(got.ends - offset, want_ends)
    np.testing.assert_array_equal(got.ranks, want_ids)
    jgot = jsc.find_matches(text, offset=offset)
    for col in ("ends", "end_states", "indices"):
        np.testing.assert_array_equal(getattr(got, col), getattr(jgot, col))
    n = sc.count(text)
    assert n == ref.count(text) == jsc.count(text) == len(want_ends)
    if case == "no_hit":
        assert n == 0
    elif case != "empty":
        assert n > 0 and sc.stats["last_op"] == "count"
    if case == "long":
        long_ids = {keywords.index(k) for k in long_names}
        assert long_ids <= set(want_ids.tolist())
    recs = profiling.records()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "ac.find_matches"
    assert root["counts"]["route"] == "states"
    assert root["counts"]["events"] == len(want_ends)
    (decode,) = [r for r in recs if r["name"] == "ac.decode"]
    assert decode["parent"] == root["id"]
    assert decode["counts"]["on_device"] == 0
    states = [r for r in recs if r["name"] == "ac.states"]
    if case == "empty":
        assert not states
        return
    (st,) = states
    assert st["parent"] == root["id"]
    assert st["counts"] == {"symbols": len(text), "bytes": 4 * len(text),
                            "table_bytes": sc._snap.dflat.nbytes}
    assert st["t1"] <= decode["t0"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_reads_the_states_path(monkeypatch, trace):
    """The cell at 3,000 domains and 256 KiB documents, its scanner past
    a small budget as the full list is past 128 MiB: every answer equals
    the reference's; traced, the states' span and the host decode are
    read, and nothing of the device (no card)."""
    monkeypatch.setattr(DenseScanner, "__init__", functools.partialmethod(
        DenseScanner.__init__, step_budget_bytes=BUDGET))
    res = core.run_cell(CELL, SEEDS[1], 1.0, bool(trace),
                        time.perf_counter(), device="cpu",
                        config_overrides={"domains": N_DOMAINS},
                        traffic_overrides={"doc_bytes": DOC_BYTES})
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    got = res["metrics"]
    if not trace:
        assert set(got) == {"setup_s", "retrieve_GBps"}
        return
    for name in ("retrieve.states_ms", "retrieve.decode_ms"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    with open(spec.OUT_DIR / f"{CELL}.program_spans.jsonl") as f:
        recs = [json.loads(line) for line in f]
    roots = {r["id"]: r for r in recs if r["name"] == "ac.find_matches"}
    assert len(roots) == 2 and all(
        r["parent"] is None and r["counts"]["route"] == "states"
        for r in roots.values())
    assert sorted(roots[r["parent"]]["harness_call"] for r in recs
                  if r["name"] == "ac.states") == [0, 1]
    for name in ("retrieve.scan_roofline", "retrieve.host_ms",
                 "retrieve.device_idle"):
        assert name not in got
