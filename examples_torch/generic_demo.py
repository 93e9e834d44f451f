"""The generic-capabilities tour on the PyTorch/CUDA port: the counterpart
of examples/generic_demo.py (the reference's
examples/aho_corasick_generic_test.c).

Test 1: the Aho–Corasick paper graph with adversarial extensions, case-
        insensitive matching, duplicate-value merging, trie dump, and
        find_matches on ``device``.
Test 2: mrs_dalloway.txt word counting with the dictionary built
        incrementally from the text itself (Meyer insert-during-scan).
Test 3: incremental stress rounds (scaled) with device-scan counting: three
        rounds of 25,000 random 7-letter keywords (113,402, 214,508 and
        311,968 states), each counted over 1M letter ids on ``device``.

Run: python3 examples_torch/generic_demo.py [mask] [--device cuda|cpu]
     (mask bit 1 = test1, 2, 4 ...)
"""

import argparse
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import aho_corasick_1975_tpu_torch as act

CORPUS = "/root/reference/examples/mrs_dalloway.txt"


def test1(device):
    print("/****************** First test ************************/")
    text = ("He found his pencil, but she could not find hers "
            "(Hi! Ushers !! --abcdefgh--)")
    m = act.Machine(key_fn=str.lower)   # case-insensitive, like alphacmp
    keywords = ["he", "she", "sheers", "his", "hi", "hers", "ushers",
                "abcde", "bcd", "hers", "hen", "hen", "bcdef", "pen",
                "cdefg", "pen", "bcd", "abc", "abcd", "abcde", "bcde",
                "cde", "cd", "bc", "u", "uu"]
    for index, kw in enumerate(keywords):
        prev = m.insert_keyword(kw, value=[index])
        if prev is not None:
            prev[0] += index       # "user defined appender"
    print(f"[{m.nb_keywords()}] distinct keywords")
    m.foreach_keyword(lambda match: print(
        f"{{'{match.text()}'={match.value[0]}}}", end=""))
    print()
    m.print()

    sc = m.scanner(device=device)
    events = []
    for ev, match in sc.find_matches(text):
        print(f"{ev.start:3d} {match.text()}")
        events.append((ev.start, ev.end, match.text()))
    return {"machine": m, "text": text, "events": events}


def test2():
    print("/****************** Second test ************************/")
    try:
        raw = open(CORPUS, errors="replace").read()
    except OSError:
        print("corpus not mounted; skipping")
        return None
    text = re.sub(r"[^a-z]", " ", raw.lower())
    m = act.Machine()
    cur = m.initiate()
    t0 = time.perf_counter()
    counts = {}
    line = " "
    m.match(cur, " ")
    for ch in text:
        nb = m.match(cur, ch)
        line += ch
        if nb:
            for j in range(nb):
                kw = m.get_match(cur, j).text()
                counts[kw] = counts.get(kw, 0) + 1
            line = " "
        elif ch == " ":
            if line != "  ":
                m.insert_keyword(line)   # register mid-scan (Meyer)
            line = " "
    print(f"Elapsed time for scanning text for keywords: "
          f"{time.perf_counter() - t0:.3f} s.")
    print(f"{m.nb_keywords()} keywords registered.")
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
    print("top recurring words:", ", ".join(f"{k.strip()}={v}"
                                            for k, v in top))
    return counts


def test3(device):
    print("/****************** Third test ************************/")
    rng = np.random.default_rng(0)
    m = act.Machine()
    for c in range(26):
        m.vocab.register(chr(ord("a") + c))
    rounds = []
    for rnd in range(3):
        t0 = time.perf_counter()
        kws = rng.integers(1, 27, (25000, 7)).astype(np.int32)
        m._b.insert_keywords_bulk(
            kws.reshape(-1), np.arange(25001, dtype=np.int64) * 7)
        print(f"[{rnd + 1}] {m.nb_keywords()} keywords total, inserted in "
              f"{time.perf_counter() - t0:.3f} s")
        text = rng.integers(1, 27, 1_000_000).astype(np.int32)
        sc = m.scanner(n_streams=512, device=device)
        t0 = time.perf_counter()
        total = sc.count(text)
        print(f"[{rnd + 1}] {total} matches in 1M chars in "
              f"{time.perf_counter() - t0:.3f} s (device scan)")
        rounds.append({"keywords": kws, "text": text, "total": total,
                       "scanner": sc})
    return rounds


def main(device="cuda", mask=~0) -> dict:
    """Runs the tests of ``mask``; returns what each computed (Test 1's
    machine, text and events; Test 2's counts, None without the corpus;
    each round of Test 3: its keywords, text, total and scanner)."""
    out = {}
    if mask & 1:
        out["test1"] = test1(device)
    if mask & 2:
        out["test2"] = test2()
    if mask & 4:
        out["test3"] = test3(device)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mask", nargs="?", type=int, default=~0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.device, args.mask)
