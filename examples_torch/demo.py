"""The README demo on the PyTorch/CUDA port: the counterpart of
examples/demo.py (the reference's examples/test.c).

Prints the text and the golden match line:
    6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers
(1-based start positions, shortest match first at each end position).
The acm_* API runs on the host: no step of this demo uses ``device``,
which is taken for the command line the other examples share.

Run: python3 examples_torch/demo.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import aho_corasick_1975_tpu_torch as act


def main(device="cuda") -> str:
    """Prints the text and the match line; returns the line."""
    machine = act.acm_create()
    state = act.acm_initiate(machine)
    for word in ["he", "she", "his", "hers"]:
        for ch in word:
            act.acm_insert_letter_of_keyword(state, ch)
        act.acm_insert_end_of_keyword(state)

    text = "To ushers: he found his pencil, but she could not find hers."
    print(text)
    matcher = act.acm_matcher_init()
    cst = act.acm_initiate(machine)
    line = []
    for i, ch in enumerate(text):
        for j in range(act.acm_match(cst, ch), 0, -1):
            act.acm_get_match(cst, j - 1, matcher)
            line.append(f" {i + 2 - matcher[0].length}:{matcher[0].text()}")
    print("".join(line))
    act.acm_matcher_release(matcher)
    act.acm_release(machine)
    return "".join(line)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
