"""The port's serving example (examples_torch/serving_demo.py) on the CPU:
every case of tests/test_serving.py against the port's MatchServer, with
``scanner_kwargs={"n_streams": 4, "device": "cpu"}``, and its default
device, the card, which it never trades for the CPU."""

from __future__ import annotations

import importlib.util
import os
import threading

import pytest


@pytest.fixture(scope="module")
def serving():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "examples_torch", "serving_demo.py")
    spec = importlib.util.spec_from_file_location("torch_serving_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def server(serving):
    srv = serving.MatchServer(("127.0.0.1", 0),
                              keywords=["he", "she", "his", "hers"],
                              scanner_kwargs={"n_streams": 4,
                                              "device": "cpu"})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_golden_demo_over_the_wire(serving, server):
    port = server.server_address[1]
    c = serving.Client(port)
    text = "To ushers: he found his pencil, but she could not find hers."
    n1, total1 = map(int, c.cmd("FEED " + text[:30]).split())
    n2, total2 = map(int, c.cmd("FEED " + text[30:]).split())
    assert (n1 + n2, total2) == (9, 9)  # incl. 'she' spanning the chunk edge
    assert c.cmd("TOTAL") == "9"
    c.close()


def test_online_registration_and_absolute_positions(serving, server):
    port = server.server_address[1]
    c = serving.Client(port)
    c.cmd("FEED 0123456789")  # advance the stream offset
    assert c.cmd("ADD pencil") == "OK"
    hits = c.cmd_multi("MATCHES his pencil")
    assert [h.split()[2] for h in hits] == ["his", "pencil"]
    starts = [int(h.split()[0]) for h in hits]
    assert starts == [10, 14]  # absolute positions across chunks
    c.close()


def test_sessions_are_independent_but_share_the_dictionary(serving, server):
    port = server.server_address[1]
    a = serving.Client(port)
    b = serving.Client(port)
    a.cmd("ADD token")
    assert a.cmd("FEED a token") == "1 1"
    assert b.cmd("FEED a token too") == "1 1"  # own total, same dictionary
    assert a.cmd("TOTAL") == "1"
    a.close()
    b.close()


def test_concurrent_clients_with_online_adds(serving, server):
    port = server.server_address[1]
    errors = []

    def worker(i):
        try:
            c = serving.Client(port)
            c.cmd(f"ADD word{i}")
            for _ in range(5):
                n, _ = c.cmd(f"FEED and word{i} here with hers").split()
                assert int(n) >= 1  # own word (post-refresh) or 'hers'
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors


def test_server_defaults_to_the_card(serving):
    """Without a device in scanner_kwargs the server's scanner goes to
    CUDA, and without CUDA it raises before it listens."""
    import torch
    assert not torch.cuda.is_available()
    with pytest.raises((AssertionError, RuntimeError)):
        serving.MatchServer(("127.0.0.1", 0), keywords=["he"],
                            scanner_kwargs={"n_streams": 4})
