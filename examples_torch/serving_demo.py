"""Streaming match-serving daemon on the PyTorch/CUDA port: the counterpart
of examples/serving_demo.py, session-per-connection with an online
dictionary.

ONE machine + ONE device scanner shared by all connections, a
StreamSession per connection (exact matches across chunk edges,
resumable), and online keyword registration absorbed into the live device
tables via DenseScanner.refresh() — no rebuild, no re-upload.

Line protocol (UTF-8, one command per line):

    ADD <keyword>     register a keyword (visible from the next FEED on,
                      reference insert-during-scan semantics, README.md:352-356)
    FEED <text>       stream a chunk; replies "<n> <total>" (chunk/session hits)
    MATCHES <text>    stream a chunk; replies one "<start> <end> <keyword>"
                      line per hit (absolute stream positions), then "."
    TOTAL             replies the session's running total
    QUIT              closes the connection

Run a server:          python3 examples_torch/serving_demo.py --serve [port]
Self-driving demo:     python3 examples_torch/serving_demo.py
Both take --device cuda|cpu (default cuda).
"""

from __future__ import annotations

import argparse
import socket
import socketserver
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import aho_corasick_1975_tpu_torch as act


class MatchServer(socketserver.ThreadingTCPServer):
    """Shared machine + scanner; per-connection sessions are made by the
    handler. One lock serializes device work (scans and snapshot refresh —
    refresh() writes the tables' rows and k-gram cells in place, so a scan
    must not read them half written).

    add_keyword deliberately runs OUTSIDE device_lock: keyword insertion
    and Machine.compile() are made atomic by the machine's own internal
    lock (the reference's machine mutex, c:295,344), so a handler thread
    inserting while another refreshes cannot observe a torn snapshot; the
    device_lock's only job is scanner table exclusion. Handler threads run
    their device work on the device's default stream."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, keywords=(), scanner_kwargs=None):
        self.machine = act.Machine()
        for kw in keywords:
            self.machine.insert_keyword(kw)
        kwargs = {"device": "cuda", **(scanner_kwargs or {})}
        self.scanner = self.machine.scanner(**kwargs)
        self.device_lock = threading.Lock()
        self._dirty = threading.Event()
        super().__init__(addr, MatchHandler)

    # -- online dictionary --------------------------------------------------

    def add_keyword(self, kw: str) -> None:
        self.machine.insert_keyword(kw)  # host-side Meyer insert, ~us
        self._dirty.set()

    def catch_up(self) -> None:
        """Absorb pending insertions into the device snapshot (cheap when
        nothing changed: one version compare)."""
        if self._dirty.is_set():
            with self.device_lock:
                if self._dirty.is_set():
                    self._dirty.clear()
                    self.scanner.refresh()


class MatchHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: MatchServer = self.server
        with server.device_lock:
            session = server.scanner.session()
        for raw in self.rfile:
            line = raw.decode("utf-8", errors="replace").rstrip("\r\n")
            cmd, _, arg = line.partition(" ")
            cmd = cmd.upper()
            if cmd == "QUIT":
                break
            try:
                self._dispatch(server, session, cmd, arg)
            except Exception as e:  # keep the connection alive
                self._reply(f"ERR {type(e).__name__}: {e}")

    def _dispatch(self, server, session, cmd: str, arg: str) -> None:
        if cmd == "ADD":
            server.add_keyword(arg)
            self._reply("OK")
        elif cmd == "FEED":
            server.catch_up()
            with server.device_lock:
                n = session.feed_count(arg)
            self._reply(f"{n} {session.total}")
        elif cmd == "MATCHES":
            server.catch_up()
            with server.device_lock:
                hits = session.feed_matches(arg)
            for ev, mt in hits:
                self._reply(f"{ev.start} {ev.end} {mt.text()}")
            self._reply(".")
        elif cmd == "TOTAL":
            self._reply(str(session.total))
        else:
            self._reply(f"ERR unknown command {cmd!r}")

    def _reply(self, s: str) -> None:
        self.wfile.write((s + "\n").encode("utf-8"))
        self.wfile.flush()


# -- self-driving demo -------------------------------------------------------

class Client:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.f = self.sock.makefile("rwb")

    def cmd(self, line: str) -> str:
        self.f.write((line + "\n").encode());  self.f.flush()
        return self.f.readline().decode().rstrip("\n")

    def cmd_multi(self, line: str) -> list:
        self.f.write((line + "\n").encode());  self.f.flush()
        out = []
        while True:
            r = self.f.readline().decode().rstrip("\n")
            if r == ".":
                return out
            out.append(r)

    def close(self):
        self.cmd("QUIT")
        self.sock.close()


def demo(device="cuda") -> dict:
    """Drives a server on ``device`` from two clients; returns the replies
    it printed, by command."""
    server = MatchServer(("127.0.0.1", 0), keywords=["he", "she", "his", "hers"],
                         scanner_kwargs={"device": device})
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"serving on 127.0.0.1:{port}")

    replies = {}
    c = Client(port)
    text = "To ushers: he found his pencil, but she could not find hers."
    replies["feed1"] = c.cmd("FEED " + text[:30])
    print("FEED #1 ->", replies["feed1"])
    replies["feed2"] = c.cmd("FEED " + text[30:])  # 'she' spans the edge
    print("FEED #2 ->", replies["feed2"])
    replies["total"] = c.cmd("TOTAL")
    print("TOTAL   ->", replies["total"])

    # online registration: visible from the next chunk on
    replies["add"] = c.cmd("ADD pencil")
    print("ADD pencil ->", replies["add"])
    replies["hits"] = c.cmd_multi("MATCHES  he lost his pencil again")
    for hit in replies["hits"]:
        print("  hit:", hit)

    # a second concurrent session has its own cursor but the same dictionary
    c2 = Client(port)
    replies["client2"] = c2.cmd("FEED a pencil for hers")
    print("client2 ->", replies["client2"])
    c2.close()
    c.close()
    server.shutdown()
    server.server_close()
    print("demo OK")
    return replies


def main(device="cuda", serve=None) -> dict:
    """The self-driving demo on ``device``; with ``serve`` (a port), a
    server on 127.0.0.1 that runs until it is killed."""
    if serve is not None:
        server = MatchServer(("127.0.0.1", serve),
                             keywords=["he", "she", "his", "hers"],
                             scanner_kwargs={"device": device})
        print(f"serving on 127.0.0.1:{server.server_address[1]} "
              "(ADD/FEED/MATCHES/TOTAL/QUIT)")
        server.serve_forever()
        return {}
    return demo(device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--serve", nargs="?", type=int, const=9075,
                        default=None, metavar="PORT")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.device, args.serve)
