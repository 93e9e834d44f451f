"""domains1m: a web proxy's log lines in Squid's native format matched
against a list of a million registrable domains, both drawn from the seed
(``domains1m.json`` says what is assumed and why).

The list is drawn on the host, label by label, and kept as a byte table on
the device; each document is a batch of log lines made on the device, each
field a block of fixed width with a mask of the bytes it keeps, the
blocks laid side by side and the kept bytes read out in order."""

from __future__ import annotations

import numpy as np
import torch

from scanbench.harness.gen import numpy_generator, to_bytes, torch_generator

EPOCH_MS = 1_700_000_000_000


def _char_law(cfg: dict) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(characters, their probabilities inside a label, at its ends): the
    letters by frequency, digits and the hyphen at their shares, the
    hyphen never at an end."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    chars = np.frombuffer(cfg["label_alphabet"].encode(), np.uint8)
    p = np.zeros(len(chars))
    lp = np.array([cfg["letter_percent"][chr(c)] for c in letters])
    share = 100.0 - cfg["digit_percent"] - cfg["hyphen_percent"]
    for i, c in enumerate(chars):
        if c in letters:
            p[i] = share * lp[c - ord("a")] / lp.sum()
        elif chr(c).isdigit():
            p[i] = cfg["digit_percent"] / 10
        else:
            p[i] = cfg["hyphen_percent"]
    edge = np.where(chars == ord("-"), 0.0, p)
    return chars, p / p.sum(), edge / edge.sum()


def draw_domains(cfg: dict, seed: int) -> list:
    """The list: ``cfg["domains"]`` distinct byte strings, label and
    public suffix, in rank order; a domain drawn twice is drawn again."""
    rng = numpy_generator(seed, 1)
    chars, p_in, p_edge = _char_law(cfg)
    law = cfg["label_length"]
    tlds = [("." + t).encode() for t in cfg["tld_percent"]]
    tld_p = np.array(list(cfg["tld_percent"].values()), np.float64)
    tld_p /= tld_p.sum()
    n = cfg["domains"]
    out: list = [b""] * n
    todo = np.arange(n)
    seen: set = set()
    while len(todo):
        m = len(todo)
        lens = np.minimum(law["min"] + rng.geometric(law["geometric_p"], m)
                          - 1, law["max"])
        ends = np.cumsum(lens)
        flat = chars[rng.choice(len(chars), int(ends[-1]), p=p_in)]
        edges = np.concatenate([ends - lens, ends - 1])
        flat[edges] = chars[rng.choice(len(chars), len(edges), p=p_edge)]
        tld = rng.choice(len(tlds), m, p=tld_p)
        again = []
        for i, e, k, t in zip(todo.tolist(), ends.tolist(), lens.tolist(),
                              tld.tolist()):
            d = flat[e - k:e].tobytes() + tlds[t]
            if d in seen:
                again.append(i)
            else:
                seen.add(d)
                out[i] = d
        todo = np.asarray(again, np.int64)
    return out


def _table(strings: list) -> "tuple[np.ndarray, np.ndarray]":
    """Byte strings as a zero-padded [n, width] uint8 table and their
    lengths."""
    lens = np.fromiter(map(len, strings), np.int64, len(strings))
    tab = np.zeros((len(strings), max(int(lens.max()), 1)), np.uint8)
    flat = np.frombuffer(b"".join(strings), np.uint8)
    rows = np.repeat(np.arange(len(strings)), lens)
    cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
    tab[rows, cols] = flat
    return tab, lens


class _Choices:
    """A set of byte strings on the device, picked by index into a block."""

    def __init__(self, strings, device):
        tab, lens = _table([s.encode() if isinstance(s, str) else s
                            for s in strings])
        self.tab = torch.from_numpy(tab).to(device)
        self.lens = torch.from_numpy(lens).to(device)

    def pick(self, idx: torch.Tensor):
        cols = torch.arange(self.tab.shape[1], device=idx.device)
        return self.tab[idx], cols[None, :] < self.lens[idx][:, None]


def _digits(v: torch.Tensor, width: int, fill: str = ""):
    """Decimal digits of ``v`` (int64, 0 <= v < 10^width) right-aligned in
    a block of ``width``: only the digits kept, or the whole field padded
    on the left with ``fill`` (" " for Squid's ``%6d``, "0" for its
    ``%03d``)."""
    p10 = 10 ** torch.arange(width - 1, -1, -1, device=v.device,
                             dtype=torch.int64)
    d = ((v[:, None] // p10) % 10 + ord("0")).to(torch.uint8)
    keep = (v[:, None] >= p10) | (p10 == 1)
    if fill:
        d = torch.where(keep, d, ord(fill)).to(torch.uint8)
        return d, torch.ones_like(keep)
    return d, keep


def _const(s: bytes, n: int, device):
    row = torch.tensor(list(s), dtype=torch.uint8, device=device)
    return row.expand(n, len(s)), torch.ones(n, len(s), dtype=torch.bool,
                                             device=device)


def _cdf(weights, device) -> torch.Tensor:
    w = np.asarray(weights, np.float64)
    return torch.from_numpy(np.cumsum(w / w.sum())).to(device)


def _draw(cdf: torch.Tensor, n: int, g) -> torch.Tensor:
    u = torch.rand(n, generator=g, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=len(cdf) - 1)


def _exponential(mean: float, n: int, g, device) -> torch.Tensor:
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return -mean * torch.log1p(-u)


class Deployment:
    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.domains = draw_domains(cfg, seed)
        self.increments = [self.domains]
        dev = self.device
        self._domains = _Choices(self.domains, dev)
        ranks = np.arange(1, len(self.domains) + 1, dtype=np.float64)
        self._rank_cdf = _cdf(ranks ** -cfg["zipf_s"], dev)
        pre = cfg["host_prefix_percent"]
        self._prefix = _Choices(
            ["", "www."] + [s + "." for s in cfg["subdomains"]], dev)
        n_sub = len(cfg["subdomains"])
        self._prefix_cdf = _cdf([pre[""], pre["www."]]
                                + [pre["sub"] / n_sub] * n_sub, dev)
        statuses = ["TCP_TUNNEL/200"] + list(cfg["get_status_percent"])
        self._status = _Choices(statuses, dev)
        # a hit is answered from the cache: no server address
        self._is_hit = torch.tensor(["HIT/" in s for s in statuses],
                                    device=dev)
        self._status_cdf = _cdf(list(cfg["get_status_percent"].values()), dev)
        self._type = _Choices(["-"] + list(cfg["get_type_percent"]), dev)
        self._type_cdf = _cdf(list(cfg["get_type_percent"].values()), dev)
        self._hier = _Choices(["HIER_DIRECT/", "HIER_NONE/-"], dev)
        self._method = _Choices(["CONNECT ", "GET http://"], dev)
        self._path_chars = torch.from_numpy(np.frombuffer(
            cfg["path_alphabet"].encode(), np.uint8).copy()).to(dev)

    def _lines(self, n: int, g):
        """The blocks (bytes [n, w], kept [n, w]) of ``n`` log lines, in
        the line's order."""
        cfg, dev = self.cfg, self.device
        ts = EPOCH_MS + torch.cumsum(_exponential(
            cfg["mean_interarrival_ms"], n, g, dev), 0).long()
        elapsed = _exponential(cfg["mean_elapsed_ms"], n, g, dev).long()
        client = torch.randint(0, cfg["clients"], (n,), generator=g,
                               device=dev)
        rank = _draw(self._rank_cdf, n, g)
        prefix = _draw(self._prefix_cdf, n, g)
        get = torch.rand(n, generator=g, device=dev) * 100 \
            >= cfg["connect_percent"]
        status = torch.where(get, 1 + _draw(self._status_cdf, n, g), 0)
        hit = self._is_hit[status]
        ctype = torch.where(get, 1 + _draw(self._type_cdf, n, g), 0)
        size = _exponential(cfg["mean_reply_bytes"], n, g,
                            dev).long().clamp_(max=10 ** 10 - 1)
        law = cfg["path_length"]
        plen = torch.minimum(1 + torch.floor(torch.log1p(-torch.rand(
            n, generator=g, device=dev, dtype=torch.float64))
            / np.log1p(-law["geometric_p"])).long(),
            torch.tensor(law["max"], device=dev))
        width = law["max"] + 1
        path = self._path_chars[torch.randint(
            0, len(self._path_chars), (n, width), generator=g, device=dev)]
        path[:, 0] = ord("/")
        cols = torch.arange(width, device=dev)
        port = torch.tensor(list(b":443"), dtype=torch.uint8, device=dev)
        path[:, :4] = torch.where(get[:, None], path[:, :4], port)
        path_keep = cols[None, :] < torch.where(get, 1 + plen, 4)[:, None]
        server = (rank * 2654435761 + 12345) % (1 << 32)
        octets = [((server >> s) % 254 + 1) for s in (24, 16, 8, 0)]
        sp = _const(b" ", n, dev)
        dot = _const(b".", n, dev)
        ip = [_digits(octets[0], 3), dot, _digits(octets[1], 3), dot,
              _digits(octets[2], 3), dot, _digits(octets[3], 3)]
        ip = [(b, k & ~hit[:, None]) for b, k in ip]
        return [
            _digits(ts // 1000, 10), dot, _digits(ts % 1000, 3, "0"),
            sp, _digits(elapsed.clamp(max=999999), 6, " "), sp,
            _const(b"10.1.", n, dev), _digits(client // 256, 3), dot,
            _digits(client % 256, 3), sp,
            self._status.pick(status), sp, _digits(size, 10), sp,
            self._method.pick(get.long()),
            self._prefix.pick(prefix), self._domains.pick(rank),
            (path, path_keep), sp, _const(b"- ", n, dev),
            self._hier.pick(hit.long()), *ip, sp,
            self._type.pick(ctype), _const(b"\n", n, dev)]

    def texts(self, n: int, nbytes: int, stream: int = 0) -> list:
        """``n`` documents of ``nbytes`` bytes: log lines, the last one cut
        at ``nbytes``."""
        out = []
        for i in range(n):
            g = torch_generator(self.device, self.seed, 2, stream, i)
            n_lines = nbytes // 100 + 64
            while True:
                blocks = self._lines(n_lines, g)
                keep = torch.cat([k for _, k in blocks], dim=1)
                if int(keep.sum()) >= nbytes:
                    break
                n_lines *= 2
            doc = torch.cat([b for b, _ in blocks], dim=1)[keep]
            out.append(to_bytes(doc[:nbytes]))
        return out


def make(cfg: dict, seed: int, device) -> Deployment:
    return Deployment(cfg, seed, device)
