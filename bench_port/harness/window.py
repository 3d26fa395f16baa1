"""Closed-loop clients over a measured window.

Each client is a thread of the run's process. It draws its items from a
shuffled deck of the configuration's items (every item once a round, a
new order each round, from ``default_rng([seed, 1, client])``), issues a
request only before the deadline, and sends the next one when the last
has returned. Every request is recorded with its host clock, its bytes
and, in a traced run, the program's phase seconds.

The output of each client's first request is kept for the check after
the window, and of every later one with the mix's ``check_share`` as its
chance, drawn from ``default_rng([seed, 3, client])``; the others are
dropped as soon as they return, as a server drops what it has sent, so
that the harness holds no more memory than the check needs.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Item:
    index: int
    name: str
    plain: bytes
    archive: bytes


@dataclass
class Request:
    client: int
    item: int
    t0: float           # perf_counter seconds
    t1: float
    plain_bytes: int
    archive_bytes: int
    phases: dict = field(default_factory=dict)
    output: object = None
    error: str | None = None
    kept: bool = True


class Deck:
    """Items in a new seeded order every round."""

    def __init__(self, n: int, seed: int, client: int):
        self.rng = np.random.default_rng([seed % (1 << 64), 1, client])
        self.n = n
        self.order: list = []

    def next(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(self.n))
        return int(self.order.pop())


def request(call, state, item: Item, client: int, kind: str,
            phases: dict | None, span=None, keep: bool = True) -> Request:
    """One call, timed; an exception is recorded, not raised. The output
    is dropped unless ``keep``."""
    t0 = time.perf_counter()
    out = err = None
    try:
        if span is None:
            out = call(state, item, phases)
        else:
            with span(item):
                out = call(state, item, phases)
    except Exception:  # a failed request is counted, the run goes on
        err = traceback.format_exc()
    t1 = time.perf_counter()
    if kind == "compress":
        abytes = len(out) if isinstance(out, (bytes, bytearray)) else 0
    else:
        abytes = len(item.archive)
    return Request(client, item.index, t0, t1, len(item.plain), abytes,
                   dict(phases or {}), out if keep else None, err, keep)


@dataclass
class Window:
    start: float
    deadline: float
    end: float          # the last completion
    requests: list
    stuck: int          # clients still in a request at the join limit

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run(call, state, items: list, clients: int, seconds: float, seed: int,
        kind: str, traced: bool, span=None, join_limit: float = 90.0,
        check_share: float = 1.0) -> Window:
    """``clients`` closed loops for ``seconds``; returns every request."""
    per_client: list = [[] for _ in range(clients)]
    start_gate = threading.Barrier(clients + 1)
    bounds = {}

    def loop(c: int) -> None:
        deck = Deck(len(items), seed, c)
        keep = np.random.default_rng([seed % (1 << 64), 3, c])
        start_gate.wait()
        deadline = bounds["deadline"]
        while time.perf_counter() < deadline:
            item = items[deck.next()]
            kept = not per_client[c] or bool(keep.random() < check_share)
            per_client[c].append(request(
                call, state, item, c, kind, {} if traced else None, span,
                kept))

    threads = [threading.Thread(target=loop, args=(c,), daemon=True,
                                name=f"bench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    start = time.perf_counter()
    bounds["deadline"] = start + seconds
    start_gate.wait()
    for t in threads:
        t.join(max(0.0, bounds["deadline"] + join_limit - time.perf_counter()))
    stuck = sum(t.is_alive() for t in threads)
    reqs = sorted((r for rs in per_client for r in rs), key=lambda r: r.t0)
    end = max((r.t1 for r in reqs), default=start)
    return Window(start, bounds["deadline"], end, reqs, stuck)


def warm(call, state, items: list, clients: int, policy: str,
         kind: str) -> list:
    """The set-up pass over ``items`` (the cell's, or the entry's
    ``warmup_items`` of them): ``each_client`` runs every item once on
    every client at once (so that per-client buffers of every shape
    exist); ``split`` runs every item once, spread over the clients.
    Returns the errors and the longest request's seconds."""
    errors: list = []
    longest = [0.0]

    def one(c: int) -> None:
        if policy == "each_client":
            mine = items
        else:
            mine = items[c::clients] or [items[c % len(items)]]
        for it in mine:
            r = request(call, state, it, c, kind, None)
            longest[0] = max(longest[0], r.t1 - r.t0)
            if r.error:
                errors.append(r.error)

    threads = [threading.Thread(target=one, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors, longest[0]
