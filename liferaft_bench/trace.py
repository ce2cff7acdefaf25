"""The traced window: a ``torch.profiler`` session over the device alone,
reduced to kernel times, the device's busy time and its idle gaps.

The session records CUDA activity only (kernels, copies, fills and the
runtime calls that launched them), not every operator; still, the host
pays some µs a launch for it.  It covers the second half of the traced
run's window: it starts between two steps (the last token copy has
synchronised the stream) and stops after the window's last token reached
the host, so every device event in it belongs to the window.

Kernel families, by the names the port's kernels carry: K4
``paged_attention*``, K5 ``gmm_*``, and the dense products' cuBLAS kernels
(``DENSE``).

``K5Probe`` records, while the trace runs, the tile counts each call into
K5 is handed (``models.moe.grouped_matmul_fn``'s ``tile_rows``), by
reference and with no launch, so that K5's bytes count the experts the
routing made active.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

__all__ = ["DENSE", "is_k4", "is_k5", "is_dense", "Trace", "start", "stop",
           "K5Probe"]

DENSE = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitKreduce",
                   re.IGNORECASE)
_COPY = ("Memcpy", "Memset")


def is_k4(name: str) -> bool:
    return "paged_attention" in name


def is_k5(name: str) -> bool:
    return "gmm_" in name


def is_dense(name: str) -> bool:
    return bool(DENSE.search(name)) and not (is_k4(name) or is_k5(name))


def short(name: str, width: int = 72) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:width]


@dataclasses.dataclass
class Trace:
    """The device's side of a traced window.  ``kernels``: (name,
    start_ns, duration_ns) of every kernel; ``busy_s``: the union of all
    device activity (kernels, copies, fills); ``idle_by_host``: idle
    seconds between device activity, summed by what the host was doing
    (the runtime call in progress, else the host code before the next
    kernel); ``window_s``: the host clock's window."""

    window_s: float
    kernels: list
    busy_s: float
    idle_by_host: dict
    n_copies: int

    def seconds(self, pick) -> float:
        return sum(d for n, _, d in self.kernels if pick(n)) / 1e9

    def count(self, pick) -> int:
        return sum(1 for n, _, _ in self.kernels if pick(n))

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for n, _, d in self.kernels:
            by[short(n)] += d
        return [[n, d / 1e9] for n, d in sorted(by.items(),
                                                 key=lambda x: -x[1])[:k]]

    def top_idle(self, k: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.idle_by_host.items(),
                                          key=lambda x: -x[1])[:k]]


def start():
    """A started profiler session over CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof, window_s: float) -> Trace:
    """Stop ``prof`` and reduce its events (read from the profiler's raw
    results, without building its operator tree)."""
    from torch.autograd import DeviceType

    prof.stop()
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.duration_ns()))
        elif e.name().startswith("cu"):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    kernels = [x for x in dev if not x[0].startswith(_COPY)]
    spans = sorted((s, s + d, n) for n, s, d in dev)
    busy, segs = 0, []
    for s, e, n in spans:
        if segs and s <= segs[-1][1]:
            if e > segs[-1][1]:
                segs[-1][1] = e
        else:
            segs.append([s, e, n])
    busy = sum(e - s for s, e, _ in segs)
    host.sort()
    idle = defaultdict(float)
    hi = 0
    for (_, a, _), (b, _, nxt) in zip(segs, segs[1:]):
        mid = (a + b) // 2
        while hi < len(host) and host[hi][1] < mid:
            hi += 1
        label = None
        for hs, he, hn in host[hi:hi + 64]:
            if hs > mid:
                break
            if hs <= mid <= he:
                label = f"in {hn}"
                break
        if label is None:
            label = f"host code before {short(nxt, 48)}"
        idle[label] += (b - a) / 1e9
    return Trace(window_s, kernels, busy / 1e9, dict(idle),
                 len(dev) - len(kernels))


class K5Probe:
    """Wraps ``module.grouped_matmul_fn`` while entered; once ``on`` is
    set, each call's (tile_rows, groups, d_in, d_out, itemsize) is kept,
    the tensor by reference.  ``calls()`` reduces them on the device after
    the window: [(active experts, routed rows, d_in, d_out, itemsize)]."""

    def __init__(self, module):
        self.module = module
        self.records: list = []
        self.on = False
        self._orig = None

    def __enter__(self):
        orig = self._orig = self.module.grouped_matmul_fn
        rec = self.records

        def probe(x, tile_gid, w, bt, tile_rows=None):
            if self.on:
                rec.append((tile_rows, w.shape[0], w.shape[1], w.shape[2],
                            x.element_size()))
            return orig(x, tile_gid, w, bt, tile_rows)

        self.module.grouped_matmul_fn = probe
        return self

    def __exit__(self, *exc):
        self.module.grouped_matmul_fn = self._orig
        return False

    def calls(self) -> list:
        import torch

        if not self.records or self.records[0][0] is None:
            return []
        G = self.records[0][1]
        rows = torch.stack([r[0] for r in self.records]).view(
            len(self.records), G, -1).sum(-1)  # (calls, G) rows per expert
        active = (rows > 0).sum(-1).tolist()
        real = rows.sum(-1).tolist()
        return [(a, n, r[2], r[3], r[4])
                for a, n, r in zip(active, real, self.records)]
