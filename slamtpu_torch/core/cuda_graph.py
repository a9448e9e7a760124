"""Capture-once CUDA graphs: a stage with static shapes and no host sync
runs on a CUDA device as one graph replay (``GraphRunner``).

Per key, the first call runs the function eagerly (so that the kernel
library, the cuBLAS and cuSOLVER handles and the constants exist), the
second captures it on static copies of its inputs, and every later call
copies its inputs in, replays under the client's ``record_function`` span
and returns copies of the outputs, so results kept in flight share no
memory. Inputs are plain tuples and NamedTuples: their tensors on the
capture device become buffers; None, numbers and CPU tensors pass through
and belong in the key. Sticky inputs (a table rebuilt now and then) are
copied in only when the caller passes another object than last time.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function


def replays(device: torch.device) -> bool:
    """Whether a client replays on ``device`` (it adds what only it sees)."""
    return device.type == "cuda"


def _map(fn, x):
    """``fn`` on the tensor leaves of plain tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [_map(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _leaves(x) -> list:
    out = []
    _map(out.append, x)
    return out


def uncounted(fn, counters=None):
    """(``fn()``, what it added to the ``counters`` dict), the dict left as it was."""
    before = dict(counters or {})
    out = fn()
    counts = {k: counters[k] - n for k, n in before.items()}
    if counters is not None:
        counters.update(before)
    return out, counts


def capture(fn, device, counters=None):
    """(graph, outputs, counts of one replay) of ``fn`` as one CUDA graph.
    ``fn`` runs once on the capture stream first, so that what that stream
    needs (the pair kernel's tickets, the cuBLAS and cuSOLVER workspaces)
    exists before the capture; what the capture adds to the launch
    ``counters`` counts at each replay instead."""
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out, counts = uncounted(fn, counters)
    return graph, out, counts


class _Captured:
    """One key's static inputs, graph and static outputs."""

    def __init__(self, fn, device, inputs: tuple, sticky: tuple, counters):
        self.device, self.sources = device, sticky  # the objects the sticky buffers hold
        self.inputs, self.sticky = (_map(lambda t: t.clone() if t.device == device else t, x)
                                    for x in (inputs, sticky))
        self.graph, self.out, self.counts = capture(lambda: fn(*self.inputs, *self.sticky), device,
                                                    counters)

    def load(self, inputs: tuple, sticky: tuple):
        changed = [(buf, new) for buf, new, old in zip(self.sticky, sticky, self.sources)
                   if new is not old]
        for bufs, values in [(self.inputs, inputs)] + changed:
            for buf, t in zip(_leaves(bufs), _leaves(values)):
                if buf.device == self.device:
                    buf.copy_(t)
        self.sources = sticky


class GraphRunner:
    """``fn(*inputs, *sticky)`` per key: eager once, captured once, then
    replayed; a replay adds to ``counters`` what the captured call added."""

    def __init__(self, fn, span: str, counters: dict = None):
        self.fn, self.span, self.counters = fn, span, counters
        self._graphs = {}  # key -> None (ran eagerly once) or _Captured
        self.captures = 0

    def run(self, key, device: torch.device, inputs: tuple, sticky: tuple = ()):
        """``device``: the inputs' own (``cuda:0``, not ``cuda``)."""
        if key not in self._graphs:
            self._graphs[key] = None
            return self.fn(*inputs, *sticky)
        run = self._graphs[key]
        if run is None:
            run = self._graphs[key] = _Captured(self.fn, device, inputs, sticky, self.counters)
            self.captures += 1
        else:
            run.load(inputs, sticky)
        with record_function(self.span):
            run.graph.replay()
        for k, n in run.counts.items():
            self.counters[k] += n
        return _map(torch.Tensor.clone, run.out)
