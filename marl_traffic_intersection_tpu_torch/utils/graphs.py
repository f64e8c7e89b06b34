"""CUDA graphs: the port's counterpart of ``jax.jit`` on its hot paths.

The JAX package compiles each hot path into one XLA program
(``VectorEnv.jit_step``, ``PPOLearner.jit_train_step``). Run eagerly, the
port dispatches every operation from Python, and on the card the host's
dispatch, not the device, sets the pace. A ``torch.cuda.CUDAGraph`` captured
from the eager code replays exactly the kernels that code launches, in the
same order, on the same operands, kernel K1's and the libm kernels' ctypes
launches included, so a graphed function is bit-equal to its eager run and
the exactness contract (EXACTNESS.md) carries over. ``torch.compile`` would
regenerate the elementwise arithmetic (Triton contracts ``a*b + c`` into a
fused multiply-add, hazard H3) and cannot see the ctypes launches.

``Graph(fn, pool)`` graphs ``fn()``, a function of no arguments that reads
and writes static tensors: buffers that exist before the capture and
outlive it, which the caller refills before each call (``stage``). The
first call runs ``fn`` eagerly on the pool's capture stream and does that
call's work. That warm-up fills the caches that a capture must not create:
``libm.const`` and ``libm.table`` copy from the host on first use, the nvcc
builds of ops/native.py load, cuBLAS creates its handle and workspace for
the stream, and Adam creates its state. Then ``fn`` is captured (a capture
runs nothing) and every later call replays the graph. A failed capture or
replay raises: there is no eager fallback on the card. What ``fn`` returns
comes back from each call: the eager tensors on the first, the graph's own
output tensors after, overwritten by the next replay.

Python's cyclic collector is held off while a graph is captured. A graph
held in a dead reference cycle (a step's graphs hold its bound methods) is
destroyed when the collector runs, and CUDA forbids destroying one while a
stream captures: the capture would fail. torch no longer collects before a
capture, so without the hold a collection could fall inside one.

The kernel wrappers count their launches in ``native.LAUNCHES`` when Python
calls them, which a replay does not. So a capture takes back the counts its
calls added, keeps them as the graph's ``launches``, and each replay adds
them again: the counters count what ran on the card, graphed or not.

Graphs of one ``GraphPool`` share its memory pool, and its capture stream.
They must run one at a time, which one stream gives, and a tensor a graph
allocated stays valid only while something holds it: every graph keeps
what its function returned.

A program that the host must steer, as the traffic step whose NPC width
and loop rounds are read from the device, is cut into segments between the
host's decisions: ``Segments`` keeps one ``Graph`` per key (a segment at
one NPC width, say) and the static buffers by which a segment hands its
result to the next (``carry``). A capture runs nothing, so a graph's own
outputs hold their values only after a replay, and the first call returns
the warm-up's tensors: a segment captured on either would read stale
memory later. So every tensor that crosses a segment boundary is copied,
inside the segment that makes it, into a buffer made once and held for
the life of the graphs, and every segment must be called on the buffers it
was captured on (another input raises). The graphs of all keys share one
pool and replay in another order than they were captured in, which is
safe because each one's outputs stay held.

``Segments`` is the graphed one of two segment runners, the objects that
every step of the port is written against (the env step, the NPC update's
loops, the learner's train step): ``run(key, fn, *inputs)`` runs a device
segment, ``run.carry(key, fn, *inputs)`` runs one whose result the next
segment reads, and ``host_read(run, cause, read)`` reads the device between
segments. ``EAGER``, the other, calls each function; so one body, run by
either, makes the same calls, reads and loop rounds.

A host read between segments (``host_read``) drains the stream, and the
device then idles until the next replay's graph starts. So a ``Segments``
handed a counter (the env's ``npc_stats``) keeps a span per read: the read
stamps the host's clock (``after_read(cause)``) and the next replay, when
it returns, adds the seconds since the stamp to
``stats["read_idle_s.<cause>"]`` (``IDLE`` + the cause; ``stat_counts``
leaves those out). A key's first call, which warms and captures, drops the
open span. While a torch profiler records, each call of a key is the range
``mti.replay.<key>`` on its timeline (on the host alone, ``marked``),
beside the reads' ``mti.read.<cause>`` and the kernels the replay runs.

``capturable_(optimizer)`` switches Adam to keep its step count on the
parameters' device (``capturable=True``), which a captured step needs.
"""
from __future__ import annotations

import collections
import gc
import time
from typing import Callable, Optional

import torch
from torch.autograd import _profiler_enabled as profiling

from ..ops import native

IDLE = "read_idle_s."           # npc_stats' summed seconds: IDLE + a read's cause


def stat_counts(stats) -> dict:
    """The counts of an ``npc_stats`` counter: every key but the summed
    seconds (``read_idle_s.<cause>``), which only a graphed run keeps."""
    return {k: v for k, v in stats.items() if not k.startswith(IDLE)}


def marked(name: str):
    """The range ``name`` on a recording torch profiler's timeline (call it
    where ``profiling()`` holds). It marks the host alone: a
    ``record_function`` range (a user scope) also gets a device-side copy
    spanning the kernels launched inside it, which a trace's reduction would
    count as device work; this record (a function scope) gets none."""
    return torch._C._profiler._RecordFunctionFast(name)


def host_read(run, cause: str, read):
    """``read()``, a read of the device by the host, which waits for the
    stream to drain. While a torch profiler records, the read is the range
    ``mti.read.<cause>`` on its timeline. Then the segment runner ``run`` is
    told (``run.after_read(cause)``): the graphed one times the device's
    idle from here to its next replay, the eager one does nothing."""
    if profiling():
        with marked("mti.read." + cause):
            value = read()
    else:
        value = read()
    run.after_read(cause)
    return value


class _Eager:
    """The segment runner of the eager code: ``run(key, fn, *inputs)`` and
    ``run.carry(key, fn, *inputs)`` are ``fn(*inputs)``, and
    ``run.after_read(cause)`` (``host_read``) does nothing (``Segments`` is
    the graphed one)."""

    def __call__(self, key, fn, *inputs):
        return fn(*inputs)

    carry = __call__

    def after_read(self, cause: str) -> None:
        pass


EAGER = _Eager()


class GraphPool:
    """One memory pool and one capture stream for the graphs of one owner."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)


class Graph:
    """``fn()`` run eagerly once, then captured and replayed (see the module
    docstring). ``launches`` are the kernel launches counted while
    capturing, credited to ``native.LAUNCHES`` on every replay; ``replays``
    counts the replays and ``capture_s`` is the capture's host seconds."""

    def __init__(self, fn: Callable, pool: GraphPool):
        self.fn, self.pool = fn, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: collections.Counter = collections.Counter()
        self.replays = 0
        self.capture_s = 0.0

    def __call__(self):
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        self.replays += 1
        native.LAUNCHES.update(self.launches)
        return self.out

    def _warm_and_capture(self):
        side, here = self.pool.stream, torch.cuda.current_stream(self.pool.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = self.fn()
        here.wait_stream(side)
        before = collections.Counter(native.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()        # see the module docstring
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=side):
                self.out = self.fn()
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: its counts become the replays'
            self.launches = collections.Counter(native.LAUNCHES)
            self.launches.subtract(before)
            self.launches = +self.launches
            native.LAUNCHES.clear()
            native.LAUNCHES.update(before)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        return out


class Segments:
    """Graphs of one pool by key: ``run(key, fn, *inputs)`` is the ``Graph``
    of ``fn(*inputs)`` (made at the key's first call, on that call's
    inputs), ``carry(key, fn, *inputs)`` the same with ``fn``'s result
    copied into the key's static buffers, which it returns (see the module
    docstring). A key's function is that of its first call; ``inputs`` are
    nests of tensors and must be the same buffers at every call. With
    ``stats``, the device's idle after each host read is summed there by
    cause, on ``clock`` (ns; see the module docstring)."""

    def __init__(self, pool: GraphPool, stats: Optional[collections.Counter] = None,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.pool, self.stats, self.clock = pool, stats, clock
        self.graphs: dict = {}
        self._inputs: dict = {}
        self._carried: dict = {}
        self._read = None           # the open span: (its stats key, the clock at the read)

    @classmethod
    def on(cls, device, stats: Optional[collections.Counter] = None) -> "Segments":
        """Segments of a new ``GraphPool`` on ``device``."""
        return cls(GraphPool(device), stats)

    def after_read(self, cause: str) -> None:
        """The host has just read the device: opens a span of ``cause``."""
        if self.stats is not None:
            self._read = (IDLE + cause, self.clock())

    def __call__(self, key, fn: Callable, *inputs):
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = Graph(lambda: fn(*inputs), self.pool)
            self._inputs[key] = inputs
            self._read = None
        elif not _same_buffers(inputs, self._inputs[key]):
            raise ValueError(f"graph {key} was captured on other input buffers")
        if profiling():
            with marked("mti.replay." + "/".join(map(str, key))):
                out = graph()
        else:
            out = graph()
        read = self._read
        if read is not None:
            self._read = None
            self.stats[read[0]] += (self.clock() - read[1]) * 1e-9
        return out

    def carry(self, key, fn: Callable, *inputs):
        def body(*xs):
            out = fn(*xs)
            if key in self._carried:
                copy_tree_(self._carried[key], out)
            else:           # the warm-up call: the buffers are made once
                self._carried[key] = clone_tree(out)
        self(key, body, *inputs)
        return self._carried[key]


def _same_buffers(a, b) -> bool:
    """Whether two nests hold tensors at the same addresses."""
    if a is b:
        return True
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.is_tensor(a) and torch.is_tensor(b) and a.data_ptr() == b.data_ptr()
    if a is None or b is None or len(a) != len(b):
        return False
    return all(_same_buffers(x, y) for x, y in zip(a, b))


def leaves(tree) -> list:
    """The tensors of a nest of tuples (NamedTuples included), in order;
    None entries are skipped."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [t for sub in tree for t in leaves(sub)]


def clone_tree(tree):
    """``tree`` with every tensor cloned into a new contiguous one."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.clone(memory_format=torch.contiguous_format)
    parts = [clone_tree(sub) for sub in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def copy_tree_(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, which must match them in
    structure, shape and type; a tensor that already is its static buffer
    (a state passed back in) is not copied."""
    d, s = leaves(dst), leaves(src)
    if len(d) != len(s):
        raise ValueError(f"expected {len(d)} tensors, got {len(s)}")
    for a, b in zip(d, s):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"a graph's static buffer is {a.dtype} {tuple(a.shape)}, "
                             f"got {b.dtype} {tuple(b.shape)}")
        if a is b or (a.data_ptr() == b.data_ptr() and a.stride() == b.stride()):
            continue
        a.copy_(b)


def stage(static, value):
    """``value`` written into the static buffers ``static``, which are made
    from it (cloned) when None; returns the static buffers."""
    if static is None:
        return clone_tree(value)
    copy_tree_(static, value)
    return static


def capturable_(optimizer: torch.optim.Optimizer, on: bool = True) -> torch.optim.Optimizer:
    """Switch an Adam to take its step count as a float32 tensor on the
    parameters' device (``capturable=True``, which a captured step needs)
    or back to the host (``on=False``), in place. Capturable Adam computes
    its bias corrections in float32 on the device, where the eager one
    takes them in float64 on the host, so the two agree to rounding."""
    for group in optimizer.param_groups:
        group["capturable"] = on
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and torch.is_tensor(state.get("step")):
                state["step"] = state["step"].to(p.device if on else "cpu", torch.float32)
    return optimizer
