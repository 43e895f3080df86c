"""CUDA-graph replay of a serving step: the port's counterpart of the
reference's ``jax.jit`` with donated caches (``repro/serving/steps.py``).

A :class:`GraphStep` wraps ``fn(*state, *inputs)``. ``state`` holds what
the step reads and writes in place (parameters and caches: the
reference's donated arguments); ``inputs`` are the per-call arguments,
each a tensor, None or a Python scalar.

On CPU tensors the step runs eagerly. On CUDA tensors the first call
for a key (shapes, strides, dtypes and devices of every tensor, the
value of every other argument: ``jit``'s retrace key) runs ``fn``
eagerly on the runner's own stream: that run is the call's result, and
it makes every one-time host call of the kernels before any capture
(``cudaFuncSetAttribute``, the tensor-map encoder's driver entry point,
the decode kernels' merge counters of that stream). The call then
captures ``fn`` into a CUDA graph on the same stream, which executes
nothing. Later calls with the key copy the input tensors into the
graph's static buffers, replay the graph on the current stream, and
return its static outputs, which the next replay overwrites. The state
must be the very tensors the graph was captured over: a replay over
reallocated state raises. A capture that fails raises.

The kernel wrappers count launches in Python, which a replay does not
run: the runner takes back what the capture counted and adds it on
every replay (``ops.add_launches``), so the counts read the same after
N replays as after N eager calls. Those counts are checked against the
graph itself: the capture names every kernel node through the CUDA
driver, and raises unless each wrapper's device kernels are in the
graph exactly as often as its recorded launches say.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Tuple)

import torch

from repro_torch.kernels import ops as K
from repro_torch.kernels._build import is_plain
from repro_torch.models.transformer import cache_tensors, clone_caches


def _signature(obj, tensors: List[torch.Tensor]):
    """Hashable description of ``obj`` for the graph key; appends its
    tensors to ``tensors`` in order."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return (tuple(obj.shape), obj.stride(), obj.dtype, obj.device)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _signature(v, tensors))
                                 for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return (type(obj),) + tuple(_signature(v, tensors) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a graph step takes tensors, None and Python scalars, "
                    f"not {type(obj).__name__}")


def graph_key(state, inputs) -> Tuple[Any, List[torch.Tensor],
                                      List[torch.Tensor]]:
    """(key, state tensors, input tensors) of one call."""
    st: List[torch.Tensor] = []
    it: List[torch.Tensor] = []
    return (_signature(state, st), _signature(inputs, it)), st, it


def recorded_launches(fn: Callable, *args):
    """Run ``fn(*args)`` and return (its result, the kernel launches it
    counted per wrapper), taking those counts back out of
    ``ops.launch_counts()``: what a capture counts is launched only by
    the replays."""
    before = K.launch_counts()
    out = fn(*args)
    after = K.launch_counts()
    counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    K.add_launches({k: -n for k, n in counts.items()})
    return out, counts


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple            # static input buffers (others as given)
    outputs: Any             # static outputs
    ptrs: Tuple[int, ...]    # data_ptr of each state tensor captured over
    launches: Dict[str, int]  # kernel-wrapper launches of one replay
    nodes: "NodeCensus"


class GraphStep:
    """A step that runs eagerly on CPU tensors and as a replayed CUDA
    graph on CUDA tensors; see the module docstring."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: Dict[Any, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self._stream = None

    def __call__(self, state: tuple, *inputs):
        key, st, it = graph_key(state, inputs)
        if is_plain(*st, *it):
            return self.fn(*state, *inputs)
        g = self.graphs.get(key)
        if g is None:
            out, self.graphs[key] = self._capture(state, inputs, st)
            self.captures += 1
            return out
        if tuple(t.data_ptr() for t in st) != g.ptrs:
            raise RuntimeError(
                "graph step: a state tensor was reallocated since the "
                "graph was captured over it; the step's caches and "
                "parameters must stay the same tensors")
        for buf, x in zip(g.inputs, inputs):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
        g.graph.replay()
        K.add_launches(g.launches)
        self.replays += 1
        return g.outputs

    def _capture(self, state, inputs, st) -> Tuple[Any, _Graph]:
        device = st[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream, current = self._stream, torch.cuda.current_stream(device)
        static = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                       for x in inputs)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self.fn(*state, *inputs)
            graph = torch.cuda.CUDAGraph(keep_graph=True)

            def capture():
                # no cyclic garbage collection inside the capture: it can
                # free a CUDA graph of an engine dropped earlier, and
                # destroying a graph while a stream captures invalidates
                # the capture (torch.cuda.graph collects first only under
                # torch.compiler.config.force_cudagraph_gc)
                enabled = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, stream=stream):
                        return self.fn(*state, *static)
                finally:
                    if enabled:
                        gc.enable()

            outputs, launches = recorded_launches(capture)
        current.wait_stream(stream)
        graph.instantiate()
        nodes = node_census(graph)
        per_launch = K.device_kernels()
        want = {k: n * per_launch[k] for k, n in launches.items()}
        if nodes.wrapper_nodes != want:
            raise RuntimeError(
                f"graph step {self.fn.__name__}: the captured graph holds "
                f"{nodes.wrapper_nodes} kernel nodes of the wrappers' "
                f"device kernels, but the launches recorded during the "
                f"capture ({launches}) issue {want}")
        return out, _Graph(graph, static, outputs,
                           tuple(t.data_ptr() for t in st), launches, nodes)

    def census(self) -> Dict[str, int]:
        """Graphs captured, their kernel nodes, programmatic (dependent
        launch) edges and the nodes of each wrapper's device kernels
        ("<wrapper> nodes") summed over them, captures and replays."""
        out = {"graphs": len(self.graphs),
               "kernel_nodes": sum(g.nodes.kernel_nodes
                                   for g in self.graphs.values()),
               "programmatic_edges": sum(g.nodes.programmatic_edges
                                         for g in self.graphs.values())}
        for g in self.graphs.values():
            for k, n in g.nodes.wrapper_nodes.items():
                out[f"{k} nodes"] = out.get(f"{k} nodes", 0) + n
        out.update(captures=self.captures, replays=self.replays)
        return out


def census(steps: Iterable[Tuple[str, GraphStep]]) -> Dict[str, Any]:
    """``GraphStep.census`` summed per name over ``steps``, (name, step)
    pairs, with the captures and replays of all of them under "captures"
    and "replays"."""
    out: Dict[str, Any] = {}
    for name, step in steps:
        mine = out.setdefault(name, {})
        for k, v in step.census().items():
            mine[k] = mine.get(k, 0) + v
    steps = list(out.values())
    for k in ("captures", "replays"):
        out[k] = sum(c[k] for c in steps)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b hold the same values; fp8 tensors compared as their bytes
    (a NaN that the fp8 cast stored is equal to itself there)."""
    if a.dtype == torch.float8_e4m3fn and b.dtype == a.dtype:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a, b)


@contextlib.contextmanager
def held_to_eager() -> Iterator[Dict[str, int]]:
    """Within the block, every call of a graph step first runs the step
    eagerly on copies of its caches, then makes the real call, and
    raises unless the two give the same logits and caches, bitwise. The
    launch counts (``ops.launch_counts``) hold the real calls only.
    Yields the number of real calls per step (``fn.__name__``) that were
    replays. A check of the runner, not for serving: it runs each step
    twice."""
    replays: Dict[str, int] = {}
    real = GraphStep.__call__

    def checked(self, state, *inputs):
        params, caches = state
        counts = K.launch_counts()
        want_logits, want = self.fn(params, clone_caches(caches), *inputs)
        # the eager run is the check's own: its launches do not count
        K.reset_launch_counts()
        K.add_launches(counts)
        before = self.replays
        logits, got = real(self, state, *inputs)
        if not (torch.equal(logits, want_logits) and all(
                _same_bits(a, b) for a, b in zip(cache_tensors(got),
                                                 cache_tensors(want)))):
            raise AssertionError(f"graph step {self.fn.__name__}: the call "
                                 f"differs from the eager step")
        if self.replays > before:
            name = self.fn.__name__
            replays[name] = replays.get(name, 0) + 1
        return logits, got

    GraphStep.__call__ = checked
    try:
        yield replays
    finally:
        GraphStep.__call__ = real


class NodeCensus(NamedTuple):
    """What a captured graph holds (``node_census``)."""
    kernel_nodes: int
    programmatic_edges: int
    wrapper_nodes: Dict[str, int]  # nodes of each wrapper's device kernels


class _EdgeData(ctypes.Structure):
    """``CUgraphEdgeData`` of the CUDA driver API (``cuda.h``)."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


class _KernelParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API (``cuda.h``)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_NODE_KERNEL = 0             # CU_GRAPH_NODE_TYPE_KERNEL
_EDGE_PROGRAMMATIC = 1       # CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC


def node_census(graph: "torch.cuda.CUDAGraph") -> NodeCensus:
    """Kernel nodes, programmatic dependency edges and the nodes of each
    wrapper's device kernels (``ops.wrapper_of`` of each kernel node's
    function name) of a graph captured with ``keep_graph=True``, read
    through the CUDA driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    P, N = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    S = ctypes.POINTER(ctypes.c_char_p)
    cu.cuGraphGetNodes.argtypes = [P, P, N]
    cu.cuGraphNodeGetType.argtypes = [P, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [
        P, ctypes.POINTER(_KernelParams)]
    cu.cuFuncGetName.argtypes = [S, P]
    cu.cuKernelGetName.argtypes = [S, P]
    cu.cuGraphGetEdges_v2.argtypes = [P, P, P, P, N]
    for fn in (cu.cuGraphGetNodes, cu.cuGraphNodeGetType,
               cu.cuGraphKernelNodeGetParams_v2, cu.cuFuncGetName,
               cu.cuKernelGetName, cu.cuGraphGetEdges_v2):
        fn.restype = ctypes.c_int

    def check(err: int) -> None:
        if err:
            raise RuntimeError(f"CUDA driver graph query failed (CUresult "
                               f"{err})")

    g = P(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)))
    nodes = (P * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)))
    kind, params, name = ctypes.c_int(), _KernelParams(), ctypes.c_char_p()
    kernels, named = 0, {}
    for node in nodes:
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        if kind.value != _NODE_KERNEL:
            continue
        kernels += 1
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)))
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), params.func))
        else:                # a kernel the driver loads lazily
            check(cu.cuKernelGetName(ctypes.byref(name), params.kern))
        wrapper = K.wrapper_of(name.value.decode())
        if wrapper is not None:
            named[wrapper] = named.get(wrapper, 0) + 1
    m = ctypes.c_size_t(0)
    check(cu.cuGraphGetEdges_v2(g, None, None, None, ctypes.byref(m)))
    if not m.value:                  # the driver refuses empty arrays
        return NodeCensus(kernels, 0, named)
    src, dst, data = (P * m.value)(), (P * m.value)(), (_EdgeData * m.value)()
    check(cu.cuGraphGetEdges_v2(g, src, dst, data, ctypes.byref(m)))
    return NodeCensus(kernels, sum(e.type == _EDGE_PROGRAMMATIC
                                   for e in data), named)
