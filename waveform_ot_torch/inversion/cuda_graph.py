"""One model's misfit and gradient on the card, replayed as a CUDA graph.

An L-BFGS loop asks for one model's value and gradient, waits for them, and
only then asks again. Eager, such a call is some 2,500 small launches issued
one by one from Python, and the card idles between them. For one model
(``ms`` of shape (nm,) or (1, nm)) on a CUDA device,
:func:`waveform_ot_torch.inversion.loc_cmt_value_and_grad` therefore runs
the whole call as one replay of a captured graph: the forward physics, the
arctan transform, the fingerprint with its distance-field kernel, the
marginals and the 1-D W2, and the backward pass to the model. A replay
copies the model into the graph's input, replays, and returns clones of
the graph's value and gradient, with no host synchronization of its own.

What stays eager is decided from the inputs before anything runs
(:func:`engages`): a batch of models (a held graph pool is no bargain for
a throughput-bound batch), CPU tensors, inference mode, and a call made
while the current stream captures. A forward passed for one model on the
card must, once it has run, copy no host data to the device and read
nothing back, as the port's forwards do: the capture refuses both.

A graph reads the tensors it was captured with at their addresses, so its
key (:func:`key`) is what it reads: the address, shape, stride and dtype
of every tensor of the problem, the forward (held by the graph, and for a
module its parameters and buffers as the problem's), the options, the
trace configuration, the model's shape, dtype and device, and the matmul
and determinism settings that pick the captured kernels. A problem rebuilt
over the same buffers (``LocCMTObjective.tree()``) finds its graph; a
problem whose tensors moved is another key.

The first call of a key runs eagerly on a side stream, which warms up
cuFFT's plans, cuBLAS and autograd and is the call's answer, and then
captures. A caller whose problem moves on every call would capture on
every call: while a graph of the same shapes has not been replayed yet, a
new key runs eagerly and captures only if it comes again. At most
:data:`MAX_GRAPHS` graphs are kept, each with its own memory pool, the
least recently used dropped first.

Each graph's kernel nodes are counted once, at capture, from the graph the
capture recorded (the CUDA driver's ``cuGraphGetNodes`` and
``cuGraphNodeGetType``), and kept beside the number of its model's
parameters (:func:`graphs`); a replay counts nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Callable

import torch

from waveform_ot_torch.ops import cuda_distance

CALLS = {"captures": 0, "replays": 0, "eager": 0}
"""Single-model value+grad calls on the card in this process: graphs
captured, graph replays, and calls run eagerly (the first call of each
key, which also captures, among them)."""
MAX_GRAPHS = 8
"""Graphs kept at once; each holds a private memory pool."""
MAX_SEEN = 64
"""Keys remembered as run once without a capture."""

_LOCK = threading.Lock()
_GRAPHS: OrderedDict = OrderedDict()   # key -> _Graph, least recently used first
_SEEN: OrderedDict = OrderedDict()     # key -> None
_STREAMS: dict = {}                    # device -> the side stream of warm-up and capture
_PLAIN = (type(None), bool, int, float, str)
_KERNEL_NODE = 0                       # CU_GRAPH_NODE_TYPE_KERNEL


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    ms: torch.Tensor        # the static input
    value: torch.Tensor     # the static outputs
    grad: torch.Tensor
    launches: int           # distance-field launches the graph holds
    kernels: int            # kernel nodes the graph holds
    shapes: tuple           # the key without the addresses
    forward: Callable | None   # held, so that its id in the key stays its own
    replays: int = 0


def graphs() -> list[dict]:
    """The graphs held, least recently used first: each one's number of
    model parameters (``params``), the kernel nodes it holds (``kernels``,
    counted at capture) and its ``replays``."""
    with _LOCK:
        return [{"params": g.ms.shape[-1], "kernels": g.kernels, "replays": g.replays}
                for g in _GRAPHS.values()]


def engages(ms) -> bool:
    """Whether a call with models ``ms`` takes the graph path: one model on
    a CUDA device, outside inference mode, on a stream that is not
    capturing."""
    return (isinstance(ms, torch.Tensor) and ms.is_cuda
            and (ms.dim() == 1 or (ms.dim() == 2 and ms.shape[0] == 1))
            and not torch.is_inference_mode_enabled()
            and not torch.cuda.is_current_stream_capturing())


def _walk(node, shapes: list, addrs: list) -> bool:
    """Append the shapes and addresses of ``node``'s tensors; False if a
    leaf is neither a tensor, a tuple nor a plain value."""
    if isinstance(node, torch.Tensor):
        shapes.append((tuple(node.shape), node.stride(), node.dtype, node.device))
        addrs.append(node.data_ptr())
        return True
    if isinstance(node, tuple):
        shapes.append((type(node), len(node)))
        return all(_walk(v, shapes, addrs) for v in node)
    shapes.append(node)
    return isinstance(node, _PLAIN)


def key(ms, prob, opts, cfg, forward) -> tuple | None:
    """(shapes, addresses): the key of a graph for this call, or None when
    the problem holds a leaf that cannot be keyed (the call stays eager)."""
    shapes = [(tuple(ms.shape), ms.dtype, ms.device), opts, cfg,
              torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled(),
              id(forward)]
    addrs: list = []
    state = (tuple(forward.parameters()) + tuple(forward.buffers())
             if isinstance(forward, torch.nn.Module) else ())
    if not (_walk(prob, shapes, addrs) and _walk(state, shapes, addrs)):
        return None
    return tuple(shapes), tuple(addrs)


def value_and_grad(fn: Callable, ms, prob, opts, cfg, forward):
    """``fn(ms, prob, opts, cfg, forward)`` -> (value, gradient) for one
    model on the card (:func:`engages`), by replay where its key has a
    graph, else eagerly (capturing as the module docstring says)."""
    k = key(ms, prob, opts, cfg, forward)
    with _LOCK:
        entry = None if k is None else _GRAPHS.get(k)
        if entry is not None:
            _GRAPHS.move_to_end(k)
            return _replay(entry, ms)
        if k is not None and (k in _SEEN or not any(
                g.shapes == k[0] and g.replays == 0 for g in _GRAPHS.values())):
            _SEEN.pop(k, None)
            return _capture(fn, k, ms, prob, opts, cfg, forward)
        if k is not None:
            _SEEN[k] = None
            while len(_SEEN) > MAX_SEEN:
                _SEEN.popitem(last=False)
        CALLS["eager"] += 1
    return fn(ms, prob, opts, cfg, forward)


def _replay(entry: _Graph, ms):
    entry.ms.copy_(ms.detach())
    # no profiler span here: its device-side copy would cover the replay's
    # idle gaps, and a trace's busy time with them; a trace shows each replay
    # as its cudaGraphLaunch call
    entry.graph.replay()
    entry.replays += 1
    CALLS["replays"] += 1
    cuda_distance.count_launch(ms.device, entry.launches)
    return entry.value.clone(), entry.grad.clone()


def _capture(fn, k, ms, prob, opts, cfg, forward):
    """The call eagerly on the device's side stream (its answer), then its
    capture there into a new graph."""
    device = ms.device
    with torch.cuda.device(device):
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        side = _STREAMS[device]
        here = torch.cuda.current_stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            value, grad = fn(ms, prob, opts, cfg, forward)
        here.wait_stream(side)
        for t in (value, grad):
            t.record_stream(here)
        static = ms.detach().clone()
        before = cuda_distance.LAUNCHES_BY_DEVICE.get(str(device), 0)
        # kept, so that its nodes can be counted before it is instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            out = fn(static, prob, opts, cfg, forward)
        # a capture records the launches and runs none of them
        held = cuda_distance.LAUNCHES_BY_DEVICE.get(str(device), 0) - before
        cuda_distance.count_launch(device, -held)
        kernels = kernel_nodes(graph)
        graph.instantiate()
    _GRAPHS[k] = _Graph(graph, static, *out, launches=held, kernels=kernels, shapes=k[0],
                        forward=forward)
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    CALLS["captures"] += 1
    CALLS["eager"] += 1
    return value, grad


@functools.cache
def _driver():
    """The CUDA driver library, with the prototypes of the calls used here."""
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    drv.cuGraphGetNodes.restype = drv.cuGraphNodeGetType.restype = ctypes.c_int
    return drv


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"{call} failed with CUresult {status}")


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of ``graph``, captured with ``keep_graph=True``: a
    stream capture records each kernel launch as one."""
    drv = _driver()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(drv.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, count = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        _check(drv.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        count += kind.value == _KERNEL_NODE
    return count


def clear() -> None:
    """Drop every graph and remembered key (their pools go back to the
    caching allocator)."""
    with _LOCK:
        _GRAPHS.clear()
        _SEEN.clear()
