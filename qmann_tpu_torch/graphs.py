"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

JAX compiles each hot entry point into one device program: ``train_epoch``
(jit and ``lax.scan``), ``evaluate`` (jit), ``multi_epoch`` and
``multi_eval`` (jit and scans), the engine's ``_infer`` (jit) and bench.py's
30 dependent batches (jit and ``lax.scan``).  XLA does that work, so the
JAX package has no module for it.  Here those entry points capture their
body once with ``torch.cuda.graph`` and replay it: a step's, a chunk's or a
wave's launches leave the host as one graph launch.

A ``Graphs`` is one run's set of programs (a ``train_task`` or
``train_tasks_multi`` run, an engine, a tool's route), with one memory pool
that all of them share.  ``graphs(key, body, *inputs, bound=...)`` runs
``body(*inputs)``:

  * on the CPU, eagerly, at every call;
  * on the card, per key as jit keys its traces: the caller's static key
    (the body's name and its static arguments, such as the cfg and
    remove_softmax), the shapes and dtypes of ``inputs`` and the storage
    of every ``bound`` tensor:
      - the first call runs the body eagerly on the run's side stream,
        under torch's sync debug mode "error": it builds the kernels and
        fills the per-device constant caches, and a host sync in the body
        raises here, before any capture;
      - the second call captures the body on static copies of ``inputs``
        into a graph on the run's pool, then replays it;
      - every later call copies ``inputs`` into those buffers (``copy_``)
        and replays.
    Every call executes the body once.  A capture or replay error raises:
    nothing falls back to the eager route.  On a replay the outputs are
    returned as new tensors (clones), as a jitted call returns new arrays.

``bound`` are the tensors the body reads or updates in place by closure
(parameters, epoch buffers, a learning-rate tensor, step counters).  A
graph holds their addresses, so they must keep their storage: update them
in place, restore them with ``copy_``, never rebind them.  ``static`` gives
a run's persistent buffers.

Launch accounting.  Each kernel wrapper (``ops/cuda/*.py``) adds one to its
``.launches`` where it launches its kernel, on the name in its own module.
The lattice's wrapper also counts, in ``.sparse_launches``, the launches
that skip the zero entries of Q(x), and the chain's, in
``.embedded_launches``, the launches that embed the bag-of-words memory in
the kernel.  A
capture runs the wrappers but executes no kernel, so ``Graphs`` takes back
what the counts gained during the capture and a ``Graph`` adds that again
at every replay: the counts stay those of the kernels the card ran.

The sync debug mode is process-wide: while a warm-up runs, a host sync on
another thread raises too.

While a ``torch.profiler`` session records, each call on the card leaves
one of the spans ``graphs.warm_up``, ``graphs.capture`` (then
``graphs.replay`` of the new graph) or ``graphs.replay`` (the inputs'
``copy_``, the replay and its launch accounting), each with the key's
first item (``train_step``, ``evaluate``, ``infer``, ...) as its argument
(``utils/profiling.py::annotate``).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.utils.profiling import annotate

# where each kernel wrapper keeps its launch counts: (module, name, count);
# after the seven wrappers' launches, so that their indices hold, come the
# lattice's launches that skip the zero entries of Q(x), then the chain's
# launches that embed the memory themselves
COUNTED = (("qmann_tpu_torch.ops.cuda.qmatvec", "quantized_matvec",
            "launches"),
           ("qmann_tpu_torch.ops.cuda.attention_read", "fused_read",
            "launches"),
           ("qmann_tpu_torch.ops.cuda.hamming", "hamming_score_kernel",
            "launches"),
           ("qmann_tpu_torch.ops.cuda.hop_chain",
            "fused_hop_chain_from_memory", "launches"),
           ("qmann_tpu_torch.ops.cuda.hamming_bwd",
            "hamming_backward_kernel", "launches"),
           ("qmann_tpu_torch.ops.cuda.qweighted_sum_bwd",
            "qweighted_sum_backward_kernel", "launches"),
           ("qmann_tpu_torch.ops.cuda.qweighted_sum_bwd",
            "weighted_sum_softmax_backward_kernel", "launches"),
           ("qmann_tpu_torch.ops.cuda.qmatvec", "quantized_matvec",
            "sparse_launches"),
           ("qmann_tpu_torch.ops.cuda.hop_chain",
            "fused_hop_chain_from_memory", "embedded_launches"))


def without_fast_path(cfg: QmannConfig) -> QmannConfig:
    """cfg with the integer fast path off: its predicates are read on the
    host once per forward, which no graph can hold.  Bit-identical either
    way, by the fast path's contract; JAX's ``train_epoch`` compiles it out
    too."""
    return (cfg.replace(en_integer_fast_path=False)
            if cfg.en_integer_fast_path else cfg)


def _counters() -> List[Tuple[Callable, str]]:
    """(object, count) of each of ``COUNTED``, on the objects the wrappers'
    module names hold now."""
    import qmann_tpu_torch.ops.cuda  # noqa: F401  (loads the six modules)
    return [(getattr(sys.modules[m], n), a) for m, n, a in COUNTED]


def launch_counts() -> Tuple[int, ...]:
    """The wrappers' counts, in ``COUNTED``'s order."""
    return tuple(getattr(fn, a) for fn, a in _counters())


def _add_launches(delta: Sequence[int]) -> None:
    for (fn, a), d in zip(_counters(), delta):
        setattr(fn, a, getattr(fn, a) + d)


@contextlib.contextmanager
def launches_taken_back(delta: List[int]):
    """Around a capture: on exit ``delta`` holds what each count gained
    inside, and the counts are put back by as much."""
    before = launch_counts()
    try:
        yield delta
    finally:
        delta[:] = [a - b for a, b in zip(launch_counts(), before)]
        _add_launches([-d for d in delta])


@contextlib.contextmanager
def _sync_debug(mode):
    """torch's sync debug mode set to ``mode`` inside, put back after."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _clone(out):
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(_clone(t) for t in out)


class Graph:
    """One captured body: its graph (anything with ``replay()``), its
    static inputs and outputs, the launches each replay adds to the
    wrappers' counts, and the bound tensors it keeps alive."""

    def __init__(self, key: Hashable, graph, inputs: Sequence[torch.Tensor],
                 outputs, launches: Sequence[int],
                 bound: Sequence[torch.Tensor] = ()):
        self.key = key
        self.graph = graph
        self.inputs = tuple(inputs)
        self.outputs = outputs
        self.launches = tuple(launches)
        self.bound = tuple(bound)
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        _add_launches(self.launches)
        self.replays += 1


class Graphs:
    """One run's captured programs on ``device`` (see the module
    docstring); on the CPU every call runs its body eagerly."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[Hashable, Graph] = {}
        self._warm = set()
        self._static: Dict[Hashable, torch.Tensor] = {}
        self._pool = None
        self._stream = None

    def static(self, name: str, shape, dtype=torch.float32) -> torch.Tensor:
        """The run's persistent zeroed buffer ``name`` of this shape and
        dtype (the same tensor at every call): what a graph may bind."""
        key = (name, tuple(shape), dtype)
        buf = self._static.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = torch.zeros(tuple(shape), dtype=dtype,
                                  device=self.device)
            self._static[key] = buf
        return buf

    def __call__(self, key: Hashable, body: Callable, *inputs: torch.Tensor,
                 bound: Sequence[torch.Tensor] = ()):
        if self.device.type != "cuda":
            return body(*inputs)
        full = (key, tuple((tuple(t.shape), t.dtype) for t in inputs),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in bound))
        graph = self.graphs.get(full)
        if graph is None:
            if full not in self._warm:
                self._warm.add(full)
                with annotate("graphs.warm_up", key[0]):
                    return self._warm_up(body, inputs)
            with annotate("graphs.capture", key[0]):
                graph = self.graphs[full] = self._capture(full, body, inputs,
                                                          bound)
            with annotate("graphs.replay", key[0]):
                graph.replay()
        else:
            with annotate("graphs.replay", key[0]):
                for buf, t in zip(graph.inputs, inputs):
                    if buf is not t:
                        buf.copy_(t)
                graph.replay()
        return _clone(graph.outputs)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm_up(self, body, inputs):
        side = self._side_stream()
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(side), \
                _sync_debug("error"):
            out = body(*inputs)
        main.wait_stream(side)
        return out

    def _capture(self, full, body, inputs, bound) -> Graph:
        side = self._side_stream()
        with torch.inference_mode(False):
            static_in = tuple(t.clone() for t in inputs)
        graph = torch.cuda.CUDAGraph()
        delta: List[int] = []
        # the capture synchronizes first: no sync debug inside it
        with torch.cuda.device(self.device), _sync_debug(0), \
                launches_taken_back(delta), \
                torch.cuda.graph(graph, pool=self._pool, stream=side,
                                 capture_error_mode="thread_local"):
            out = body(*static_in)
        return Graph(full[0], graph, static_in, out, delta, bound)
