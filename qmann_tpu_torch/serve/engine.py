"""Continuous-batching inference engine (counterpart of
``qmann_tpu/serve/engine.py``'s ``InferenceEngine``).

  * requests (stories + questions) enter a queue from any number of
    producer threads, as words (``submit``) or as dictionary indices from
    the packet stream (``submit_indexed``, fed by ``serve/server.py``);
  * one dispatcher thread drains the queue, pads/masks up to a fixed batch
    shape, and runs ONE forward per wave on the engine's device, then
    ``argmax_last`` and a copy of the predictions to the host; every CUDA
    call of the engine is made on that thread;
  * answers (dictionary indices) resolve each request's future.

With ``prepare=True`` (the default) the weights are frozen into serving
layout once (``prepare_inference``) and each wave runs
``forward_prepared``; ``prepare=False`` runs the training ``forward`` on
the raw weights (under ``use_pallas``, the lattice and read kernels), the
A/B baseline of ``bench/engine_bench.py``.  On the card a wave replays one
captured CUDA graph of that forward and ``argmax_last`` at the engine's
fixed padded batch (``graphs.py``; JAX jits its ``_infer``), with the
integer fast path off (bit-identical either way).  The engine runs on the
card unless the caller passes ``device="cpu"``.

With ``mesh=`` (``parallel/mesh.py``) every rank builds the engine alike
and calls ``start`` and ``stop``.  As in JAX, the mesh pins the plain
prepared forward (``parallel.sharding.serving_config``).  Rank 0 owns the
queue: for each wave it broadcasts the padded wave arrays, every rank
computes its block of the wave (the batch over "data", the memory over
"model", ``parallel.sharding.sharded_predict``) and the predictions come
back whole.  The other ranks run a follower loop until rank 0's engine
thread broadcasts the end, which it does when ``stop`` ends its loop.

On a mesh of more than one rank a wave that fails once it was broadcast
ends the engine on every rank: after each wave the ranks agree on a
status word (one all_reduce), so a failure on any rank stops every loop
at the same wave; rank 0 fails that wave's futures, those still queued
and those submitted later, and ``error`` holds the cause on every rank.
A wave that fails before its broadcast (in the vectorizer) fails alone,
as off a mesh.  A rank that fails between two of a wave's collectives
leaves the others inside one: their loops end when that collective
raises, at the peer's exit or after ``mesh_timeout``.  The wave's
broadcast and status word run on a group of the engine's own with that
timeout (default ``MESH_TIMEOUT``, 60 s; under NCCL its watchdog aborts
the group after it), and rank 0 broadcasts an idle tick every quarter of
it while no wave comes, so that the followers' wait for the next wave is
never the one that times out.  The sharded forward's own collectives run
on the mesh's groups, with the timeout ``make_mesh`` gave them.  A mesh
wave runs eagerly: no graph spans ranks.

While a ``torch.profiler`` session records, the engine's thread leaves
spans (``utils/profiling.py::annotate``): ``engine.idle`` (waiting for a
wave's first request), ``engine.fill`` (from that request until the wave
closes) and ``engine.wave`` (from the close until the wave's last future
is resolved), the wave's with the children ``engine.vectorize``,
``engine.upload`` (the host-to-device copies), ``engine.replay`` (the
graph, or the eager or mesh forward), ``engine.readback`` (the copy to the
host, which waits for the device) and ``engine.resolve`` (the futures'
results and callbacks).  A request submitted then is stamped, and its wait
from ``submit`` to its wave's close is kept as ``engine.queue_wait_s``.
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.data import DataDims, Dictionary
from qmann_tpu_torch.device import resolve_device
from qmann_tpu_torch.graphs import Graphs, without_fast_path
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.ops import argmax_last
from qmann_tpu_torch.serve.packet import IndexedSample
from qmann_tpu_torch.utils.profiling import annotate, observe, stamp

# the bound on each collective of a mesh engine's waves
MESH_TIMEOUT = datetime.timedelta(seconds=60)
# the header rank 0 broadcasts before each wave: the end, a wave, an idle
# tick
_END, _WAVE, _IDLE = 0.0, 1.0, 2.0


@dataclasses.dataclass
class Request:
    sentences: List[list]   # story: words, or dictionary indices if indexed
    question: list
    # explicit per-sentence temporal-encoding indices (absolute input
    # columns); None derives the default dim_dict + ns - j - 1
    te_indices: Optional[List[int]] = None
    future: "Future[int]" = dataclasses.field(default_factory=Future)
    indexed: bool = False   # sentences and question hold dictionary indices
    # when it was submitted, while a profiler records (profiling.stamp)
    queued_at: Optional[float] = None


@dataclasses.dataclass
class EngineStats:
    """Per-engine wave counters, always on (bench/engine_bench.py and the
    benchmark's engine cell read these)."""
    waves: int = 0
    requests: int = 0
    vectorize_s: float = 0.0   # host BoW vectorization inside the dispatcher
    infer_s: float = 0.0       # forward + argmax + copy to host
    failed_waves: int = 0

    def snapshot(self) -> Dict:
        return dataclasses.asdict(self)


class InferenceEngine:
    def __init__(self, params: Mapping[str, torch.Tensor], cfg: QmannConfig,
                 dims: DataDims, dictionary: Dictionary,
                 batch_size: int = 64, max_wait_ms: float = 2.0,
                 prepare: bool = True, mesh=None, device="cuda",
                 mesh_timeout: datetime.timedelta = MESH_TIMEOUT):
        if mesh is not None:
            from qmann_tpu_torch.parallel.sharding import serving_config
            cfg = serving_config(cfg)
        self.mesh = mesh
        self.cfg = cfg
        self.dims = dims
        self.dictionary = dictionary
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.params = {k: torch.as_tensor(v, dtype=torch.float32)
                       .to(self.device) for k, v in params.items()}
        self._queue: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._lock = threading.Lock()   # error vs. enqueueing a request
        self.error: Optional[BaseException] = None   # what ended a mesh
        self.stats = EngineStats()
        # freeze weights into serving layout once per engine, exact-GEMM
        # route decided against the vectorizer's feature bounds (a row's
        # counts are word counts plus one temporal one-hot); prepare=False
        # keeps the training forward, as JAX's engine does
        self.prepared = memn2n.prepare_inference(
            self.params, cfg, max_count=float(dims.max_word + 1),
            max_rowsum=float(dims.max_word + 1)) if prepare else None
        self._multi = mesh is not None and mesh.world > 1
        self._group = None
        if self._multi:
            import torch.distributed as dist
            # made alike on every rank, as the engine is
            self._group = dist.new_group(list(range(mesh.world)),
                                         timeout=mesh_timeout)
        self._idle_s = mesh_timeout.total_seconds() / 4
        self._last_head = time.monotonic()
        # the unsharded wave's program, and what it reads by closure
        self._graphs = Graphs(self.device)
        self._graph_cfg = without_fast_path(cfg)
        self._bound = list(self.params.values()) + [
            t for t in self.prepared or () if isinstance(t, torch.Tensor)]
        leader = mesh is None or mesh.rank == 0
        self._thread = threading.Thread(
            target=self._lead if leader else self._follow, daemon=True)
        self._running = False

    # ------------------------------------------------------------------
    def start(self):
        self._running = True
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 600.0):
        """End the engine's thread and wait for it up to ``timeout``
        seconds (None: without a limit).  On rank 0 (or off a mesh) this
        ends the loop after the wave in hand, and on a mesh the thread then
        broadcasts the end; on the other ranks it waits for that end, or
        for a failed wave.  Raises TimeoutError if the thread still runs."""
        if self.mesh is None or self.mesh.rank == 0:
            self._running = False
            self._queue.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the engine's thread still runs after "
                               f"{timeout} s (rank "
                               f"{self.mesh.rank if self.mesh else 0})")

    def _enqueue(self, req: Request) -> "Future[int]":
        req.queued_at = stamp()
        with self._lock:
            if self.error is not None:
                req.future.set_exception(self.error)
            else:
                self._queue.put(req)
        return req.future

    def submit(self, sentences: Sequence[Sequence[str]],
               question: Sequence[str],
               te_indices: Optional[Sequence[int]] = None) -> "Future[int]":
        req = Request([list(s) for s in sentences], list(question),
                      list(te_indices) if te_indices is not None else None)
        return self._enqueue(req)

    def submit_indexed(self, sample: IndexedSample) -> "Future[int]":
        """Accept a packet-stream sample (already word indices), vectorized
        straight from its indices.  The answers equal JAX's, whose engine
        maps the indices to words and back: an index outside the
        dictionary is dropped before the truncation to the row's words, and
        the temporal-encoding indices transmitted in the TYPE_*_SEN_DONE
        packets are honored as-is (the reference streams them verbatim,
        MemN2N/sample.c:607-620)."""
        req = Request([list(s) for s in sample.sentences],
                      list(sample.question), list(sample.te_indices),
                      indexed=True)
        return self._enqueue(req)

    def answer_word(self, index: int) -> str:
        return self.dictionary.words[index]

    # ------------------------------------------------------------------
    def _vectorize(self, reqs: List[Request]):
        d = self.dims
        n = self.batch_size
        mem = np.zeros((n, d.max_line, d.dim_input), np.float32)
        que = np.zeros((n, d.dim_input), np.float32)
        mask = np.zeros((n, d.max_line), bool)
        en_time = self.cfg.en_time
        n_words = d.dim_word - 1 if en_time else d.dim_word
        n_dict = len(self.dictionary)

        def indices(r, words):
            """A row's dictionary indices, as JAX's engine counts them: an
            unknown word is dropped after the truncation, an index outside
            the dictionary before it (JAX drops it on the way to words)."""
            if r.indexed:
                return [i for i in words if 0 <= i < n_dict][:n_words]
            return [i for i in map(self.dictionary.lookup, words[:n_words])
                    if i >= 0]

        for bi, r in enumerate(reqs):
            drop = max(0, len(r.sentences) - d.max_line)
            sents = r.sentences[drop:]
            te = r.te_indices[drop:] if r.te_indices is not None else None
            ns = len(sents)
            for j, sent in enumerate(sents):
                for idx in indices(r, sent):
                    mem[bi, j, idx] += 1.0
                if en_time:
                    if (te is not None and j < len(te)
                            and 0 <= te[j] < d.dim_input):
                        mem[bi, j, te[j]] = 1.0  # transmitted temporal enc.
                    else:
                        mem[bi, j, d.dim_dict + ns - j - 1] = 1.0
            mask[bi, :ns] = True
            for idx in indices(r, r.question):
                que[bi, idx] += 1.0
        return mem, que, mask

    def infer(self, mem: np.ndarray, que: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        """One wave: vectorized batch -> predicted dictionary indices."""
        dev = self.device
        with annotate("engine.upload"):
            batch = (torch.from_numpy(mem).to(dev),
                     torch.from_numpy(que).to(dev),
                     torch.from_numpy(mask).to(dev))
        if self.mesh is not None:
            if self._multi:
                batch = self._broadcast_wave(batch)[1]
            return self._wave_on_mesh(lambda: self._read(
                self._infer_sharded, batch))
        return self._read(lambda *b: self._graphs(
            ("infer", self._graph_cfg), self._predict, *b,
            bound=self._bound), batch)

    @staticmethod
    def _read(forward, batch) -> np.ndarray:
        """The wave's forward on the device, then its predictions on the
        host."""
        with annotate("engine.replay"):
            pred = forward(*batch)
        with annotate("engine.readback"):
            return pred.cpu().numpy()

    def _predict(self, mem, que, mask) -> torch.Tensor:
        """The wave's program: the forward and argmax_last, on the
        device."""
        cfg = self._graph_cfg
        with torch.inference_mode():
            if self.prepared is not None:
                out = memn2n.forward_prepared(self.prepared, mem, que, mask,
                                              cfg)
            else:
                out = memn2n.forward(self.params, mem, que, mask, cfg)
            return argmax_last(out.logits, dim=-1)

    def _infer_sharded(self, mem, que, mask) -> torch.Tensor:
        from qmann_tpu_torch.parallel.sharding import sharded_predict
        model = self.prepared if self.prepared is not None else self.params
        return sharded_predict(model, mem, que, mask, self.cfg, self.mesh)

    def _broadcast_wave(self, batch, head: float = _WAVE):
        """Rank 0's header (``_END``, ``_WAVE`` or ``_IDLE``; the other
        ranks pass anything) and, for a wave, its arrays (mem, que, mask)
        to every rank as one float32 buffer.  Returns (the header, the
        wave or None)."""
        import torch.distributed as dist
        d, n = self.dims, self.batch_size
        sizes = (n * d.max_line * d.dim_input, n * d.dim_input,
                 n * d.max_line)
        h = torch.tensor([head], device=self.device)
        dist.broadcast(h, 0, group=self._group)
        self._last_head = time.monotonic()
        head = h.item()
        if head != _WAVE:
            return head, None
        if batch is None:
            buf = torch.empty(sum(sizes), device=self.device)
        else:
            buf = torch.cat([t.reshape(-1).to(torch.float32) for t in batch])
        dist.broadcast(buf, 0, group=self._group)
        mem, que, mask = torch.split(buf, sizes)
        return head, (mem.view(n, d.max_line, d.dim_input),
                      que.view(n, d.dim_input),
                      mask.view(n, d.max_line).to(torch.bool))

    def _wave_on_mesh(self, compute):
        """Run this rank's part of a broadcast wave, then (on a mesh of
        more than one rank) agree with the others whether every rank's
        part ran: raises on every rank if any one failed."""
        error = None
        try:
            out = compute()
        except Exception as exc:  # noqa: BLE001 - shared, then re-raised
            error = exc
        if self._multi:
            import torch.distributed as dist
            failed = torch.tensor([float(error is not None)],
                                  device=self.device)
            dist.all_reduce(failed, op=dist.ReduceOp.MAX, group=self._group)
            if failed.item() and error is None:
                error = RuntimeError("the wave failed on another rank of "
                                     "the mesh")
        if error is not None:
            raise error
        return out

    def _follow(self):
        """A mesh rank other than 0: compute its block of every wave rank 0
        broadcasts, until the end or a failed wave (``error``)."""
        try:
            while True:
                head, batch = self._broadcast_wave(None)
                if head == _END:
                    break
                if head == _WAVE:
                    self._wave_on_mesh(lambda: self._infer_sharded(*batch))
        except Exception as exc:  # noqa: BLE001 - the mesh's engine ends
            self.error = exc

    def _lead(self):
        """Rank 0's thread (or the only one): serve until ``stop``; on a
        mesh then broadcast the end, unless a failed wave ended every
        rank's loop already."""
        self._loop()
        if self._multi and self.error is None:
            self._broadcast_wave(None, _END)

    def _close(self, exc: BaseException) -> None:
        """A failed wave on a mesh: fail what is queued and whatever is
        submitted from now on."""
        with self._lock:
            self.error = exc
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                if r is not None and not r.future.done():
                    r.future.set_exception(exc)

    def _fail_wave(self, wave: List[Request], exc: BaseException) -> None:
        self.stats.failed_waves += 1
        for r in wave:
            if not r.future.done():
                r.future.set_exception(exc)

    def _loop(self):
        while self._running:
            try:
                with annotate("engine.idle"):
                    first = self._queue.get(timeout=0.1)
            except queue.Empty:
                if (self._multi
                        and time.monotonic() - self._last_head > self._idle_s):
                    try:
                        self._broadcast_wave(None, _IDLE)
                    except Exception as exc:  # noqa: BLE001 - a peer is gone
                        self._close(exc)
                        break
                continue
            if first is None:
                break
            with annotate("engine.fill"):
                wave = self._fill(first)
            closed = stamp()
            if closed is not None:
                for r in wave:
                    if r.queued_at is not None:
                        observe("engine.queue_wait_s", closed - r.queued_at)
            with annotate("engine.wave", self.stats.waves):
                if not self._run_wave(wave):
                    break

    def _fill(self, first: Request) -> List[Request]:
        """Continuous batching: the wave from its first request, draining
        whatever arrives up to the wave's size while no gap between
        arrivals exceeds ``max_wait`` (the end ends the wave, and the
        loop after it)."""
        wave = [first]
        while len(wave) < self.batch_size:
            try:
                nxt = self._queue.get(timeout=self.max_wait)
            except queue.Empty:
                break
            if nxt is None:
                self._running = False
                break
            wave.append(nxt)
        return wave

    def _run_wave(self, wave: List[Request]) -> bool:
        """Vectorize, infer and resolve one wave; a failed wave fails its
        futures.  False when the loop must end (a failed wave on a mesh of
        more than one rank)."""
        try:
            t0 = time.perf_counter()
            with annotate("engine.vectorize"):
                mem, que, mask = self._vectorize(wave)
        except Exception as exc:  # fail the wave, keep serving
            self._fail_wave(wave, exc)
            return True
        try:
            t1 = time.perf_counter()
            preds = self.infer(mem, que, mask)
            t2 = time.perf_counter()
            self.stats.waves += 1
            self.stats.requests += len(wave)
            self.stats.vectorize_s += t1 - t0
            self.stats.infer_s += t2 - t1
        except Exception as exc:
            self._fail_wave(wave, exc)
            if self._multi:   # broadcast: every rank's loop ends
                self._close(exc)
                return False
            return True       # fail the wave, keep serving
        with annotate("engine.resolve"):
            for bi, r in enumerate(wave):
                r.future.set_result(int(preds[bi]))
        return True
