"""Continuous-batching inference engine (counterpart of
``qmann_tpu/serve/engine.py``'s ``InferenceEngine``).

  * requests (stories + questions) enter a queue from any number of
    producer threads;
  * one dispatcher thread drains the queue, pads/masks up to a fixed batch
    shape, and runs ONE ``forward_prepared`` per wave on the engine's
    device, then ``argmax_last`` and a copy of the predictions to the host;
  * answers (dictionary indices) resolve each request's future.

The prepared weights are frozen onto the engine's device once; the engine
runs on the card unless the caller passes ``device="cpu"``.  The packet
front end (``serve/packet.py``, ``server.py``, ``client.py``) is not ported
yet.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.data import DataDims, Dictionary
from qmann_tpu_torch.device import resolve_device
from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.ops import argmax_last


@dataclasses.dataclass
class Request:
    sentences: List[List[str]]   # story (words)
    question: List[str]
    # explicit per-sentence temporal-encoding indices (absolute input
    # columns); None derives the default dim_dict + ns - j - 1
    te_indices: Optional[List[int]] = None
    future: "Future[int]" = dataclasses.field(default_factory=Future)


@dataclasses.dataclass
class EngineStats:
    """Per-engine wave counters."""
    waves: int = 0
    requests: int = 0
    vectorize_s: float = 0.0   # host BoW vectorization inside the dispatcher
    infer_s: float = 0.0       # forward + argmax + copy to host
    failed_waves: int = 0


class InferenceEngine:
    def __init__(self, params: Mapping[str, torch.Tensor], cfg: QmannConfig,
                 dims: DataDims, dictionary: Dictionary,
                 batch_size: int = 64, max_wait_ms: float = 2.0,
                 device="cuda"):
        self.cfg = cfg
        self.dims = dims
        self.dictionary = dictionary
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v, dtype=torch.float32)
                       .to(self.device) for k, v in params.items()}
        self._queue: "queue.Queue[Optional[Request]]" = queue.Queue()
        self.stats = EngineStats()
        # freeze weights into serving layout once per engine, exact-GEMM
        # route decided against the vectorizer's feature bounds (a row's
        # counts are word counts plus one temporal one-hot)
        self.prepared = memn2n.prepare_inference(
            self.params, cfg, max_count=float(dims.max_word + 1),
            max_rowsum=float(dims.max_word + 1))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = False

    # ------------------------------------------------------------------
    def start(self):
        self._running = True
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=10)

    def submit(self, sentences: Sequence[Sequence[str]],
               question: Sequence[str],
               te_indices: Optional[Sequence[int]] = None) -> "Future[int]":
        req = Request([list(s) for s in sentences], list(question),
                      list(te_indices) if te_indices is not None else None)
        self._queue.put(req)
        return req.future

    # ------------------------------------------------------------------
    def _vectorize(self, reqs: List[Request]):
        d = self.dims
        n = self.batch_size
        mem = np.zeros((n, d.max_line, d.dim_input), np.float32)
        que = np.zeros((n, d.dim_input), np.float32)
        mask = np.zeros((n, d.max_line), bool)
        en_time = self.cfg.en_time
        n_words = d.dim_word - 1 if en_time else d.dim_word
        for bi, r in enumerate(reqs):
            drop = max(0, len(r.sentences) - d.max_line)
            sents = r.sentences[drop:]
            te = r.te_indices[drop:] if r.te_indices is not None else None
            ns = len(sents)
            for j, sent in enumerate(sents):
                for w in sent[:n_words]:
                    idx = self.dictionary.lookup(w)
                    if idx >= 0:
                        mem[bi, j, idx] += 1.0
                if en_time:
                    if (te is not None and j < len(te)
                            and 0 <= te[j] < d.dim_input):
                        mem[bi, j, te[j]] = 1.0  # transmitted temporal enc.
                    else:
                        mem[bi, j, d.dim_dict + ns - j - 1] = 1.0
            mask[bi, :ns] = True
            for w in r.question[:n_words]:
                idx = self.dictionary.lookup(w)
                if idx >= 0:
                    que[bi, idx] += 1.0
        return mem, que, mask

    def infer(self, mem: np.ndarray, que: np.ndarray,
              mask: np.ndarray) -> np.ndarray:
        """One wave: vectorized batch -> predicted dictionary indices."""
        dev = self.device
        with torch.inference_mode():
            out = memn2n.forward_prepared(
                self.prepared, torch.from_numpy(mem).to(dev),
                torch.from_numpy(que).to(dev), torch.from_numpy(mask).to(dev),
                self.cfg)
            return argmax_last(out.logits, dim=-1).cpu().numpy()

    def _loop(self):
        while self._running:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            wave = [first]
            # continuous batching: drain whatever arrived, up to the wave
            deadline_passed = False
            while len(wave) < self.batch_size and not deadline_passed:
                try:
                    nxt = self._queue.get(timeout=self.max_wait)
                    if nxt is None:
                        deadline_passed = True
                        self._running = False
                    else:
                        wave.append(nxt)
                except queue.Empty:
                    deadline_passed = True
            try:
                t0 = time.perf_counter()
                mem, que, mask = self._vectorize(wave)
                t1 = time.perf_counter()
                preds = self.infer(mem, que, mask)
                t2 = time.perf_counter()
                self.stats.waves += 1
                self.stats.requests += len(wave)
                self.stats.vectorize_s += t1 - t0
                self.stats.infer_s += t2 - t1
            except Exception as exc:  # fail the wave, keep serving
                self.stats.failed_waves += 1
                for r in wave:
                    if not r.future.done():
                        r.future.set_exception(exc)
                continue
            for bi, r in enumerate(wave):
                r.future.set_result(int(preds[bi]))
