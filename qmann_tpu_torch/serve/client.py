"""Packet-stream client (counterpart of ``qmann_tpu/serve/client.py``) —
the host side of the reference's FPGA offload (stream_write/stream_read
threads, MemN2N/MemN2N.c:3200-3289) pointed at the TCP server instead of
the Xillybus character devices.

    from qmann_tpu_torch.serve.client import PacketClient
    with PacketClient("127.0.0.1", 8765) as c:
        answers = c.query_samples(indexed_samples)

Also usable as a CLI that streams a task's test split and reports the
error rate exactly like stream_read (MemN2N.c:3273-3284):

    python -m qmann_tpu_torch.serve.client --task 1 --host 127.0.0.1
        --port 8765 [--limit 100] [--data-path DIR --raw-data-path DIR]
"""
from __future__ import annotations

import argparse
import socket
import sys
from typing import List, Sequence

from qmann_tpu_torch.serve.packet import (
    IndexedSample, decode_response, encode_sample,
)


class PacketClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 timeout: float = 600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._sock.close()

    def query_samples(self, samples: Sequence[IndexedSample]) -> List[int]:
        """Stream samples, collect one answer index per sample in order
        (the writer/reader thread pair of the reference collapsed into a
        single send-then-drain exchange)."""
        payload = b"".join(encode_sample(s) for s in samples)
        self._sock.sendall(payload)
        want = 2 * len(samples)
        got = b""
        while len(got) < want:
            chunk = self._sock.recv(4096)
            if not chunk:
                # the reference's stream_read blocks until NUM_TEST answer
                # packets arrive (MemN2N.c:3273-3284); a short stream means
                # the server died — surface it, never report a partial
                # error rate as if it covered every sample
                raise ConnectionError(
                    f"server closed after {len(got) // 2} of "
                    f"{len(samples)} answers")
            got += chunk
        return decode_response(got[:want])


def samples_from_split(split, dims) -> List[IndexedSample]:
    """Convert a VectorizedSplit back into index streams (what the
    reference's sample_vectorization EN_SAMPLE_BIN_OUT path produces,
    MemN2N/sample.c:576-687)."""
    import numpy as np
    out = []
    for si in range(len(split)):
        ns = int(split.n_sen[si])
        sentences, te = [], []
        for j in range(ns):
            row = split.memory[si, j]
            word_part = row[:dims.dim_dict]
            words = [int(i) for i in np.nonzero(word_part)[0]
                     for _ in range(int(word_part[i]))]
            sentences.append(words)
            te_part = np.nonzero(row[dims.dim_dict:])[0]
            te.append(int(dims.dim_dict + te_part[0]) if len(te_part)
                      else dims.dim_dict)
        q_row = split.question[si]
        question = [int(i) for i in np.nonzero(q_row[:dims.dim_dict])[0]
                    for _ in range(int(q_row[i]))]
        out.append(IndexedSample(sentences, te, question,
                                 [int(split.answer_index[si])]))
    return out


def build_parser() -> argparse.ArgumentParser:
    from qmann_tpu_torch.config import QmannConfig

    defaults = QmannConfig()
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.serve.client")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--data-path", default=defaults.data_path)
    p.add_argument("--raw-data-path", default=defaults.raw_data_path)
    return p


def main(argv=None) -> int:
    from qmann_tpu_torch.config import BABI_TASKS
    from qmann_tpu_torch.data.native import load_task_native

    args = build_parser().parse_args(argv)
    data = load_task_native(BABI_TASKS[args.task - 1], args.data_path,
                            raw_path=args.raw_data_path,
                            limit_test=args.limit)
    samples = samples_from_split(data.test, data.dims)
    with PacketClient(args.host, args.port) as client:
        answers = client.query_samples(samples)
    matches = sum(int(a == int(data.test.answer_index[i]))
                  for i, a in enumerate(answers))
    err = 1.0 - matches / max(len(answers), 1)
    print(f"streamed {len(samples)} samples; err_test = {err:f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
