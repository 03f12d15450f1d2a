"""TCP packet-stream server (counterpart of ``qmann_tpu/serve/server.py``)
— the Xillybus FIFO endpoints (/dev/xillybus_write_16 and
/dev/xillybus_read_16, MemN2N/MemN2N.c:2275) replaced by a socket: clients
stream samples in the 16-bit packet format (``serve/packet.py``) and
receive one answer packet per sample, in order.

    python -m qmann_tpu_torch.serve.server --checkpoint <dir> --port 8765
        [--host 127.0.0.1] [--batch-size 64] [--device cuda]

The handler threads only decode packets and enqueue samples: every CUDA
call is made by the engine's one dispatcher thread.  ``--port 0`` binds a
free port; the line "serving on HOST:PORT" names the one bound.  The route
(``use_fused_chain``, ``use_pallas``, ...) comes from the checkpoint's
config, so a checkpoint saved with ``use_fused_chain`` serves through the
chain kernel.  The engine runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import socketserver
import sys
import threading

from qmann_tpu_torch.serve.engine import InferenceEngine
from qmann_tpu_torch.serve.packet import PacketDecoder, encode_response


class PacketHandler(socketserver.BaseRequestHandler):
    def handle(self):
        engine: InferenceEngine = self.server.engine  # type: ignore
        decoder = PacketDecoder()
        pending = []
        lock = threading.Lock()
        done = threading.Event()

        def flusher():
            # answers return in submission order, one packet per sample
            # (the stream_read contract, MemN2N/MemN2N.c:3273-3284).
            # A failed wave must not break the one-packet-per-sample
            # framing: failed samples answer with the NULL index (0).
            while not done.is_set() or pending:
                with lock:
                    fut = pending.pop(0) if pending else None
                if fut is None:
                    done.wait(0.005)
                    continue
                try:
                    answer = fut.result(600)
                except Exception:
                    answer = 0  # NULL word — the protocol has no error code
                try:
                    self.request.sendall(encode_response(answer))
                except (BrokenPipeError, ConnectionResetError):
                    return

        t = threading.Thread(target=flusher, daemon=True)
        t.start()
        try:
            while True:
                data = self.request.recv(4096)
                if not data:
                    break
                for sample in decoder.feed(data):
                    fut = engine.submit_indexed(sample)
                    with lock:
                        pending.append(fut)
        finally:
            done.set()
            t.join(timeout=120)


class PacketServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    # a client that keeps its connection open must not hold server_close()
    daemon_threads = True

    def __init__(self, addr, engine: InferenceEngine):
        super().__init__(addr, PacketHandler)
        self.engine = engine


def serve(engine: InferenceEngine, host: str = "127.0.0.1",
          port: int = 8765) -> PacketServer:
    """A PacketServer in front of a started engine, serving from a daemon
    thread; the caller ends it with ``shutdown()`` and ``server_close()``
    (``server_address`` holds the bound port, for ``port=0``)."""
    server = PacketServer((host, port), engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.serve.server")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from qmann_tpu_torch.data import DataDims, Dictionary
    from qmann_tpu_torch.models.memn2n import params_from_jax
    from qmann_tpu_torch.utils.checkpoint import load_checkpoint

    params, cfg, dims_dict = load_checkpoint(args.checkpoint)
    # the dictionary travels next to the checkpoint
    dict_path = os.path.join(args.checkpoint, "dictionary.json")
    dictionary = Dictionary()
    if os.path.exists(dict_path):
        with open(dict_path) as f:
            for w in json.load(f)[1:]:
                dictionary.add(w)
    engine = InferenceEngine(
        params_from_jax(params, cfg, device=args.device), cfg,
        DataDims(**dims_dict), dictionary, batch_size=args.batch_size,
        device=args.device).start()
    try:
        server = PacketServer((args.host, args.port), engine)
        host, port = server.server_address[:2]
        print(f"serving on {host}:{port}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
