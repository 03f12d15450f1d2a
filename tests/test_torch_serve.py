"""The port's packet front end against the JAX package's on the CPU: the
packet codec byte for byte, the incremental decoder, samples_from_split,
the engine's submit and submit_indexed answers (modes 2 and 3, prepared
and not, with the packet stream's edge cases), EngineStats.snapshot, and
the TCP server and client end to end, within the port and across the two
packages in both directions.

Tolerance: none.  Bytes, vectorized batches and answers are compared for
equality (the engines' forwards are the JAX functions' counterparts,
held to equal predictions in tests/test_torch_engine.py).

Every socket test binds port 0, gives its sockets a timeout, shuts its
server down in ``finally`` and stops its engines; a per-test deadline ends
a stuck test's process instead of the suite.
"""
import dataclasses
import faulthandler
import json
import re
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from qmann_tpu.config import QmannConfig as JaxConfig  # noqa: E402
from qmann_tpu.data import babi as jbabi  # noqa: E402
from qmann_tpu.models import memn2n as jmodel  # noqa: E402
from qmann_tpu.serve import client as jclient  # noqa: E402
from qmann_tpu.serve import engine as jengine  # noqa: E402
from qmann_tpu.serve import packet as jpacket  # noqa: E402
from qmann_tpu.serve import server as jserver  # noqa: E402
from qmann_tpu_torch.config import QmannConfig  # noqa: E402
from qmann_tpu_torch.data import DataDims, Dictionary, babi  # noqa: E402
from qmann_tpu_torch.data.native import load_task_native  # noqa: E402
from qmann_tpu_torch.models import memn2n  # noqa: E402
from qmann_tpu_torch.serve import client, packet, server  # noqa: E402
from qmann_tpu_torch.serve import (  # noqa: E402
    EngineStats, IndexedSample, InferenceEngine, Request)
from qmann_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 240


@pytest.fixture(autouse=True)
def deadline():
    """End the process of a test that outlives DEADLINE_S (a hung socket
    must not cost the whole suite); one torch thread, as the suite's other
    CPU-heavy port tests use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the packet codec
# ---------------------------------------------------------------------------

def _random_samples(rng, n, n_addr=4096):
    """Samples over the whole 12-bit address range, empty sentences and
    a multi-word answer included."""
    out = []
    for k in range(n):
        ns = int(rng.integers(0, 5))
        sents = [[int(a) for a in rng.integers(0, n_addr,
                                               rng.integers(0, 6))]
                 for _ in range(ns)]
        te = [int(a) for a in rng.integers(0, n_addr, ns)]
        q = [int(a) for a in rng.integers(0, n_addr, rng.integers(1, 5))]
        a = [int(a) for a in rng.integers(0, n_addr, 1 + (k % 3 == 0))]
        out.append((sents, te, q, a))
    return out


def test_packet_constants_match_jax():
    names = [n for n in dir(jpacket) if n.isupper()]
    assert len(names) >= 14
    for n in names:
        assert getattr(packet, n) == getattr(jpacket, n), n
    for ptype in range(16):
        for addr in (0, 1, 63, 4095, 4096, 5000):
            assert packet.pack(ptype, addr) == jpacket.pack(ptype, addr)
            assert packet.unpack(packet.pack(ptype, addr)) == \
                jpacket.unpack(jpacket.pack(ptype, addr))


@pytest.mark.parametrize("train", [False, True])
def test_packet_codec_byte_identical_to_jax(train, tmp_path):
    rng = np.random.default_rng(3)
    raw = _random_samples(rng, 12)
    mine = [IndexedSample(*s) for s in raw]
    theirs = [jpacket.IndexedSample(*s) for s in raw]
    for m, t in zip(mine, theirs):
        data = packet.encode_sample(m, train=train)
        assert data == jpacket.encode_sample(t, train=train)
        # little-endian uint16, type in the top 4 bits
        words = struct.unpack(f"<{len(data) // 2}H", data)
        assert all((w >> 12) & 0x7 <= 5 and bool(w >> 15) == train
                   for w in words)
    n_mine = packet.write_sample_bin(mine, str(tmp_path / "p.bin"),
                                     train=train)
    n_jax = jpacket.write_sample_bin(theirs, str(tmp_path / "j.bin"),
                                     train=train)
    assert n_mine == n_jax == (tmp_path / "p.bin").stat().st_size
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    answers = [int(a) for a in rng.integers(0, 4096, 9)]
    resp = b"".join(packet.encode_response(a) for a in answers)
    assert resp == b"".join(jpacket.encode_response(a) for a in answers)
    assert packet.decode_response(resp) == jpacket.decode_response(resp) \
        == answers


@pytest.mark.parametrize("train", [False, True])
def test_packet_decoder_at_every_odd_byte_split(train):
    """Two feeds split inside a packet, at every odd offset, and a feed of
    one byte at a time: the samples JAX's decoder gives on the whole
    stream."""
    raw = _random_samples(np.random.default_rng(4), 5)
    stream = b"".join(jpacket.encode_sample(jpacket.IndexedSample(*s),
                                            train=train) for s in raw)
    want = [dataclasses.astuple(s)
            for s in jpacket.PacketDecoder().feed(stream)]
    assert want == [tuple(s) for s in raw]
    for cut in range(1, len(stream), 2):
        dec = packet.PacketDecoder()
        got = dec.feed(stream[:cut]) + dec.feed(stream[cut:])
        assert [dataclasses.astuple(s) for s in got] == want, cut
    dec, got = packet.PacketDecoder(), []
    for i in range(len(stream)):
        got += dec.feed(stream[i:i + 1])
    assert [dataclasses.astuple(s) for s in got] == want


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_data")
    return babi.write_synthetic_corpus(str(root), np.random.default_rng(12),
                                       [1], 120, 40, parsed=[1],
                                       joint=False)


def test_samples_from_split_matches_jax(corpus):
    data = load_task_native("qa1_single-supporting-fact", corpus[0],
                            raw_path=corpus[1])
    got = client.samples_from_split(data.test, data.dims)
    want = jclient.samples_from_split(data.test, data.dims)
    assert len(got) == len(data.test) == 40
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert any(len(s.sentences) > 1 for s in got)


# ---------------------------------------------------------------------------
# the engine: submit and submit_indexed against JAX's engine
# ---------------------------------------------------------------------------

N_WORDS = 14          # dictionary: NULL + w1..w13
PAD = 3               # dim_dict past the dictionary: columns never filled
DIMS = DataDims(dim_dict=N_WORDS + PAD, max_line=5, max_word=4, dim_word=5,
                dim_input=N_WORDS + PAD + 5)


def _dictionaries():
    td, jd = Dictionary(), jbabi.Dictionary()
    for i in range(1, N_WORDS):
        td.add(f"w{i}")
        jd.add(f"w{i}")
    return td, jd


def edge_samples():
    """Packet-stream samples at the edges of the index -> word -> index
    round trip of JAX's engine (dim_dict 17 with 14 words, dim_input 22,
    max_line 5, 4 words a row under en_time)."""
    d = DIMS
    past_dict = [N_WORDS, N_WORDS + 2]            # inside dim_dict, no word
    temporal = [d.dim_dict, d.dim_input - 1]      # the temporal columns
    return [
        # NULL counts in column 0; out-of-range indices dropped before the
        # truncation to 4 words (so 4 real words survive)
        IndexedSample([[0, 0, 3], past_dict + [1, 2] + temporal + [4, 5, 6]],
                      [d.dim_dict, d.dim_dict + 1], [0] + temporal + [2, 2],
                      [3]),
        # 7 sentences past max_line 5: the oldest 2 and their TEs dropped
        IndexedSample([[i % 13 + 1, (3 * i) % 13 + 1] for i in range(7)],
                      [d.dim_dict + (i % 5) for i in range(7)], [5, 6], [1]),
        # transmitted TEs: out of range (fallback to dim_dict + ns - j - 1),
        # a word column (set to 1), the last input column, a short list
        IndexedSample([[1, 2], [3], [4, 4, 4, 4, 4, 4], [5]],
                      [d.dim_input, 2, d.dim_input - 1], [7, 8, 9], [2]),
        # empty sentences and an empty question
        IndexedSample([[], [9], []], [d.dim_dict + 2, 4095, d.dim_dict],
                      [], [4]),
        # every sentence out of range: rows with only their temporal one-hot
        IndexedSample([past_dict, temporal], [d.dim_dict + 1, d.dim_dict],
                      past_dict + [13], [13]),
        # longest sentence of words only, a question past the limit
        IndexedSample([[13, 12, 11, 10, 9, 8, 7]], [d.dim_dict],
                      [1, 2, 3, 4, 5, 6], [6]),
    ]


def _random_indexed(rng, n):
    """Valid and invalid indices mixed, stories of 1..7 sentences."""
    out = []
    for _ in range(n):
        ns = int(rng.integers(1, 8))
        sents = [[int(i) for i in rng.integers(0, DIMS.dim_input + 2,
                                               rng.integers(0, 7))]
                 for _ in range(ns)]
        te = [int(t) for t in rng.integers(DIMS.dim_dict,
                                           DIMS.dim_input + 1, ns)]
        q = [int(i) for i in rng.integers(0, N_WORDS, rng.integers(1, 6))]
        out.append(IndexedSample(sents, te, q, [1]))
    return out


def _jax_requests(jd, samples):
    """JAX's submit_indexed, up to the queue: the Requests it builds."""
    captured = []
    fake = type("E", (), {"dictionary": jd,
                          "submit": lambda self, s, q, te_indices=None:
                          captured.append(jengine.Request(
                              [list(x) for x in s], list(q),
                              list(te_indices)
                              if te_indices is not None else None))})()
    for s in samples:
        jengine.InferenceEngine.submit_indexed(
            fake, jpacket.IndexedSample(s.sentences, s.te_indices,
                                        s.question, s.answer))
    return captured


@pytest.mark.parametrize("en_time", [True, False])
def test_indexed_vectorizer_matches_jax_round_trip(en_time):
    """The port's direct index vectorizer against JAX's index -> word ->
    index round trip, bit for bit, on the edge samples and random ones."""
    td, jd = _dictionaries()
    samples = edge_samples() + _random_indexed(np.random.default_rng(5), 26)
    cfg = type("C", (), {"en_time": en_time})()
    port = type("E", (), {"dims": DIMS, "batch_size": len(samples),
                          "cfg": cfg, "dictionary": td})()
    jax_eng = type("E", (), {"dims": DIMS, "batch_size": len(samples),
                             "cfg": cfg, "dictionary": jd})()
    got = InferenceEngine._vectorize(
        port, [Request([list(x) for x in s.sentences], list(s.question),
                       list(s.te_indices), indexed=True) for s in samples])
    want = jengine.InferenceEngine._vectorize(jax_eng,
                                              _jax_requests(jd, samples))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the edges are exercised: column 0 counted, a TE in a word column
    assert got[0][0, 0, 0] == 2.0
    assert got[0][2, 1, 2] == (1.0 if en_time else 0.0)


def _stories(td, rng, n):
    words = td.words[1:]
    return [([[words[i] for i in rng.integers(0, len(words),
                                              rng.integers(1, 7))]
              for _ in range(rng.integers(1, 8))],
             [words[i] for i in rng.integers(0, len(words), 3)])
            for _ in range(n)]


ENGINE_CASES = [(mode, prepare) for mode in (2, 3)
                for prepare in (True, False)]


@pytest.fixture(scope="module")
def jax_answers():
    """JAX's engine, once per (mode, prepare): its answers to the edge and
    random packet samples (submit_indexed) and to word stories (submit),
    with the weights both engines load."""
    out = {}
    td, jd = _dictionaries()
    rng = np.random.default_rng(6)
    samples = edge_samples() + _random_indexed(rng, 34)
    stories = _stories(td, rng, 24)
    for mode, prepare in ENGINE_CASES:
        jcfg = JaxConfig(dim_emb=16, attention_mode=mode, verbose=False)
        pj = {k: np.asarray(v) * np.float32(4.0) for k, v in
              jmodel.init_params(jcfg, DIMS, jax.random.PRNGKey(2)).items()}
        eng = jengine.InferenceEngine(pj, jcfg, DIMS, jd, batch_size=16,
                                      max_wait_ms=50.0,
                                      prepare=prepare).start()
        try:
            futs = ([eng.submit_indexed(jpacket.IndexedSample(
                s.sentences, s.te_indices, s.question, s.answer))
                for s in samples] + [eng.submit(s, q) for s, q in stories])
            out[mode, prepare] = (pj, [f.result(timeout=120) for f in futs])
        finally:
            eng.stop()
    return samples, stories, out


@pytest.mark.parametrize("mode,prepare", ENGINE_CASES)
def test_engine_answers_match_jax_engine(jax_answers, mode, prepare):
    """submit_indexed and submit, mixed in the same waves, give JAX's
    engine's answers."""
    samples, stories, answers = jax_answers
    pj, want = answers[mode, prepare]
    td, _ = _dictionaries()
    cfg = QmannConfig(dim_emb=16, attention_mode=mode, verbose=False)
    eng = InferenceEngine(memn2n.params_from_jax(pj, cfg, device="cpu"), cfg,
                          DIMS, td, batch_size=16, max_wait_ms=50.0,
                          prepare=prepare, device="cpu").start()
    try:
        futs = ([eng.submit_indexed(s) for s in samples]
                + [eng.submit(s, q) for s, q in stories])
        got = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert not eng._thread.is_alive()
    assert (eng.prepared is None) == (not prepare)
    st = eng.stats.snapshot()
    assert st["failed_waves"] == 0 and st["requests"] == len(got)
    assert got == want
    assert len(set(got)) > 1


def test_snapshot_answer_word_and_refusals():
    """The engine over a mesh of one rank (a group of this process) pins
    the plain prepared forward and answers as the plain route; then the
    stats snapshot and a failed wave."""
    import torch.distributed as dist
    from qmann_tpu_torch.parallel import make_mesh
    from qmann_tpu_torch.parallel.launch import init_single_process
    td, _ = _dictionaries()
    cfg = QmannConfig(dim_emb=8, verbose=False)
    params = memn2n.init_params(cfg, DIMS, torch.Generator().manual_seed(0),
                                device="cpu")
    answers = {}
    init_single_process("cpu")
    try:
        for mesh in (make_mesh(device="cpu"), None):
            eng = InferenceEngine(params, cfg.replace(use_fused_chain=True)
                                  if mesh else cfg, DIMS, td, batch_size=4,
                                  max_wait_ms=20.0, mesh=mesh,
                                  device="cpu").start()
            try:
                answers[mesh is None] = [f.result(timeout=60) for f in [
                    eng.submit_indexed(s) for s in edge_samples()]]
            finally:
                eng.stop()
            assert not eng._thread.is_alive()
            assert eng.stats.failed_waves == 0
            assert not eng.cfg.use_fused_chain
    finally:
        dist.destroy_process_group()
    assert answers[False] == answers[True]
    eng = InferenceEngine(params, cfg, DIMS, td, batch_size=4,
                          max_wait_ms=20.0, device="cpu").start()
    try:
        futs = [eng.submit_indexed(s) for s in edge_samples()]
        [f.result(timeout=60) for f in futs]
        snap = eng.stats.snapshot()
        assert snap == dataclasses.asdict(eng.stats)
        assert set(snap) == {f.name for f in dataclasses.fields(EngineStats)}
        assert snap["requests"] == 6 and snap["failed_waves"] == 0
        assert 2 <= snap["waves"] <= 6           # batch 4: at least 2 waves
        assert snap["vectorize_s"] > 0 and snap["infer_s"] > 0
        snap["waves"] = -1                       # a copy, not the counters
        assert eng.stats.waves >= 2

        def broken(*_):
            raise RuntimeError("wave failed")

        eng.infer = broken
        fut = eng.submit_indexed(edge_samples()[0])
        with pytest.raises(RuntimeError, match="wave failed"):
            fut.result(timeout=60)
        assert eng.stats.snapshot()["failed_waves"] == 1
    finally:
        eng.stop()
    assert eng.answer_word(0) == "NULL" and eng.answer_word(3) == "w3"


# ---------------------------------------------------------------------------
# the server and the client, on the CPU, within the port and across
# ---------------------------------------------------------------------------

def _model(corpus, mode=2):
    """qa1 files' test split and a seeded model on them: (data, JAX-layout
    params x4, the port's config, JAX's config)."""
    data = load_task_native("qa1_single-supporting-fact", corpus[0],
                            raw_path=corpus[1])
    jcfg = JaxConfig(dim_emb=16, attention_mode=mode, verbose=False)
    pj = {k: np.asarray(v) * np.float32(4.0) for k, v in
          jmodel.init_params(jcfg, data.dims, jax.random.PRNGKey(1)).items()}
    return data, pj, QmannConfig(dim_emb=16, attention_mode=mode,
                                 verbose=False), jcfg


def _port_engine(data, pj, cfg, **kw):
    return InferenceEngine(memn2n.params_from_jax(pj, cfg, device="cpu"),
                           cfg, data.dims, data.dictionary, batch_size=8,
                           max_wait_ms=5.0, device="cpu", **kw).start()


def _jax_engine(data, pj, jcfg):
    jd = jbabi.Dictionary()
    for w in data.dictionary.words[1:]:
        jd.add(w)
    return jengine.InferenceEngine(pj, jcfg, jbabi.DataDims(
        **dataclasses.asdict(data.dims)), jd, batch_size=8,
        max_wait_ms=5.0).start()


def _serve_and_query(serve, eng, client_cls, samples):
    srv = serve(eng, port=0)
    host, port = srv.server_address[:2]
    try:
        with client_cls(host, port, timeout=60) as c:
            return c.query_samples(samples)
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_and_client_end_to_end_on_the_cpu(corpus):
    """The port's client against the port's server: one answer per sample,
    in order, equal to the engine's own answers; then the edge samples."""
    data, pj, cfg, _ = _model(corpus)
    samples = client.samples_from_split(data.test, data.dims)
    eng = _port_engine(data, pj, cfg)
    try:
        direct = [f.result(timeout=60)
                  for f in [eng.submit_indexed(s) for s in samples]]
        got = _serve_and_query(server.serve, eng, client.PacketClient,
                               samples)
        many = _serve_and_query(server.serve, eng, client.PacketClient,
                                samples * 5)
    finally:
        eng.stop()
    assert got == direct and many == direct * 5
    assert eng.stats.failed_waves == 0


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_cross_wire_with_the_jax_package(corpus, pair):
    """Each package's client against the other's server: the same answers
    as the port's client against the port's server."""
    data, pj, cfg, jcfg = _model(corpus, mode=3)
    samples = client.samples_from_split(data.test, data.dims)
    eng = _port_engine(data, pj, cfg)
    try:
        want = _serve_and_query(server.serve, eng, client.PacketClient,
                                samples)
        if pair == "jax_client_port_server":
            jsamples = [jpacket.IndexedSample(*dataclasses.astuple(s))
                        for s in samples]
            got = _serve_and_query(server.serve, eng, jclient.PacketClient,
                                   jsamples)
    finally:
        eng.stop()
    if pair == "port_client_jax_server":
        jeng = _jax_engine(data, pj, jcfg)
        try:
            got = _serve_and_query(jserver.serve, jeng, client.PacketClient,
                                   samples)
        finally:
            jeng.stop()
    assert got == want and len(got) == len(samples)
    assert len(set(got)) > 1


def test_failed_wave_answers_null_and_short_stream_raises(corpus):
    """A failed wave answers index 0 for each of its samples (the framing
    holds); a server that closes early makes the client raise."""
    import socket
    import threading
    data, pj, cfg, _ = _model(corpus)
    samples = client.samples_from_split(data.test, data.dims)[:5]
    eng = _port_engine(data, pj, cfg)

    def broken(*_):
        raise RuntimeError("wave failed")

    eng.infer = broken
    try:
        got = _serve_and_query(server.serve, eng, client.PacketClient,
                               samples)
    finally:
        eng.stop()
    assert got == [0] * 5 and eng.stats.failed_waves >= 1

    lsock = socket.create_server(("127.0.0.1", 0))
    lsock.settimeout(30)

    def answer_two_then_close():
        conn, _ = lsock.accept()
        with conn:
            conn.settimeout(30)
            conn.recv(4096)
            conn.sendall(packet.encode_response(1) * 2)

    t = threading.Thread(target=answer_two_then_close, daemon=True)
    t.start()
    try:
        with client.PacketClient(*lsock.getsockname()[:2], timeout=30) as c:
            with pytest.raises(ConnectionError, match="after 2 of 5"):
                c.query_samples(samples)
    finally:
        t.join(timeout=30)
        lsock.close()
    assert not t.is_alive()


def test_server_and_client_command_lines(corpus, tmp_path, capsys):
    """python -m qmann_tpu_torch.serve.server --port 0 --device cpu on a
    checkpoint with its dictionary, and the client's main() against it:
    err_test as the engine's answers give it; the server is killed on
    every path."""
    data, pj, cfg, _ = _model(corpus)
    ckpt = save_checkpoint(str(tmp_path), pj, cfg.replace(
        use_fused_chain=True), data.dims, tag="ckpt",
        dictionary=data.dictionary)
    samples = client.samples_from_split(data.test, data.dims)
    eng = _port_engine(data, pj, cfg)
    try:
        direct = [f.result(timeout=60)
                  for f in [eng.submit_indexed(s) for s in samples]]
    finally:
        eng.stop()
    err = 1.0 - np.mean(np.array(direct) == data.test.answer_index)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qmann_tpu_torch.serve.server",
         "--checkpoint", ckpt, "--port", "0", "--device", "cpu",
         "--batch-size", "16"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"serving on (\S+):(\d+)", line)
        assert m, (line, proc.poll())
        assert client.main(["--host", m.group(1), "--port", m.group(2),
                            "--task", "1", "--limit", "40", "--data-path",
                            corpus[0], "--raw-data-path", corpus[1]]) == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.poll() is not None
    out = capsys.readouterr().out
    assert f"streamed 40 samples; err_test = {err:f}" in out
    assert json.loads(Path(ckpt, "meta.json").read_text())["config"][
        "use_fused_chain"]


def test_server_defaults_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    data, pj, cfg, _ = _model(corpus)
    ckpt = save_checkpoint(str(tmp_path), pj, cfg, data.dims, tag="ckpt",
                           dictionary=data.dictionary)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--checkpoint", ckpt, "--port", "0"])
    for parser, jmain in ((server.build_parser(), jserver.main),
                          (client.build_parser(), jclient.main)):
        assert parser.get_default("port") == 8765
        assert {a.dest for a in parser._actions} - {"help", "device"} == \
            {a.dest for a in _jax_parser(jmain)._actions} - {"help"}
    assert server.build_parser().get_default("device") == "cuda"


def _jax_parser(main):
    """The parser a JAX entry point builds inside its main()."""
    import argparse
    seen = []

    def grab(self, argv=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[0]
