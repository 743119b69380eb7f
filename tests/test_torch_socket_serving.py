"""Port, the serving front: `streaming.socket_server` (JAX's wire protocol),
`deploy.run_serve`, the SIMO branch of `make_session_server` and the
recipes' `--action serve`, over loopback on the CPU, small models with
seeded weights:

- TSE sessions enrolled by a d-vector HELLO and by an enrollment HELLO, NS
  and DSS sessions (empty HELLO), two at a time through `run_serve` (its
  `on_started` / `stop_event` hooks): each session's output equals the
  engine stepped alone on its audio, and after BYE the client holds
  exactly (sent // chunk) * chunk samples per source;
- JAX's `StreamingClient` (puresound_tpu/streaming/socket_server.py, numpy
  and socket only) against the port's server: the wire protocol unchanged,
  the DSS sources de-interleaved from `s * M + m`;
- ERROR on an overflowed output ring and on a wrong first message; a
  length header over `MAX_PAYLOAD` drops the connection; the client splits
  its sends at `MAX_PAYLOAD` and the server its AUDIO_OUT, aligned to the
  SIMO frame;
- SIMO under pcm16 (interleaved, then quantised: within one int16 step of
  the float32 server) and pipelined (bit-equal to unpipelined);
- each CLI's serve action hands `run_serve` what JAX's CLI hands JAX's;
- the native loader from two processes at once: one build, both load.
"""
import argparse
import importlib
import importlib.util
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from puresound_tpu.streaming import socket_server as jss
from puresound_tpu_torch.nnet.base_nn import SiMoTaskWrapModule, SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.dparn import DPARN_Mout
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.src import native
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming import socket_server as ss
from puresound_tpu_torch.streaming.deploy import make_session_server, run_serve

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, CHUNK_MS, CHUNK = 16000, 8.0, 128
C, E = 24, 8
STFT = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8), transpose_t_size=2, kernel_t=(2, 2), stride_t=(1, 1),
            dilation_t=(1, 1), kernel_f=(5, 3), stride_f=(2, 2), dilation_f=(1, 1),
            delay=(0, 0), rnn_hidden=8)
ENC = dict(fft_length=128, win_length=128, hop_length=32, trainable=True,
           output_format="Complex")
WRAP = dict(f_type="Complex", mask_type="Complex", drop_first_bin=True)


def _model(kind):
    """A small model of each family, weights from the default seeded
    generator, in eval mode."""
    if kind == "tse":
        spk = [TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
               AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)]
        return SoTaskWrapModule(
            FreeEncDec(win_length=32, hop_length=16, laten_length=C, output_active=True),
            SkiM(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=8,
                 seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
                 embed_fusion="FiLM", block_with_embed=(1, 1)),
            spk, mask_constraint="ReLU").eval()
    if kind == "ns":
        return SoTaskWrapModule(ConvEncDec(**ENC), DPCRN(**STFT), **WRAP).eval()
    return SiMoTaskWrapModule(ConvEncDec(**ENC),
                              DPARN_Mout(**STFT, nhead=2, multi_output=2), **WRAP).eval()


@pytest.fixture(scope="module", autouse=True)
def _hub():
    native.load()


def _solo(engine, audio, dvec=None):
    """The engine alone on one stream's whole chunks: [n] or [M, n]."""
    n = len(audio) // CHUNK
    st = engine.init_state(1)
    outs = []
    with torch.no_grad():
        for k in range(n):
            x = torch.from_numpy(audio[None, k * CHUNK:(k + 1) * CHUNK])
            y, st = engine.step(x, dvec, st) if dvec is not None else engine.step(x, st)
            outs.append(y[0].numpy())
    return np.concatenate(outs, axis=-1)


class _Serving:
    """run_serve on a thread, on 127.0.0.1 port 0, through its hooks."""

    def __init__(self, model, n_slots=2, **kw):
        self.ready, self.stop = threading.Event(), threading.Event()
        self.thread = threading.Thread(target=run_serve, args=(model, None, n_slots), kwargs=dict(
            host="127.0.0.1", port=0, stop_event=self.stop, on_started=self._started,
            chunk_ms=CHUNK_MS, sr=SR, **kw), daemon=True)

    def _started(self, front, bundle):
        self.front, self.bundle = front, bundle
        self.ready.set()

    def __enter__(self):
        self.thread.start()
        assert self.ready.wait(timeout=60.0)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30.0)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("kind,hello", [("tse", "dvec"), ("tse", "enroll"), ("ns", None),
                                        ("dss", None)])
def test_sessions_equal_the_engine_alone(rng, capsys, kind, hello):
    """Two concurrent sessions of 3.5 chunks each: per source, exactly 3
    chunks back after BYE, equal to the engine alone on the same audio."""
    model = _model(kind)
    with _Serving(model, fused=False) as srv:
        bundle = srv.bundle
        assert bundle.chunk_samples == CHUNK
        assert bundle.n_sources == (2 if kind == "dss" else 1)
        audios = [(0.1 * rng.standard_normal(CHUNK * 7 // 2)).astype(np.float32)
                  for _ in range(2)]
        payloads = [None, None]
        if hello == "dvec":
            payloads = [rng.standard_normal(bundle.embed_dim).astype(np.float32)
                        for _ in range(2)]
        elif hello == "enroll":
            payloads = [(0.1 * rng.standard_normal(3000)).astype(np.float32) for _ in range(2)]
        got = [None, None]

        def session(i):
            c = ss.StreamingClient(*srv.front.address).hello(payloads[i])
            assert c.chunk == CHUNK and c.n_sources == bundle.n_sources
            c.send(audios[i][:1000])
            c.send(audios[i][1000:])
            got[i] = c.finish()

        threads = [threading.Thread(target=session, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        engine = bundle.engine
        for i in range(2):
            dvec = None
            if hello == "dvec":
                dvec = torch.from_numpy(payloads[i][None])
            elif hello == "enroll":
                with torch.no_grad():
                    dvec = engine.embed(torch.from_numpy(payloads[i][None]))
            want = _solo(engine, audios[i], dvec)
            assert got[i].shape == want.shape == ((2, 3 * CHUNK) if kind == "dss"
                                                  else (3 * CHUNK,))
            np.testing.assert_allclose(got[i], want, atol=1e-5)
        assert bundle.server.n_active == 0     # detached before the BYE reply
    mode = {"tse": "TSE (per-session enrollment)", "ns": "NS", "dss": "SIMO x2"}[kind]
    assert f"[serve] {mode} on 127.0.0.1:" in capsys.readouterr().out


def test_tse_hello_errors(rng):
    """TSE needs a HELLO payload; a full server refuses with ERROR."""
    with _Serving(_model("tse"), n_slots=1, fused=False) as srv:
        with pytest.raises(RuntimeError, match="HELLO payload"):
            ss.StreamingClient(*srv.front.address).hello()
        dv = rng.standard_normal(srv.bundle.embed_dim).astype(np.float32)
        c = ss.StreamingClient(*srv.front.address).hello(dv)
        with pytest.raises(RuntimeError, match="no free stream slots"):
            ss.StreamingClient(*srv.front.address).hello(dv)
        c.finish()


def test_jax_client_talks_to_the_port_server(rng):
    """JAX's StreamingClient, byte for byte JAX's protocol, gets the DSS
    sources de-interleaved from the port's server."""
    model = _model("dss")
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=CHUNK_MS, sr=SR)
    front = ss.SocketServingFront(bundle.server, n_sources=bundle.n_sources).start()
    try:
        audio = (0.1 * rng.standard_normal(4 * CHUNK + 5)).astype(np.float32)
        c = jss.StreamingClient(*front.address).hello()
        assert (c.chunk, c.n_sources) == (CHUNK, 2)
        c.send(audio)
        got = c.finish()
        np.testing.assert_allclose(got, _solo(bundle.engine, audio), atol=1e-5)
        assert got.shape == (2, 4 * CHUNK)
    finally:
        front.stop()


def test_overflowed_output_ring_replies_error(rng, monkeypatch):
    """A client that never lets its output drain (the pump sees an empty
    ring) overflows a 2-tick ring: at BYE the server replies ERROR with the
    dropped count, not BYE."""
    bundle = make_session_server(_model("dss"), None, n_slots=1, chunk_ms=CHUNK_MS, sr=SR,
                                 ring_capacity=4 * CHUNK)
    real = bundle.server.hub

    class Stuck:
        def output_available(self, sid):
            return 0

        def __getattr__(self, name):
            return getattr(real, name)

    monkeypatch.setattr(bundle.server, "hub", Stuck())
    front = ss.SocketServingFront(bundle.server, n_sources=2, drain_timeout_s=1.0).start()
    try:
        c = ss.StreamingClient(*front.address).hello()
        c.send((0.1 * rng.standard_normal(5 * CHUNK)).astype(np.float32))
        deadline = time.monotonic() + 20.0
        while real.output_dropped(c.slot) == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert real.output_dropped(c.slot) > 0
        with pytest.raises(RuntimeError, match="output overflow: .* samples dropped"):
            c.finish()
    finally:
        front.stop()


def test_protocol_garbage_and_max_payload(rng):
    """A wrong first message gets ERROR; a length header over MAX_PAYLOAD
    drops the connection; a session afterwards still works."""
    import socket

    bundle = make_session_server(_model("ns"), None, n_slots=1, chunk_ms=CHUNK_MS, sr=SR)
    front = ss.SocketServingFront(bundle.server, hello_timeout_s=0.5).start()
    host, port = front.address
    try:
        s = socket.create_connection((host, port), timeout=5.0)
        s.sendall(struct.pack("<II", ss.MSG_AUDIO, 4) + b"\0" * 4)
        t, n = struct.unpack("<II", ss._recv_exact(s, 8))
        assert t == ss.MSG_ERROR and ss._recv_exact(s, n) == b"expected HELLO"
        s.close()
        s = socket.create_connection((host, port), timeout=5.0)
        s.sendall(struct.pack("<II", ss.MSG_HELLO, ss.MAX_PAYLOAD + 1))
        assert s.recv(8) == b""
        s.close()
        assert bundle.server.n_active == 0
        audio = (0.1 * rng.standard_normal(2 * CHUNK)).astype(np.float32)
        c = ss.StreamingClient(host, port).hello()
        c.send(audio)
        np.testing.assert_allclose(c.finish(), _solo(bundle.engine, audio), atol=1e-5)
    finally:
        front.stop()


def test_payload_caps_split_sends_and_simo_frames(rng, monkeypatch):
    """Under a cap of one chunk and one sample (bytes): the client's send is
    split into several AUDIO messages, and every AUDIO_OUT the server sends
    is at most the cap and whole interleave frames (an even sample count)."""
    bundle = make_session_server(_model("dss"), None, n_slots=1, chunk_ms=CHUNK_MS, sr=SR)
    monkeypatch.setattr(ss, "MAX_PAYLOAD", 4 * (CHUNK + 1))
    sent, orig = [], ss._send_msg

    def recording(sock, t, payload=b""):
        sent.append((t, len(payload)))
        return orig(sock, t, payload)

    monkeypatch.setattr(ss, "_send_msg", recording)
    front = ss.SocketServingFront(bundle.server, n_sources=2).start()
    try:
        audio = (0.1 * rng.standard_normal(5 * CHUNK)).astype(np.float32)
        c = ss.StreamingClient(*front.address).hello()
        c.send(audio)
        got = c.finish()
        np.testing.assert_allclose(got, _solo(bundle.engine, audio), atol=1e-5)
    finally:
        front.stop()
    ins = [n for t, n in sent if t == ss.MSG_AUDIO]
    outs = [n for t, n in sent if t == ss.MSG_AUDIO_OUT]
    assert len(ins) == 5 and max(ins) <= ss.MAX_PAYLOAD
    assert outs and max(outs) <= ss.MAX_PAYLOAD and all(n % 8 == 0 for n in outs)
    assert sum(outs) == 4 * 2 * 5 * CHUNK


def _ticked(bundle, feed):
    """Lockstep ticks of every slot over feed [n_slots, n * chunk], the
    rows popped each tick (flushed when pipelined)."""
    server = bundle.server
    sids = [server.attach() for _ in range(len(feed))]
    n = feed.shape[1] // CHUNK
    out = [[] for _ in sids]
    for k in range(n + 1):
        if k < n:
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * CHUNK:(k + 1) * CHUNK])
            server.tick()
        else:
            server.flush()
        for i, sid in enumerate(sids):
            out[i].append(server.hub.pop_output(sid, 2 * CHUNK))
    return np.stack([np.concatenate(o) for o in out])


def test_simo_pcm16_and_pipelined_interleave(rng):
    """The SIMO row interleaves the sources (sample s of source m at s * M
    + m); pcm16 quantises after the interleave, within one int16 step of
    the float32 server; pipelined equals unpipelined bit for bit."""
    model = _model("dss")
    feed = (0.1 * rng.standard_normal((2, 3 * CHUNK))).astype(np.float32)
    kw = dict(n_slots=2, chunk_ms=CHUNK_MS, sr=SR, lockstep=True)
    flat = _ticked(make_session_server(model, None, **kw), feed)
    assert flat.shape == (2, 2 * 3 * CHUNK)
    for i in range(2):
        want = _solo(make_session_server(model, None, **kw).engine, feed[i])
        np.testing.assert_allclose(flat[i].reshape(-1, 2).T, want, atol=1e-5)
    pipe = _ticked(make_session_server(model, None, pipelined=True, **kw), feed)
    np.testing.assert_array_equal(pipe, flat)
    pcm = _ticked(make_session_server(model, None, pcm16=True, **kw), feed)
    # the host truncates to int16, as JAX's server does
    q = np.trunc(np.clip(feed * 8192.0, -32767, 32767)) / 8192.0
    want = _ticked(make_session_server(model, None, **kw), q.astype(np.float32))
    assert np.abs(pcm - want).max() <= 1.0 / 8192.0 + 1e-6


def test_hub_counts_dropped_output_and_active_slots(rng):
    bundle = make_session_server(_model("ns"), None, n_slots=2, chunk_ms=CHUNK_MS, sr=SR,
                                 ring_capacity=2 * CHUNK, lockstep=True)
    server = bundle.server
    sid = server.attach()
    assert server.n_active == 1
    for _ in range(3):
        server.hub.push_input(sid, np.zeros(CHUNK, np.float32))
        server.tick()
    assert server.hub.output_dropped(sid) == CHUNK
    server.detach(sid)
    assert server.n_active == 0 and server.hub.output_dropped(sid) == 0


# ---------------------------------------------------------------------- CLIs
def _jax_cli(kind):
    spec = importlib.util.spec_from_file_location(f"jax_serve_{kind}",
                                                  os.path.join(ROOT, "egs", kind, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONFS = {"tse": "egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml",
         "ns": "egs/ns/conf/vctk_dparn_1a.yaml", "dss": "egs/dss/conf/dss_dparn_1a.yaml"}
FLAGS = {"tse": ["--fused", "--pcm16"], "ns": ["--fused", "--attn_kernel", "--pcm16"],
         "dss": ["--mk_kernel", "--half"]}


@pytest.mark.parametrize("kind", list(CONFS))
def test_cli_serve_hands_run_serve_what_jax_hands_its_own(tmp_path, monkeypatch, kind):
    import puresound_tpu.streaming.deploy as jdeploy

    cli = importlib.import_module(f"puresound_tpu_torch.egs.{kind}.main")
    jcli = _jax_cli(kind)
    hp = load_hparam(os.path.join(ROOT, CONFS[kind]))
    hp["TRAIN"].update(model_save_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"))
    cfg = str(tmp_path / "c.yaml")
    dump_hparam(hp, cfg)
    calls = {}
    monkeypatch.setattr(cli, "load_eval_model", lambda hparam, ckpt, device: "port model")
    monkeypatch.setattr(jcli, "load_eval_model", lambda hparam, ckpt: ("jax model", {}))
    monkeypatch.setattr(cli, "run_serve", lambda *a, **kw: calls.update(port=(a, kw)))
    monkeypatch.setattr(jdeploy, "run_serve", lambda *a, **kw: calls.update(jax=(a, kw)))
    args = ["--action", "serve", "--ckpt", "epoch_3.ckpt", "--serve_slots", "12",
            "--port", "7001", "--chunk_ms", "32", *FLAGS[kind]]
    cli.main(cli.parse_args([cfg, *args, "--backend", "cpu"]))
    ns = argparse.Namespace(
        config_path=cfg, action="serve", ckpt="epoch_3.ckpt", serve_slots=12, port=7001,
        chunk_ms=32.0, backend="cpu", num_processes=1, coordinator=None, process_id=0,
        **{f: f"--{f}" in FLAGS[kind] for f in ("half", "fused", "pcm16", "dp_kernel",
                                                 "attn_kernel", "mk_kernel")})
    jcli.main(ns)
    (pa, pkw), (ja, jkw) = calls["port"], calls["jax"]
    assert pa == ("port model", None, 12) and ja == ("jax model", {}, 12)
    assert pkw == jkw and pkw["port"] == 7001 and pkw["chunk_ms"] == 32.0


# ------------------------------------------------------------- native loader
def test_native_loads_from_two_processes_at_once(tmp_path):
    """A fresh copy of csrc/ with no library: two processes load at once;
    the lock lets one of them run make, both load their private copy (and
    remove it) and round-trip a hub."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(ROOT, "csrc"), csrc,
                    ignore=shutil.ignore_patterns("*.so"))
    made = tmp_path / "made.txt"
    code = f"""
import subprocess, numpy as np
from puresound_tpu_torch.src import native
native.CSRC, native.LIB_PATH = {str(csrc)!r}, {str(csrc / "libpuresound_audio.so")!r}
native.PRIVATE_DIR = {str(tmp_path / "private")!r}
run = subprocess.run
def counted(cmd, **kw):
    with open({str(made)!r}, "a") as f:
        f.write(" ".join(cmd) + "\\n")
    return run(cmd, **kw)
native.subprocess.run = counted
from puresound_tpu_torch.streaming.server import StreamHub
hub = StreamHub(1, 64)
hub.push_input(0, np.arange(8, dtype=np.float32))
print(hub.input_available(0), native._lib._name)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "8" and "/private/libpuresound_audio." in out
    assert open(made).read().count("make -C") == 1
    assert sorted(os.listdir(tmp_path / "private")) == ["native.lock"]
