"""The port's TCP decode server and online2 tools on the CPU:
kaldi_tpu_torch/online/server.py against kaldi_tpu/online/server.py over
real sockets on 127.0.0.1 (port 0, a timeout on every socket), and
kaldi_tpu_torch/cli/online_tools*.py.

- Given the same scorer semantics (one linear scorer of each chunk of
  features alone, the JAX server's form), each package's server over its
  own copy of the same graph sends the same partial ('\\r') and final
  ('\\n') lines, with the default endpoint rules and with a length rule
  that ends segments mid-stream.
- The streaming .mdl scorer (one OnlineNnetScorer a connection): 4
  concurrent connections give the sequential replies, and each final
  line is the offline reference's words (the compiled module over the
  whole utterance's features, then the host FasterDecoder); the
  in-process decoder's tids equal the reference's too.
- A scorer error is kept in the server's `errors`, not swallowed.
- `python -m kaldi_tpu_torch.cli online2-tcp-nnet3-decode-faster
  --use-gpu=no --num-connections=N` serves N clients and exits 0;
  online2-wav-nnet3-latgen-faster gives the offline reference's words;
  online2-wav-dump-features the JAX tool's features; --use-gpu=yes
  without CUDA, a raw model and an unmapped component end the tools.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import get_tool as jax_tool
from kaldi_tpu.feat.frontend import MfccOptions as JaxMfcc
from kaldi_tpu.feat.window import FrameExtractionOptions as JaxFrames
from kaldi_tpu.online import features as JOF
from kaldi_tpu.online.decoding import OnlineEndpointConfig as JaxEndpoint
from kaldi_tpu.online.server import TcpDecodeServer as JaxServer
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu_torch.base.logging import KaldiTpuError
from kaldi_tpu_torch.cli import get_tool
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.nnet3 import mdl_io as PM
from kaldi_tpu_torch.nnet3.streaming import OnlineNnetScorer
from kaldi_tpu_torch.nnet3.torch_bridge import compile_graph
from kaldi_tpu_torch.online import features as POF
from kaldi_tpu_torch.online.decoding import (OnlineEndpointConfig,
                                             SingleUtteranceDecoder)
from kaldi_tpu_torch.online.server import TcpDecodeServer
from kaldi_tpu_torch.util.table import SequentialTableReader
from test_torch_streaming import QUICK, SUB, small_system

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
CEPS = ["--dither=0", "--num-ceps=13", "--sample-frequency=16000"]


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("served"))
    s = small_system(d)
    s["dir"] = d
    return s


def port_opts(fs):
    return MfccOptions(frame_opts=FrameExtractionOptions(samp_freq=fs,
                                                         dither=0.0))


def client(host, port, wave, piece=1600):
    """Stream int16 PCM, half-close, collect the reply."""
    pcm = np.clip(wave, -32768, 32767).astype("<i2").tobytes()
    with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
        sock.settimeout(TIMEOUT)
        for i in range(0, len(pcm), piece):
            sock.sendall(pcm[i:i + piece])
        sock.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            data = sock.recv(4096)
            if not data:
                break
            out += data
    return out.decode()


def finals(reply):
    return " ".join(seg.split("\r")[-1] for seg in reply.split("\n")
                    if seg.split("\r")[-1]).split()


def linear_scorer(num_pdfs):
    """Loglikes f @ W of each chunk of features alone."""
    W = np.random.default_rng(3).normal(size=(13, num_pdfs)).astype(
        np.float32) * 0.3
    return lambda f: np.asarray(f, np.float32) @ W


@pytest.mark.parametrize("endpoints", [False, True])
def test_lines_equal_jax_server(system, endpoints):
    s = system
    jlex = jbc.make_corpus(jbc.BenchCorpusSpec(**QUICK), train_audio=False)
    jlang, jtm, jtree = jbc.chain_tm_tree_for(jlex[0])
    jfst = jbc.build_decode_graph(jlex[0], jlex[5], jtm, jtree,
                                  lang=jlang).to_flat_graph().to_vector_fst()
    names = dict(enumerate(s["words"]))
    fs = s["spec"].fs
    cfg, jcfg = OnlineEndpointConfig(), JaxEndpoint()
    if endpoints:
        cfg.silence_phones = [s["sil"]]
        jcfg.silence_phones = [jlang.phones[jlang.sil_phone]]
        # segments end mid-stream once 0.6 s are decoded
        cfg.rule5.min_utterance_length = 0.6
        jcfg.rule5.min_utterance_length = 0.6
    scorer = linear_scorer(s["num_pdfs"])
    port = TcpDecodeServer(
        s["fst"], s["tm"], scorer, names,
        lambda: POF.OnlineFeaturePipeline(POF.OnlineFeature(
            port_opts(fs), device="cpu")), samp_freq=fs,
        acoustic_scale=0.5, endpoint_config=cfg)
    jax = JaxServer(
        jfst, jtm, scorer, names,
        lambda: JOF.OnlineFeaturePipeline(JOF.OnlineFeature(JaxMfcc(
            frame_opts=JaxFrames(samp_freq=fs, dither=0.0)))),
        samp_freq=fs, acoustic_scale=0.5, endpoint_config=jcfg)
    for srv in (port, jax):
        srv.start()
    try:
        n_final = 0
        for utt, wave in list(s["waves"].items())[:3]:
            got = client(port.host, port.port, wave)
            want = client(jax.host, jax.port, wave)
            assert got == want, utt
            assert "\r" in got and got.endswith("\n")
            n_final += got.count("\n")
        assert (n_final > 3) == endpoints
    finally:
        port.shutdown()
        jax.shutdown()
    assert not port.errors and port.num_served == 3
    assert port.stats["utterances"] == n_final


def offline_words(s, net, wave):
    """The offline reference: the compiled module over the whole
    utterance's features, then the host FasterDecoder."""
    f, n = OfflineFeature(port_opts(s["spec"].fs), device="cpu") \
        .compute_batch_device([np.asarray(wave, np.float32)])
    ll = net(f[:, :int(n[0])])[0, ::SUB].numpy()
    return FasterDecoder(s["fst"], FasterDecoderOptions(beam=15.0)).decode(
        ll, s["tm"].id2pdf_id, 1.0)


@pytest.fixture(scope="module")
def streaming(system):
    s = system
    _tm, graph, info = PM.read_nnet3_am(s["mdl"])
    net = compile_graph(graph, device="cpu")

    def make_scorer():
        return OnlineNnetScorer(lambda w: net(w)[:, ::SUB],
                                info["left_context"], info["right_context"],
                                SUB, device="cpu")
    refs = {u: offline_words(s, net, w) for u, w in s["waves"].items()}
    return net, make_scorer, refs


def test_streaming_decoder_equals_offline_reference(system, streaming):
    s = system
    _net, make_scorer, refs = streaming
    for utt, wave in s["waves"].items():
        pipe = POF.OnlineFeaturePipeline(POF.OnlineFeature(
            port_opts(s["spec"].fs), device="cpu"))
        dec = SingleUtteranceDecoder(s["fst"], s["tm"], make_scorer(), pipe,
                                     acoustic_scale=1.0,
                                     opts=FasterDecoderOptions(beam=15.0))
        for a in range(0, len(wave), 2880):
            pipe.accept_waveform(s["spec"].fs, wave[a:a + 2880])
            dec.advance_decoding()
        pipe.input_finished()
        dec.advance_decoding()
        got, want = dec.finalize_decoding(), refs[utt]
        assert got[0] == want[0] and got[1] == want[1], utt
        assert abs(got[2] - want[2]) <= 1e-4 * max(1.0, abs(want[2]))


def test_concurrent_connections_equal_sequential(system, streaming):
    s = system
    _net, make_scorer, refs = streaming
    names = dict(enumerate(s["words"]))
    server = TcpDecodeServer(
        s["fst"], s["tm"], None, names,
        lambda: POF.OnlineFeaturePipeline(POF.OnlineFeature(
            port_opts(s["spec"].fs), device="cpu")),
        samp_freq=s["spec"].fs, acoustic_scale=1.0, make_scorer=make_scorer,
        decoder_opts=FasterDecoderOptions(beam=15.0))
    server.start()
    utts = sorted(s["waves"])
    try:
        seq = {u: client(server.host, server.port, s["waves"][u])
               for u in utts}
        conc = {}

        def run(u):
            conc[u] = client(server.host, server.port, s["waves"][u])

        threads = [threading.Thread(target=run, args=(u,)) for u in utts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    finally:
        server.shutdown()
    assert len(utts) == 4 and conc == seq
    for u in utts:
        assert finals(seq[u]) == [names[w] for w in refs[u][1]]
        assert seq[u].count("\n") == 1 and "\r" in seq[u]
    assert not server.errors and server.num_served == 8
    assert server.stats["utterances"] == 8 and server.stats["frames"] > 0
    with pytest.raises(ValueError, match="one of"):
        TcpDecodeServer(s["fst"], s["tm"], None, names, lambda: None)


def test_scorer_error_is_not_swallowed(system):
    s = system

    def broken(feats):
        raise RuntimeError("scorer failed")

    server = TcpDecodeServer(
        s["fst"], s["tm"], broken, dict(enumerate(s["words"])),
        lambda: POF.OnlineFeaturePipeline(POF.OnlineFeature(
            port_opts(s["spec"].fs), device="cpu")),
        samp_freq=s["spec"].fs)
    server.start()
    try:
        reply = client(server.host, server.port,
                       next(iter(s["waves"].values())))
    finally:
        server.shutdown()
    assert "\n" not in reply
    assert len(server.errors) == 1 and "scorer failed" in server.errors[0][1]
    assert server.num_served == 1


def run_tool(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, **kw)


def test_tcp_cli_serves_n_connections(system, streaming):
    s = system
    _net, _make, refs = streaming
    utts = sorted(s["waves"])[:3]
    proc = run_tool(["online2-tcp-nnet3-decode-faster", "--use-gpu=no",
                     "--num-connections=3", "--port-num=0",
                     "--samp-freq=16000", *CEPS, s["mdl"],
                     os.path.join(s["dir"], "HCLG.fst"),
                     os.path.join(s["dir"], "words.txt")])
    try:
        line = proc.stdout.readline()
        assert line.startswith("# listening on"), proc.stderr.read()
        host, port = line.split()[-1].rsplit(":", 1)
        replies = {}

        def run(u):
            replies[u] = client(host, int(port), s["waves"][u])

        threads = [threading.Thread(target=run, args=(u,)) for u in utts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        _out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    names = dict(enumerate(s["words"]))
    for u in utts:
        assert finals(replies[u]) == [names[w] for w in refs[u][1]]
    assert '"connections": 3' in err and '"errors": 0' in err


def test_wav_tools(system, streaming, tmp_path):
    s = system
    _net, _make, refs = streaming
    out = tmp_path / "words.ark"
    rc = get_tool("online2-wav-nnet3-latgen-faster")(
        ["online2-wav-nnet3-latgen-faster", "--use-gpu=no", *CEPS,
         s["mdl"], os.path.join(s["dir"], "HCLG.fst"),
         f"ark:{os.path.join(s['dir'], 'wav.ark')}", f"ark:{out}"])
    assert rc == 0
    got = dict(SequentialTableReader("int-vector", f"ark:{out}"))
    assert {u: list(v) for u, v in got.items()} == \
        {u: r[1] for u, r in refs.items()}
    # the dumped online features against the JAX tool's
    feats = {}
    for who, tool, opts in (("port", get_tool, ["--use-gpu=no"]),
                            ("jax", jax_tool, [])):
        path = tmp_path / f"{who}.ark"
        assert tool("online2-wav-dump-features")(
            ["online2-wav-dump-features", *opts, *CEPS, "--chunk-length=0.07",
             f"ark:{os.path.join(s['dir'], 'wav.ark')}",
             f"ark:{path}"]) == 0
        feats[who] = dict(SequentialTableReader("matrix", f"ark:{path}"))
    assert sorted(feats["port"]) == sorted(feats["jax"]) == sorted(refs)
    for u in refs:
        np.testing.assert_allclose(feats["port"][u], feats["jax"][u],
                                   atol=2e-3, rtol=1e-4)


def test_tools_refuse(system, tmp_path, monkeypatch, capsys):
    """--use-gpu=yes without CUDA, a raw model, a component without a
    torch mapping and a dither the frontend refuses each end the tools
    with a nonzero status (through the dispatcher) or an error."""
    from kaldi_tpu_torch.cli.__main__ import main
    from test_torch_nnet3_mdl_io import COMPONENTS, make
    s = system

    def cli(*args):
        monkeypatch.setattr(sys, "argv", ["kaldi_tpu_torch.cli", *args])
        capsys.readouterr()
        rc = main()
        return rc, capsys.readouterr().err

    graph_args = [os.path.join(s["dir"], "HCLG.fst"),
                  f"ark:{os.path.join(s['dir'], 'wav.ark')}",
                  f"ark:{tmp_path / 'w.ark'}"]
    tool = "online2-wav-nnet3-latgen-faster"
    if not torch.cuda.is_available():
        rc, err = cli(tool, *CEPS, s["mdl"], *graph_args)
        assert rc != 0 and "CUDA" in err
        rc, err = cli("online2-tcp-nnet3-decode-faster", "--use-gpu=yes",
                      "--port-num=0", *CEPS, s["mdl"], graph_args[0],
                      os.path.join(s["dir"], "words.txt"))
        assert rc != 0 and "CUDA" in err
    _tm, graph, _info = PM.read_nnet3_am(s["mdl"])
    raw = str(tmp_path / "final.raw")
    PM.write_raw_nnet3(graph, raw)
    assert cli(tool, "--use-gpu=no", *CEPS, raw, *graph_args)[0] == 1
    comp = make(PM, "DropoutMaskComponent",
                dict(COMPONENTS)["DropoutMaskComponent"])
    nodes = [PM.Node("input", "input", dim=13),
             PM.Node("component", "m", component="m",
                     desc=PM.parse_descriptor("input")),
             PM.Node("output", "output", desc=PM.parse_descriptor("m"))]
    bad = str(tmp_path / "bad.mdl")
    PM.write_nnet3_am(bad, s["tm"], PM.Nnet3Graph(nodes, {"m": comp}))
    for args in ([tool, "--use-gpu=no", *CEPS, bad, *graph_args],
                 ["online2-tcp-nnet3-decode-faster", "--use-gpu=no",
                  "--port-num=0", *CEPS, bad, graph_args[0],
                  os.path.join(s["dir"], "words.txt")]):
        rc, err = cli(*args)
        assert rc != 0 and "no torch mapping" in err
    rc, err = cli(tool, "--use-gpu=no", "--dither=1", s["mdl"], *graph_args)
    assert rc != 0 and "dither" in err
