"""Port parity: the batched online pipeline of kaldi_tpu_torch
(`online/batched_device_pipeline.py`, `online/features.py`,
`online/decoding.py`, the online i-vector state) against the JAX
reference, on the CPU.

The same seeded numpy inputs and the same arrival schedule go through
the JAX pipeline (`BlockChainDecoder(interpret=True)`, Pallas kernel a in
interpret mode; `LexChainDecoder`; `NgramLexDecoder`) and the port's
(`device="cpu"`): each
lane's words and tids must be equal and its cost within 1e-4 relative.
The port's streaming results must also equal its own offline
`decode_batch` of the same loglikes exactly: the carry resumes the frame
loop bit for bit.  Features: atol 2e-3 / rtol 1e-4 (the feature bar);
i-vectors: rtol 1e-4 / atol 3e-4 (tests/test_torch_ivector.py)."""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.block_chain import BlockChainDecoder as JaxBcDecoder
from kaldi_tpu.decoder.lexchain import LexChainDecoder as JaxLexDecoder
from kaldi_tpu.decoder.lexchain_ng import NgramLexDecoder as JaxNgDecoder
from kaldi_tpu.ivector.batched import BatchedIvectorExtractor as JaxIvec
from kaldi_tpu.online import batched_device_pipeline as jbp
from kaldi_tpu.online.decoding import EndpointRule as JaxRule
from kaldi_tpu.online.decoding import OnlineEndpointConfig as JaxConfig
from kaldi_tpu.online.features import OnlineFeature as JaxOnlineFeature
from kaldi_tpu.recipes.bench_corpus import BenchCorpusSpec, mfcc_options
from kaldi_tpu.recipes.bench_corpus import \
    load_ivector_extractor as jax_load_ivec
from kaldi_tpu_torch.decoder.block_chain import BlockChainDecoder
from kaldi_tpu_torch.decoder.lexchain import LexChainDecoder
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexDecoder
from kaldi_tpu_torch.feat.frontend import OfflineFeature
from kaldi_tpu_torch.ivector.batched import BatchedIvectorExtractor
from kaldi_tpu_torch.online import batched_device_pipeline as tbp
from kaldi_tpu_torch.online.decoding import (EndpointRule,
                                             OnlineEndpointConfig)
from kaldi_tpu_torch.online.features import OnlineFeature
from kaldi_tpu_torch.recipes.bench_corpus import load_ivector_extractor
from tests.test_torch_block_chain import graphs as bc_graphs
from tests.test_torch_frontend import bench_options, waves
from tests.test_torch_ivector import IVEC, feats_like_ubm
from tests.test_torch_lexchain import graphs as lex_graphs
from tests.test_torch_lexchain_ng import graphs as ng_graphs

REL = 1e-4


def identity_scorer(feats):
    return feats           # the features ARE the loglikes here


def assert_same(got, want, what, exact=False):
    """Per lane: equal words and tids; costs within REL (or equal)."""
    assert len(got) == len(want)
    for b, (o, r) in enumerate(zip(got, want)):
        assert (o is None) == (r is None), f"{what} lane {b}"
        if r is None:
            continue
        assert list(o[0]) == list(r[0]), f"{what} lane {b} words"
        assert list(o[1]) == list(r[1]), f"{what} lane {b} tids"
        if exact:
            assert o[2] == r[2], f"{what} lane {b} cost"
        else:
            assert abs(o[2] - r[2]) <= REL * max(1.0, abs(r[2])), \
                f"{what} lane {b} cost {o[2]} vs {r[2]}"


def schedule(rng, lens, idle=0.0):
    """Ragged arrivals: per round, per unfinished lane, a piece of 1-4
    frames (none with probability `idle`) -> list of rounds of (lane,
    start, n)."""
    rounds, cur = [], [0] * len(lens)
    while any(c < n for c, n in zip(cur, lens)):
        step = []
        for b, n in enumerate(lens):
            if cur[b] < n and rng.random() >= idle:
                k = min(int(rng.integers(1, 5)), n - cur[b])
                step.append((b, cur[b], k))
                cur[b] += k
        rounds.append(step)
    return rounds


def stream(pipe, lls, rounds, finish=False):
    """Feed the schedule, one compute() a round, drain, finalize all."""
    for b in range(len(lls)):
        pipe.init_channel(b, f"utt{b}")
    for step in rounds:
        for b, c, k in step:
            pipe.accept_features(b, lls[b][c:c + k])
        pipe.compute()
    if finish:
        for b in range(len(lls)):
            pipe.input_finished(b)
    while pipe.compute():
        pass
    return [pipe.finalize(b) for b in range(len(lls))]


def padded(lls, P):
    batch = np.zeros((len(lls), max(len(x) for x in lls), P), np.float32)
    for b, x in enumerate(lls):
        batch[b, :len(x)] = x
    return batch, [len(x) for x in lls]


# --- the base pipeline over the block-chain decoder (kernel a) ---------
def bc_system(seed):
    jg, tg = bc_graphs(seed)
    return (JaxBcDecoder(jg, interpret=True),
            BlockChainDecoder(tg, device="cpu"), tg)


@pytest.mark.parametrize("seed,idle", [(0, 0.0), (1, 0.3)])
def test_ragged_arrivals_match_jax_and_offline(seed, idle):
    jdec, tdec, g = bc_system(seed)
    rng = np.random.default_rng(seed + 7)
    lens = [11, 7, 9]
    lls = [rng.normal(size=(T, g.num_pdfs)).astype(np.float32)
           for T in lens]
    rounds = schedule(rng, lens, idle)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=3, chunk_frames=4)
    want = stream(jbp.BatchedDeviceOnlinePipeline(jdec, identity_scorer,
                                                  **kw), lls, rounds)
    pipe = tbp.BatchedDeviceOnlinePipeline(tdec, identity_scorer, **kw)
    got = stream(pipe, lls, rounds)
    assert_same(got, want, "jax")
    batch, lengths = padded(lls, g.num_pdfs)
    assert_same(got, tdec.decode_batch(batch, lengths=lengths), "offline",
                exact=True)
    assert pipe._history()["bits"].shape[0] == pipe._total_frames


def test_partials_and_lane_reuse():
    jdec, tdec, g = bc_system(0)
    rng = np.random.default_rng(11)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4)
    ll1 = rng.normal(size=(8, g.num_pdfs)).astype(np.float32)
    ll2 = rng.normal(size=(6, g.num_pdfs)).astype(np.float32)

    def drive(pipe):
        seen = []
        pipe.init_channel(0, "a")
        pipe.accept_features(0, ll1[:4])
        pipe.compute()
        seen.append(pipe.get_partial(0))
        pipe.accept_features(0, ll1[4:])
        pipe.compute()
        seen.append(pipe.finalize(0))
        pipe.free_channel(0)
        pipe.init_channel(0, "b")          # lane 0 reused, lane 1 idle
        pipe.accept_features(0, ll2)
        while pipe.compute():
            pass
        seen.append(pipe.finalize(0))
        seen.append(pipe.get_partial(1))
        return seen

    want = drive(jbp.BatchedDeviceOnlinePipeline(jdec, identity_scorer,
                                                 **kw))
    got = drive(tbp.BatchedDeviceOnlinePipeline(tdec, identity_scorer,
                                                **kw))
    assert got[0] is not None and len(got[0][1]) == 4
    assert got[3] is None and want[3] is None
    assert_same(got[:3], want[:3], "jax")
    offline = [tdec.decode_batch(ll[None])[0] for ll in (ll1, ll2)]
    assert_same([got[1], got[2]], offline, "offline", exact=True)


def test_rotating_lanes_trim_past_max_frames():
    """8 overlapping utterances through 2 lanes: 96 frames plus chunk
    padding in a session of max_frames=48 streams only because the
    history before the earliest active start is dropped."""
    jdec, tdec, g = bc_system(0)
    rng = np.random.default_rng(3)
    max_frames, n_utt, T_u = 48, 8, 12
    lls = [rng.normal(size=(T_u, g.num_pdfs)).astype(np.float32)
           for _ in range(n_utt)]
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4,
              max_frames=max_frames)

    def drive(pipe, windows):
        results = [None] * n_utt
        pipe.init_channel(0, "u0")
        pipe.accept_features(0, lls[0])
        while pipe.compute():
            pass
        for i in range(1, n_utt):
            lane, prev_lane = i % 2, (i - 1) % 2
            pipe.init_channel(lane, f"u{i}")   # starts before i-1 is freed
            pipe.accept_features(lane, lls[i])
            while pipe.compute():
                pass
            results[i - 1] = pipe.finalize(prev_lane)
            pipe.free_channel(prev_lane)
            windows.append(pipe._total_frames)
        results[-1] = pipe.finalize((n_utt - 1) % 2)
        pipe.free_channel((n_utt - 1) % 2)
        return results

    want = drive(jbp.BatchedDeviceOnlinePipeline(jdec, identity_scorer,
                                                 **kw), [])
    windows = []
    pipe = tbp.BatchedDeviceOnlinePipeline(tdec, identity_scorer, **kw)
    got = drive(pipe, windows)
    assert n_utt * T_u > max_frames and max(windows) <= max_frames
    assert pipe._total_frames == 0 and not pipe._ys
    assert_same(got, want, "jax")
    assert_same(got, [tdec.decode_batch(ll[None])[0] for ll in lls],
                "offline", exact=True)


def test_max_frames_raises():
    _, tdec, g = bc_system(0)
    pipe = tbp.BatchedDeviceOnlinePipeline(
        tdec, identity_scorer, feat_dim=g.num_pdfs, num_lanes=1,
        chunk_frames=4, max_frames=8)
    pipe.init_channel(0, "u")
    pipe.accept_features(0, np.zeros((12, g.num_pdfs), np.float32))
    assert pipe.compute() == 1 and pipe.compute() == 1
    with pytest.raises(RuntimeError, match="max_frames"):
        pipe.compute()
    with pytest.raises(ValueError):
        pipe.accept_features(0, np.zeros((2, 3), np.float32))


def test_block_chain_endpointing_tracks_without_changing_results():
    """The reference's block-chain pipeline raises NotImplementedError in
    compute() with endpointing=True (its _current_best is shadowed); the
    port's tracks each lane's relative cost and gives the same
    results."""
    _, tdec, g = bc_system(1)
    rng = np.random.default_rng(5)
    lens = [9, 6]
    lls = [rng.normal(size=(T, g.num_pdfs)).astype(np.float32)
           for T in lens]
    rounds = schedule(rng, lens)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4)
    plain = stream(tbp.BatchedDeviceOnlinePipeline(
        tdec, identity_scorer, **kw), lls, rounds)
    pipe = tbp.BatchedDeviceOnlinePipeline(tdec, identity_scorer,
                                           endpointing=True, **kw)
    assert_same(stream(pipe, lls, rounds), plain, "endpointing",
                exact=True)
    rel = pipe._last_rel_cost
    assert rel.shape == (2,) and np.all(np.isfinite(rel)) and \
        np.all(rel >= 0)
    assert not pipe.endpoint_detected(0, OnlineEndpointConfig())
    assert pipe.endpoint_detected(0, OnlineEndpointConfig(
        rule5=EndpointRule(False, 0.0, float("inf"), 0.1)))


# --- the LexChain pipeline (exact search) --------------------------------
def lex_system(seed, use_sil):
    """The reference test's graph: V=7, a second variant, silence phone
    4 (test_batched_device_online.py::test_lexchain_streaming_...)."""
    jg, tg, _ = lex_graphs(seed, use_sil=use_sil, sil_phone=4)
    return JaxLexDecoder(jg), LexChainDecoder(tg, device="cpu"), tg


@pytest.mark.parametrize("seed,use_sil,idle", [(0, False, 0.0),
                                               (0, True, 0.3),
                                               (1, True, 0.0),
                                               (2, False, 0.3)])
def test_lex_streaming_matches_jax_and_offline(seed, use_sil, idle):
    """Ragged pieces of 1-4 frames with idle lanes: the port's Lex
    pipeline gives JAX's results, and bit for bit its own decode_batch
    of the same loglikes."""
    jdec, tdec, g = lex_system(seed, use_sil)
    rng = np.random.default_rng(seed + 30)
    lens = [11, 7, 9]
    lls = [rng.normal(size=(T, g.num_pdfs)).astype(np.float32)
           for T in lens]
    rounds = schedule(rng, lens, idle)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=3, chunk_frames=4)
    want = stream(jbp.BatchedDeviceOnlinePipelineLex(
        jdec, identity_scorer, **kw), lls, rounds)
    pipe = tbp.BatchedDeviceOnlinePipelineLex(tdec, identity_scorer, **kw)
    got = stream(pipe, lls, rounds)
    assert_same(got, want, "jax")
    batch, lengths = padded(lls, g.num_pdfs)
    assert_same(got, tdec.decode_batch(batch, lengths=lengths), "offline",
                exact=True)
    assert pipe._history()["bits"].shape[0] == pipe._total_frames


@pytest.mark.parametrize("use_sil", [False, True])
def test_lex_partials_and_lane_reuse(use_sil):
    """A partial result, a lane freed and bound again to a new utterance
    while the other lane idles: JAX's results, and each final one equal
    to decode_batch of its utterance alone."""
    jdec, tdec, g = lex_system(1, use_sil)
    rng = np.random.default_rng(12)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4)
    ll1 = rng.normal(size=(8, g.num_pdfs)).astype(np.float32)
    ll2 = rng.normal(size=(6, g.num_pdfs)).astype(np.float32)

    def drive(pipe):
        seen = []
        pipe.init_channel(0, "a")
        pipe.accept_features(0, ll1[:4])
        pipe.compute()
        seen.append(pipe.get_partial(0))
        pipe.accept_features(0, ll1[4:])
        pipe.compute()
        seen.append(pipe.finalize(0))
        pipe.free_channel(0)
        pipe.init_channel(0, "b")          # lane 0 reused, lane 1 idle
        pipe.accept_features(0, ll2)
        while pipe.compute():
            pass
        seen.append(pipe.finalize(0))
        seen.append(pipe.get_partial(1))
        return seen

    want = drive(jbp.BatchedDeviceOnlinePipelineLex(jdec, identity_scorer,
                                                    **kw))
    got = drive(tbp.BatchedDeviceOnlinePipelineLex(tdec, identity_scorer,
                                                   **kw))
    assert got[0] is not None and len(got[0][1]) == 4
    assert got[3] is None and want[3] is None
    assert_same(got[:3], want[:3], "jax")
    offline = [tdec.decode_batch(ll[None])[0] for ll in (ll1, ll2)]
    assert_same([got[1], got[2]], offline, "offline", exact=True)


def test_lex_endpoint_rotation_with_silence():
    """Utterances with trailing silence through 2 lanes of the Lex
    pipeline under OnlineDynamicBatcher: the port ends the same
    utterances at the same frames as JAX, with the same results, each
    equal to decode_batch of the frames its lane consumed."""
    jdec, tdec, g = lex_system(2, True)
    utts = make_utts(g, np.random.default_rng(6), 6, sil_tail=8)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4,
              endpointing=True)
    runs = []
    for mod, dec, Config, Rule in ((jbp, jdec, JaxConfig, JaxRule),
                                   (tbp, tdec, OnlineEndpointConfig,
                                    EndpointRule)):
        pipe = mod.BatchedDeviceOnlinePipelineLex(dec, identity_scorer,
                                                  **kw)
        consumed = {}
        finalize = pipe.finalize

        def wrapped(lane, _pipe=pipe, _seen=consumed, _fin=finalize):
            ch = _pipe.channels[lane]
            _seen[ch.utterance_id] = ch.end_frame - ch.start_frame
            return _fin(lane)

        pipe.finalize = wrapped
        batcher = mod.OnlineDynamicBatcher(
            pipe, endpoint_config=rule_config(Config, Rule, rule2=4.0),
            frame_shift=1.0)
        for i, ll in enumerate(utts):
            batcher.push(f"u{i:02d}", ll)
        runs.append((batcher.run(), batcher.endpointed, consumed,
                     pipe._last_rel_cost))
    (want, jep, jcons, jrel), (got, tep, tcons, trel) = runs
    ids = [f"u{i:02d}" for i in range(len(utts))]
    assert sorted(got) == ids and tep == jep and tcons == jcons
    assert any(tep.values()), "no endpoint fired on trailing silence"
    assert_same([got[i] for i in ids], [want[i] for i in ids], "jax")
    np.testing.assert_allclose(trel, jrel, rtol=REL, atol=REL)
    batch, lengths = padded([u[:tcons[i]] for i, u in zip(ids, utts)],
                            g.num_pdfs)
    assert_same([got[i] for i in ids],
                tdec.decode_batch(batch, lengths=lengths), "offline",
                exact=True)


def test_lex_endpoint_rules_on_silence():
    """An utterance of silence only: rule 2 (non-silence needed) does not
    fire, rule 1 does, and the trackers equal JAX's."""
    jdec, tdec, g = lex_system(0, True)
    rng = np.random.default_rng(9)
    ll = rng.normal(size=(16, g.num_pdfs)).astype(np.float32) - 4.0
    ll[:, g.sil_pdf_fwd] += 8.0
    ll[:, g.sil_pdf_self] += 8.0
    verdicts = []
    for mod, dec, Config, Rule in ((jbp, jdec, JaxConfig, JaxRule),
                                   (tbp, tdec, OnlineEndpointConfig,
                                    EndpointRule)):
        pipe = mod.BatchedDeviceOnlinePipelineLex(
            dec, identity_scorer, feat_dim=g.num_pdfs, num_lanes=1,
            chunk_frames=4, endpointing=True)
        pipe.init_channel(0, "sil_only")
        pipe.accept_features(0, ll)
        pipe.input_finished(0)
        while pipe.compute():
            pass
        ch = pipe.channels[0]
        verdicts.append((
            pipe.endpoint_detected(0, rule_config(Config, Rule, rule2=4.0),
                                   frame_shift=1.0),
            pipe.endpoint_detected(0, rule_config(Config, Rule, rule1=8.0),
                                   frame_shift=1.0),
            ch.trailing_sil, ch.nonsil_seen,
            float(pipe._last_rel_cost[0])))
    (j2, j1, jt, jn, jrel), (t2, t1, tt, tn, trel) = verdicts
    assert (t2, t1) == (False, True) == (j2, j1)
    assert (tt, tn) == (jt, jn) == (16, False)
    assert abs(trel - jrel) <= REL * max(1.0, abs(jrel))


# --- the n-gram pipeline, endpointing and the dynamic batcher -----------
@pytest.fixture(scope="module")
def ng_system():
    jg, tg, _ = ng_graphs(3, V=8, use_sil=True, ctx=3)
    return JaxNgDecoder(jg), NgramLexDecoder(tg, device="cpu"), tg


@pytest.mark.parametrize("pool", ["exact", "pruned"])
def test_ng_streaming_matches_jax_and_offline(ng_system, pool):
    jdec, tdec, g = ng_system
    rng = np.random.default_rng(21)
    lens = [11, 7, 9]
    lls = [rng.normal(size=(T, g.num_pdfs)).astype(np.float32)
           for T in lens]
    rounds = schedule(rng, lens, idle=0.2)
    search = (dict(prune_k=tdec.VC, prune_beam=1e9) if pool == "exact"
              else dict(prune_k=6, prune_beam=6.0))
    kw = dict(feat_dim=g.num_pdfs, num_lanes=3, chunk_frames=4, **search)
    want = stream(jbp.BatchedDeviceOnlinePipelineNg(jdec, identity_scorer,
                                                    **kw), lls, rounds,
                  finish=True)
    got = stream(tbp.BatchedDeviceOnlinePipelineNg(tdec, identity_scorer,
                                                   **kw), lls, rounds,
                 finish=True)
    assert_same(got, want, "jax")
    batch, lengths = padded(lls, g.num_pdfs)
    assert_same(got, tdec.decode_batch(batch, lengths=lengths, **search),
                "offline", exact=True)


def make_utts(g, rng, n, sil_tail):
    """Loglikes whose tail frames strongly favour the silence pdfs: real
    trailing silence for the endpoint rules to detect."""
    utts = []
    for _ in range(n):
        T = int(rng.integers(6, 10))
        ll = rng.normal(size=(T + sil_tail, g.num_pdfs)).astype(np.float32)
        ll[T:, :] -= 4.0
        ll[T:, g.sil_pdf_fwd] += 8.0
        ll[T:, g.sil_pdf_self] += 8.0
        utts.append(ll)
    return utts


def rule_config(Config, Rule, rule1=1e9, rule2=1e9):
    """Frames are abstract here (frame_shift=1): rule 1 (no
    non-silence needed) and rule 2 (non-silence needed) at the given
    trailing silence, the other rules off."""
    return Config(rule1=Rule(False, rule1, float("inf"), 0.0),
                  rule2=Rule(True, rule2, float("inf"), 0.0),
                  rule3=Rule(True, 1e9, 8.0, 0.0),
                  rule4=Rule(True, 1e9, float("inf"), 0.0),
                  rule5=Rule(False, 0.0, float("inf"), 1e9))


def test_ng_endpoint_rotation_4n_through_n(ng_system):
    """4N utterances with trailing silence through N lanes: the endpoint
    finalizes a lane and the batcher rebinds it mid-stream; the port
    finalizes the same utterances at the same frames as JAX, with the
    same results, each equal to the offline decode of the frames its
    lane consumed."""
    jdec, tdec, g = ng_system
    utts = make_utts(g, np.random.default_rng(4), 8, sil_tail=8)
    kw = dict(feat_dim=g.num_pdfs, num_lanes=2, chunk_frames=4,
              endpointing=True, prune_k=tdec.VC, prune_beam=1e9)
    runs = []
    for mod, dec, Config, Rule in ((jbp, jdec, JaxConfig, JaxRule),
                                   (tbp, tdec, OnlineEndpointConfig,
                                    EndpointRule)):
        pipe = mod.BatchedDeviceOnlinePipelineNg(dec, identity_scorer, **kw)
        consumed = {}
        finalize = pipe.finalize

        def wrapped(lane, _pipe=pipe, _seen=consumed, _fin=finalize):
            ch = _pipe.channels[lane]
            _seen[ch.utterance_id] = ch.end_frame - ch.start_frame
            return _fin(lane)

        pipe.finalize = wrapped
        batcher = mod.OnlineDynamicBatcher(
            pipe, endpoint_config=rule_config(Config, Rule, rule2=4.0),
            frame_shift=1.0)
        for i, ll in enumerate(utts):
            batcher.push(f"u{i:02d}", ll)
        runs.append((batcher.run(), batcher.endpointed, consumed))
    (want, jep, jcons), (got, tep, tcons) = runs
    ids = [f"u{i:02d}" for i in range(len(utts))]
    assert sorted(got) == ids and tep == jep and tcons == jcons
    assert any(tep.values()), "no endpoint fired on trailing silence"
    assert any(n < len(u) for n, u in zip(
        (tcons[i] for i in ids), utts)), "no utterance was cut"
    assert_same([got[i] for i in ids], [want[i] for i in ids], "jax")
    batch, lengths = padded([u[:tcons[i]] for i, u in zip(ids, utts)],
                            g.num_pdfs)
    assert_same([got[i] for i in ids],
                tdec.decode_batch(batch, lengths=lengths,
                                  prune_k=tdec.VC, prune_beam=1e9),
                "offline", exact=True)


def test_ng_endpoint_rules_on_silence(ng_system):
    """Rule 2 (non-silence needed) does not fire on an utterance that is
    silence from its start; rule 1 (pure silence) does: the port's
    trackers agree with JAX's."""
    jdec, tdec, g = ng_system
    rng = np.random.default_rng(9)
    ll = rng.normal(size=(16, g.num_pdfs)).astype(np.float32) - 4.0
    ll[:, g.sil_pdf_fwd] += 8.0
    ll[:, g.sil_pdf_self] += 8.0
    verdicts = []
    for mod, dec, Config, Rule in ((jbp, jdec, JaxConfig, JaxRule),
                                   (tbp, tdec, OnlineEndpointConfig,
                                    EndpointRule)):
        pipe = mod.BatchedDeviceOnlinePipelineNg(
            dec, identity_scorer, feat_dim=g.num_pdfs, num_lanes=1,
            chunk_frames=4, endpointing=True, prune_k=dec.VC,
            prune_beam=1e9)
        pipe.init_channel(0, "sil_only")
        pipe.accept_features(0, ll)
        pipe.input_finished(0)
        while pipe.compute():
            pass
        ch = pipe.channels[0]
        verdicts.append((
            pipe.endpoint_detected(0, rule_config(Config, Rule, rule2=4.0),
                                   frame_shift=1.0),
            pipe.endpoint_detected(0, rule_config(Config, Rule, rule1=8.0),
                                   frame_shift=1.0),
            ch.trailing_sil, ch.nonsil_seen,
            float(pipe._last_rel_cost[0])))
    (j2, j1, jt, jn, jrel), (t2, t1, tt, tn, trel) = verdicts
    assert (t2, t1) == (False, True) == (j2, j1)
    assert (tt, tn) == (jt, jn) == (16, False)
    assert abs(trel - jrel) <= REL * max(1.0, abs(jrel))


def test_endpoint_config_defaults_match_jax():
    got, want = OnlineEndpointConfig(), JaxConfig()
    for r, s in zip(got.rules(), want.rules()):
        assert (r.must_contain_nonsilence, r.min_trailing_silence,
                r.max_relative_cost, r.min_utterance_length) == \
            (s.must_contain_nonsilence, s.min_trailing_silence,
             s.max_relative_cost, s.min_utterance_length)
    for args in ((10.0, 0.6, 1.0, True), (10.0, 0.6, 3.0, True),
                 (1.0, 5.5, 9.0, False), (21.0, 0.0, 9.0, False)):
        assert [r.active(*args) for r in got.rules()] == \
            [s.active(*args) for s in want.rules()]


# --- streaming features --------------------------------------------------
def test_online_feature_matches_jax_piece_by_piece():
    wave = waves(4, [9731])[0].astype(np.int16)
    rng = np.random.default_rng(2)
    ref = JaxOnlineFeature(mfcc_options(BenchCorpusSpec()))
    feat = OnlineFeature(bench_options(), device="cpu")
    assert feat.dim() == ref.dim() == 40
    pos = 0
    while pos < len(wave):
        n = int(rng.integers(1, 1200))
        for f in (ref, feat):
            f.accept_waveform(16000.0, wave[pos:pos + n])
        pos += n
        assert feat.num_frames_ready() == ref.num_frames_ready()
    for f in (ref, feat):
        f.finish_input()
    n = feat.num_frames_ready()
    assert n == ref.num_frames_ready() == 59 and feat.is_last_frame(n - 1)
    np.testing.assert_allclose(feat.get_frames(range(n)),
                               np.asarray(ref.get_frames(range(n))),
                               atol=2e-3, rtol=1e-4)
    with pytest.raises(RuntimeError):
        feat.accept_waveform(16000.0, wave[:10])


def test_pipeline_waveform_input_feeds_online_features():
    """accept_waveform through the pipeline: the scorer sees each lane's
    streaming MFCC frames, equal to the offline extractor's."""
    _, tdec, g = bc_system(0)
    wave = waves(6, [8000])[0].astype(np.int16)
    seen = []
    proj = np.random.default_rng(0).normal(
        size=(40, g.num_pdfs)).astype(np.float32) * 1e-3

    def scorer(feats):
        seen.append(feats.copy())
        return feats @ proj

    pipe = tbp.BatchedDeviceOnlinePipeline(
        tdec, scorer, feat_dim=40, num_lanes=2, chunk_frames=8,
        feature_opts=bench_options())
    pipe.init_channel(1, "w")
    for c in range(0, len(wave), 1500):
        pipe.accept_waveform(1, 16000.0, wave[c:c + 1500])
        pipe.compute()
    pipe.input_finished(1)
    while pipe.compute():
        pass
    assert pipe.finalize(1) is not None and pipe.finalize(0) is None
    got = np.concatenate([f[1] for f in seen])
    act = np.concatenate(pipe._acts)[:, 1]
    feats, n = OfflineFeature(bench_options(), device="cpu") \
        .compute_batch_device([wave])
    np.testing.assert_allclose(got[act], feats[0, :int(n[0])].numpy(),
                               atol=2e-3, rtol=1e-4)
    assert not np.any(got[~act])


# --- the online i-vector state --------------------------------------------
@pytest.fixture(scope="module")
def ivecs():
    return (JaxIvec(jax_load_ivec(IVEC)),
            BatchedIvectorExtractor(load_ivector_extractor(IVEC),
                                    device="cpu"))


def test_online_ivector_chunks_match_jax_and_offline(ivecs):
    import jax.numpy as jnp
    ref, ex = ivecs
    feats = feats_like_ubm(3, 4, 64)
    lens = np.array([64, 50, 33, 7])
    jstate, tstate = ref.init_state(4), ex.init_state(4)
    for c0 in range(0, 64, 16):
        chunk = feats[:, c0:c0 + 16]
        mask = np.arange(c0, c0 + 16)[None, :] < lens[:, None]
        jstate = ref.acc_chunk(jstate, jnp.asarray(chunk),
                               jnp.asarray(mask))
        tstate = ex.acc_chunk(tstate, torch.from_numpy(chunk),
                              torch.from_numpy(mask))
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=3e-4 * float(np.abs(b).max()))
    got = ex.ivector(tstate).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.ivector(jstate)),
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(
        got, ex.extract_batch(torch.from_numpy(feats), lens).numpy(),
        rtol=1e-4, atol=3e-4)


def test_online_ivector_reset_and_weights_match_jax(ivecs):
    import jax.numpy as jnp
    ref, ex = ivecs
    f = feats_like_ubm(4, 2, 40)
    w = np.ones((2, 40), np.float32)
    w[1, 20:] = 0.0                       # lane 1: silence-weighted tail
    f[1, 20:] = 100.0
    mask = np.ones((2, 40), bool)
    jstate = ref.acc_chunk(ref.init_state(2), jnp.asarray(f),
                           jnp.asarray(mask), jnp.asarray(w))
    tstate = ex.acc_chunk(ex.init_state(2), torch.from_numpy(f),
                          torch.from_numpy(mask), torch.from_numpy(w))
    got = ex.ivector(tstate).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.ivector(jstate)),
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(
        got[1], ex.extract_batch(torch.from_numpy(f[1:, :20]))[0].numpy(),
        rtol=1e-4, atol=3e-4)
    done = np.array([False, True])
    jiv = np.asarray(ref.ivector(ref.reset_lanes(jstate,
                                                 jnp.asarray(done))))
    tiv = ex.ivector(ex.reset_lanes(tstate,
                                    torch.from_numpy(done))).numpy()
    np.testing.assert_allclose(tiv, jiv, rtol=1e-4, atol=3e-4)
    assert np.abs(tiv[0]).sum() > 1e-3
    np.testing.assert_allclose(tiv[1], 0.0, atol=1e-5)
