"""Port parity of online decoding: kaldi_tpu_torch/online/decoding.py and
decoder/viterbi.py best_path_through against kaldi_tpu/online/decoding.py
and kaldi_tpu/decoder/viterbi.py, on the CPU.

The graph is the flat form of a small legacy LexChainGraph (the quick
bench spec, each package building its own from the same corpus, with
the chain transition model of chain_tm_tree_for and optional silence).
Continuous random loglikes are fed in random chunks: after every chunk
OnlineFasterDecoder's best paths (with and without final weights) have
equal words and tids and costs within 1e-4 relative, the same frames
decoded, and the same relative final cost; endpoint_detected gives the
same answer after every chunk with the silence phone set (loglikes that
drift into silence make the rules fire).  SingleUtteranceDecoder does
the same over each package's feature pipeline and one linear scorer of
each chunk.  best_path_through equals the JAX package's."""

import numpy as np
import pytest

from kaldi_tpu.decoder import viterbi as JV
from kaldi_tpu.feat.frontend import MfccOptions as JaxMfcc
from kaldi_tpu.feat.window import FrameExtractionOptions as JaxFrames
from kaldi_tpu.online import decoding as JD
from kaldi_tpu.online import features as JOF
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu_torch.decoder import viterbi as PV
from kaldi_tpu_torch.feat.frontend import MfccOptions
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.online import decoding as PD
from kaldi_tpu_torch.online import features as POF
from kaldi_tpu_torch.recipes import bench_corpus as tbc

REL = 1e-4
QUICK = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
             words_per_utt=5, num_train=2, num_test=4, num_lm_sents=80)


def build_system(bc):
    spec = bc.BenchCorpusSpec(**QUICK)
    lexicon, _, _, test_txt, test_wav, lm_text = bc.make_corpus(
        spec, train_audio=False)
    lang, tm, tree = bc.chain_tm_tree_for(lexicon)
    g = bc.build_decode_graph(lexicon, lm_text, tm, tree, lang=lang)
    return dict(spec=spec, fst=g.to_flat_graph().to_vector_fst(), tm=tm,
                sil=lang.phones[lang.sil_phone], test_wav=test_wav)


@pytest.fixture(scope="module")
def systems():
    return build_system(tbc), build_system(jbc)


def same_result(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got[0] == want[0] and got[1] == want[1]
    assert abs(got[2] - want[2]) <= REL * max(1.0, abs(want[2]))


def silence_drift(tm, sil, T, P, seed):
    """Random loglikes whose last third favours the silence phone's
    pdfs, so the best path ends in trailing silence."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(size=(T, P)).astype(np.float32) * 2
    sil_pdfs = {int(tm.id2pdf_id[t]) for t in range(1, len(tm.id2pdf_id))
                if tm.transition_id_to_phone(t) == sil}
    ll[2 * T // 3:, sorted(sil_pdfs)] += 6.0
    return ll


def chunks(T, rng):
    pos = 0
    while pos < T:
        n = int(rng.integers(1, 9))
        yield pos, min(T, pos + n)
        pos += n


@pytest.mark.parametrize("beam", [6.0, 16.0])
@pytest.mark.parametrize("seed", range(3))
def test_online_faster_decoder_chunks_match_jax(systems, seed, beam):
    ps, js = systems
    P = int(ps["tm"].id2pdf_id.max()) + 1
    T = 60
    ll = silence_drift(ps["tm"], ps["sil"], T, P, seed)
    pd = PD.OnlineFasterDecoder(ps["fst"], PV.FasterDecoderOptions(beam=beam))
    jd = JD.OnlineFasterDecoder(js["fst"], JV.FasterDecoderOptions(beam=beam))
    config = PD.OnlineEndpointConfig(silence_phones=[ps["sil"]])
    jconfig = JD.OnlineEndpointConfig(silence_phones=[js["sil"]])
    for r, jr in zip(config.rules()[1:4], jconfig.rules()[1:4]):
        r.min_trailing_silence = jr.min_trailing_silence = 0.05
    fired = []
    rng = np.random.default_rng(seed + 50)
    for lo, hi in chunks(T, rng):
        wip = 0.5 if seed == 2 else 0.0
        pd.advance_decoding(ll[lo:hi], ps["tm"].id2pdf_id, 0.8, wip)
        jd.advance_decoding(ll[lo:hi], js["tm"].id2pdf_id, 0.8, wip)
        assert pd.num_frames_decoded == jd.num_frames_decoded == hi
        for final in (False, True):
            same_result(pd.best_path(final), jd.best_path(final))
        rc, jrc = pd.final_relative_cost(), jd.final_relative_cost()
        assert rc == jrc or abs(rc - jrc) <= REL * max(1.0, abs(jrc))
        got = PD.endpoint_detected(config, ps["tm"], pd, 0.03)
        assert got == JD.endpoint_detected(jconfig, js["tm"], jd, 0.03)
        fired.append(got)
    assert fired[-1] and not fired[0]
    ali = pd.best_path(False)[0]
    assert PD.trailing_silence_frames(ps["tm"], ali, [ps["sil"]]) == \
        JD.trailing_silence_frames(js["tm"], ali, [js["sil"]]) > 0
    # default rules with no silence phone: only rule 5 (20 s) can fire
    assert not PD.endpoint_detected(PD.OnlineEndpointConfig(), ps["tm"], pd,
                                    0.03)
    pd.init_decoding()
    assert pd.num_frames_decoded == 0 and pd.best_path(False)[1] == []
    assert not PD.endpoint_detected(config, ps["tm"], pd, 0.03)


def test_online_decoder_equals_offline_and_best_path_through(systems):
    ps, js = systems
    P = int(ps["tm"].id2pdf_id.max()) + 1
    ll = np.random.default_rng(8).normal(size=(40, P)).astype(np.float32)
    opts = PV.FasterDecoderOptions(beam=12.0)
    pd = PD.OnlineFasterDecoder(ps["fst"], opts)
    for lo in range(0, 40, 7):
        pd.advance_decoding(ll[lo:lo + 7], ps["tm"].id2pdf_id)
    same_result(pd.best_path(True), PV.FasterDecoder(ps["fst"], opts).decode(
        ll, ps["tm"].id2pdf_id))
    exact = PV.best_path_through(ps["fst"], ll, ps["tm"].id2pdf_id, 0.7)
    same_result(exact, JV.best_path_through(js["fst"], ll,
                                            js["tm"].id2pdf_id, 0.7))
    assert len(exact[0]) == 40
    # a graph with no final state reachable: no path through it
    ps["fst"].finals, saved = [float("inf")] * ps["fst"].num_states, \
        ps["fst"].finals
    try:
        assert PV.best_path_through(ps["fst"], ll, ps["tm"].id2pdf_id) \
            is None
    finally:
        ps["fst"].finals = saved


def pipelines(spec):
    p = MfccOptions(frame_opts=FrameExtractionOptions(samp_freq=spec.fs,
                                                      dither=0.0))
    j = JaxMfcc(frame_opts=JaxFrames(samp_freq=spec.fs, dither=0.0))
    return (POF.OnlineFeaturePipeline(POF.OnlineFeature(p, device="cpu")),
            JOF.OnlineFeaturePipeline(JOF.OnlineFeature(j)))


@pytest.mark.parametrize("utt", range(2))
def test_single_utterance_decoder_matches_jax(systems, utt):
    """Each package's MFCC pipeline and one linear scorer of each chunk
    of features alone (the reference's scorer form): equal partial and
    final results after every piece of audio, and the endpoint answer."""
    ps, js = systems
    P = int(ps["tm"].id2pdf_id.max()) + 1
    rng = np.random.default_rng(utt)
    W = rng.normal(size=(13, P)).astype(np.float32) * 0.2
    key = sorted(ps["test_wav"])[utt]
    wave = np.asarray(ps["test_wav"][key], np.float32)
    pp, jp = pipelines(ps["spec"])
    opts = dict(acoustic_scale=0.5)
    pdec = PD.SingleUtteranceDecoder(ps["fst"], ps["tm"], lambda f: f @ W,
                                     pp, opts=PV.FasterDecoderOptions(10.0),
                                     **opts)
    jdec = JD.SingleUtteranceDecoder(js["fst"], js["tm"], lambda f: f @ W,
                                     jp, opts=JV.FasterDecoderOptions(10.0),
                                     **opts)
    config = PD.OnlineEndpointConfig(silence_phones=[ps["sil"]])
    jconfig = JD.OnlineEndpointConfig(silence_phones=[js["sil"]])
    pos, fs = 0, ps["spec"].fs
    while pos < len(wave):
        n = int(rng.integers(400, 6000))
        pp.accept_waveform(fs, wave[pos:pos + n])
        jp.accept_waveform(fs, wave[pos:pos + n])
        pos += n
        pdec.advance_decoding()
        jdec.advance_decoding()
        same_result(pdec.decoder.best_path(False),
                    jdec.decoder.best_path(False))
        assert pdec.endpoint_detected(config) == \
            jdec.endpoint_detected(jconfig)
    pp.input_finished()
    jp.input_finished()
    pdec.advance_decoding()
    jdec.advance_decoding()
    same_result(pdec.finalize_decoding(), jdec.finalize_decoding())
    assert pdec.decoder.num_frames_decoded == \
        jdec.decoder.num_frames_decoded == pdec.frames > 0
    assert pdec.chunks > 1 and pdec.scorer_s > 0 and pdec.search_s > 0
