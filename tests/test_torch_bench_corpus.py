"""Port parity: the port's bench corpus and the host readers under it
against the JAX package, on the CPU.  At small specs the lexicon, texts,
waveforms and fingerprint must be equal to the JAX copy's (waves
bit-equal), and so must the MFCC options, the lang's symbol tables,
edit distances and WER.  The committed transition model and tree read
by the port's readers (binary, and the text form the JAX package
writes) must give the JAX package's tables and answers."""

import io
import os

import numpy as np
import pytest

from kaldi_tpu.hmm.transition_model import TransitionModel as JaxTm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.tree.context_dep import ContextDependency as JaxTree
from kaldi_tpu.util import kaldi_io as jaxio
from kaldi_tpu.util.edit_distance import edit_distance_counts as jax_ed
from kaldi_tpu_torch.base import io_funcs
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import ContextDependency
from kaldi_tpu_torch.util.edit_distance import edit_distance_counts
from kaldi_tpu_torch.util.kaldi_io import read_kaldi_object

ART = os.path.join(os.path.dirname(__file__), "..", "egs", "bench_corpus")
SPECS = [
    dict(vocab=40, num_phone_groups=4, phones_per_group=2, words_per_utt=5,
         num_train=3, num_test=3, num_lm_sents=60),
    dict(vocab=60, num_train=2, num_test=3, num_lm_sents=50, noise=1600.0,
         vec_text=True, num_speakers=3, warp_lo=0.97, warp_hi=1.03,
         log_spaced=True, min_pron=2, max_pron=5),
]


@pytest.mark.parametrize("kw", SPECS, ids=["v1_text", "vec_text_speakers"])
def test_corpus_matches_jax(kw):
    js, ts = jbc.BenchCorpusSpec(**kw), tbc.BenchCorpusSpec(**kw)
    assert jbc.phone_inventory(js) == tbc.phone_inventory(ts)
    for a, b in zip(jbc.speaker_params(js), tbc.speaker_params(ts)):
        np.testing.assert_array_equal(a, b)
    want, got = jbc.make_corpus(js), tbc.make_corpus(ts)
    for i in (0, 1, 3, 5):                  # lexicon, txt, txt, lm text
        assert got[i] == want[i], i
    for i in (2, 4):                        # train and test waves
        assert list(got[i]) == list(want[i])
        for u in want[i]:
            assert got[i][u].dtype == np.float32
            np.testing.assert_array_equal(got[i][u], want[i][u])
    fp = tbc.corpus_fingerprint(ts, got[0], got[3], got[4], got[5])
    assert fp == jbc.corpus_fingerprint(js, want[0], want[3], want[4],
                                        want[5])
    no_train = tbc.make_corpus(ts, train_audio=False)
    assert no_train[2] == {} and no_train[3] == got[3]


def test_bench_scale_spec_and_options_match_jax():
    assert vars(tbc.bench_scale_spec(vocab=77)) == \
        vars(jbc.bench_scale_spec(vocab=77))
    spec = tbc.bench_scale_spec()
    assert (spec.vocab, spec.num_lm_sents, spec.num_test) == \
        (20000, 600000, 128)
    for ceps in (40, 13):
        got = tbc.mfcc_options(spec, ceps)
        want = jbc.mfcc_options(jbc.bench_scale_spec(), ceps)
        # the port's option classes hold the fields it has ported
        for part in ("frame_opts", "mel_opts"):
            for name, value in vars(getattr(got, part)).items():
                assert getattr(getattr(want, part), name) == value, name
        for name in ("num_ceps", "use_energy", "energy_floor", "raw_energy",
                     "cepstral_lifter", "htk_compat"):
            assert getattr(got, name) == getattr(want, name), name


def test_lang_matches_jax():
    lex = tbc.make_lexicon(tbc.BenchCorpusSpec(**SPECS[1]))
    got, want = tbc.build_lang(lex), jbc.build_lang(lex)
    for name in ("phones", "phone_names", "words", "word_names"):
        assert getattr(got, name) == getattr(want, name), name


def test_edit_distance_and_wer_match_jax():
    rng = np.random.default_rng(4)
    refs, hyps = {}, {}
    for i in range(40):
        ref = [f"w{x}" for x in rng.integers(0, 6, int(rng.integers(0, 9)))]
        hyp = [f"w{x}" for x in rng.integers(0, 6, int(rng.integers(0, 9)))]
        assert edit_distance_counts(ref, hyp) == jax_ed(ref, hyp)
        refs[f"u{i}"] = ref
        if i % 7:
            hyps[f"u{i}"] = hyp
    assert edit_distance_counts(["a", "b"], ["a", "x", "b"]) == (1, 0, 0)
    assert tbc.wer_of(hyps, refs) == jbc.wer_of(hyps, refs)


def committed_models():
    tm = read_kaldi_object(TransitionModel.read,
                           os.path.join(ART, "flagship_ng.tm"))
    tree = read_kaldi_object(ContextDependency.read,
                             os.path.join(ART, "flagship_ng.tree"))
    jtm = jaxio.read_kaldi_object(JaxTm.read,
                                  os.path.join(ART, "flagship_ng.tm"))
    jtree = jaxio.read_kaldi_object(JaxTree.read,
                                    os.path.join(ART, "flagship_ng.tree"))
    return tm, tree, jtm, jtree


def assert_models_match(tm, tree, jtm, jtree):
    assert tm.tuples == jtm.tuples
    assert tm.num_transition_ids == jtm.num_transition_ids
    for name in ("state2id", "id2state", "id2pdf_id", "log_probs"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jtm, name),
                                      err_msg=name)
    assert tm.topo.phones == jtm.topo.phones
    assert tm.topo.phone2idx == jtm.topo.phone2idx
    assert [[(s.forward_pdf_class, s.self_loop_pdf_class, s.transitions)
             for s in e] for e in tm.topo.entries] == \
        [[(s.forward_pdf_class, s.self_loop_pdf_class, s.transitions)
          for s in e] for e in jtm.topo.entries]
    for ts in (1, 2, len(tm.tuples) // 2, len(tm.tuples)):
        assert tm.self_loop_of(ts) == jtm.self_loop_of(ts)
        assert tm.num_transition_indices(ts) == \
            jtm.num_transition_indices(ts)
        assert tm.tuple_to_transition_state(*tm.tuples[ts - 1]) == ts
        for idx in range(tm.num_transition_indices(ts)):
            tid = tm.pair_to_transition_id(ts, idx)
            assert tid == jtm.pair_to_transition_id(ts, idx)
            assert tm.is_self_loop(tid) == jtm.is_self_loop(tid)
            assert tm.get_transition_log_prob(tid) == \
                jtm.get_transition_log_prob(tid)
            assert tm.transition_id_to_pdf(tid) == \
                jtm.transition_id_to_pdf(tid)
    assert (tree.N, tree.P, tree.num_pdfs) == (jtree.N, jtree.P,
                                               jtree.num_pdfs)
    rng = np.random.default_rng(0)
    for _ in range(300):
        window = [int(x) for x in rng.integers(0, 32, tree.N)]
        for pc in (0, 1):
            assert tree.compute(window, pc) == jtree.compute(window, pc)


def test_committed_models_read_as_jax_reads_them():
    tm, tree, jtm, jtree = committed_models()
    assert tree.num_pdfs == 2000 and tree.N == 3 and tree.P == 1
    assert_models_match(tm, tree, jtm, jtree)
    with pytest.raises(ValueError, match="expected token"):
        TransitionModel.read(io.BytesIO(b"<Nope> "), False)


def test_text_form_reads_as_binary():
    """The JAX package's text writer, read back by the port."""
    _, _, jtm, jtree = committed_models()
    streams = {}
    for name, obj in (("tm", jtm), ("tree", jtree)):
        buf = io.BytesIO()
        obj.write(buf, False)
        streams[name] = io.BytesIO(buf.getvalue())
        assert not io_funcs.init_input_stream(streams[name])
    tm = TransitionModel.read(streams["tm"], False)
    tree = ContextDependency.read(streams["tree"], False)
    assert_models_match(tm, tree, jtm, jtree)


def test_basic_readers():
    data = io.BytesIO(b"\x00B\x04\x07\x00\x00\x00\xfc\x05\x00\x00\x00"
                      b"\x08" + np.float64(2.5).tobytes()
                      + b"FV \x04\x02\x00\x00\x00"
                      + np.asarray([1.5, -2], "<f4").tobytes() + b"tok ")
    assert io_funcs.init_input_stream(data)
    assert io_funcs.read_int32(data, True) == 7
    assert io_funcs.read_uint32(data, True) == 5
    assert io_funcs.read_float(data, True) == 2.5
    np.testing.assert_array_equal(io_funcs.read_vector(data, True),
                                  [1.5, -2.0])
    assert io_funcs.peek_token(data, True) == "tok"
    io_funcs.expect_token(data, True, "tok")
    text = io.BytesIO(b" 3 -4 0.25 [ 1 2 ] [ 0.5 1 ] ")
    assert not io_funcs.init_input_stream(text)
    assert io_funcs.read_int32(text, False) == 3
    assert io_funcs.read_uint32(text, False) == -4
    assert io_funcs.read_float(text, False) == 0.25
    assert io_funcs.read_int_vector(text, False) == [1, 2]
    np.testing.assert_array_equal(io_funcs.read_vector(text, False),
                                  [0.5, 1.0])
    with pytest.raises(ValueError, match="EOF"):
        io_funcs.read_token(text, False)
