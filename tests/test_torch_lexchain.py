"""Port parity: the LexChain graph and decoder of kaldi_tpu_torch against
the JAX reference (`kaldi_tpu/decoder/lexchain.py`), on the CPU.

The same seeded numpy inputs (the random lexicons and LMs of the
reference's tests/test_lexchain.py) go through both.  Graph tables and
the decoder's host tables are np.array_equal; decode_batch gives equal
words and tids and costs within 1e-4 relative, exact and pruned, with
and without optional silence, with synthetic and with monophone chain
(tm, tree) tables.  The port's decoder is also held against the port's
host FasterDecoder on `to_flat_graph()` (equal words and tids, cost
within 1e-3 * max(1, |cost|), the bar of the reference's own tests).
The inputs are continuous random loglikes, so no two paths tie in
cost."""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.lexchain import LexChainDecoder as JaxDecoder
from kaldi_tpu.decoder.lexchain import LexChainGraph as JaxGraph
from kaldi_tpu.hmm.topology import HmmTopology as JaxTopo
from kaldi_tpu.hmm.transition_model import TransitionModel as JaxTm
from kaldi_tpu.lm.bigram import BigramBackoffLm as JaxLm
from kaldi_tpu.recipes import bench_corpus as jbc
from kaldi_tpu.tree import monophone_context_dependency as jax_mono
from kaldi_tpu_torch.decoder.lexchain import LexChainDecoder, LexChainGraph
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
from kaldi_tpu_torch.recipes import bench_corpus as tbc
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency

REL = 1e-4
GRAPH_ARRAYS = (
    "pron_word", "pron_cost", "row_var", "row_pos", "row_phone",
    "row_is_first", "row_word", "end_row", "pdf_fwd_row", "pdf_self_row",
    "tid_fwd_row", "tid_self_row", "tr_fwd_row", "tr_self_row", "pdf_end",
    "tid_end", "tr_end", "pdf_root_self", "tid_root_self", "tr_root_self",
    "tid2pdf")
GRAPH_SCALARS = ("V", "P", "N", "n_true", "num_pdfs", "num_states",
                 "start_state", "use_sil", "sil_phone", "sil_cost",
                 "nosil_cost", "sil_pdf_fwd", "sil_pdf_self", "sil_tid_fwd",
                 "sil_tid_self", "sil_tr_fwd", "sil_tr_self")
QUICK = dict(vocab=24, num_phone_groups=4, phones_per_group=2,
             words_per_utt=5, num_train=2, num_test=6, num_lm_sents=80)


def random_lm(Lm, V, rng, n_expl=12):
    """The reference tests' random backoff bigram."""
    words = [f"W{i}" for i in range(V)]
    pairs = set()
    while len(pairs) < n_expl:
        pairs.add((int(rng.integers(0, V + 1)), int(rng.integers(0, V))))
    pairs = sorted(pairs, key=lambda t: (t[1], t[0]))
    return Lm(words=words,
              uni=rng.uniform(1.0, 4.0, V).astype(np.float32),
              bo=rng.uniform(0.2, 1.5, V + 1).astype(np.float32),
              expl_src=np.asarray([p[0] for p in pairs], np.int32),
              expl_dst=np.asarray([p[1] for p in pairs], np.int32),
              expl_cost=rng.uniform(0.5, 2.0, len(pairs)).astype(np.float32),
              eos=rng.uniform(0.5, 2.0, V + 1).astype(np.float32))


def random_lexicon(V, rng, num_phones=5, extra_variants=1):
    """One pronunciation of 1-3 phones a word, plus second variants of
    random words (cost 0.3)."""
    prons, pron_word = [], []
    for w in range(V):
        k = int(rng.integers(1, 4))
        prons.append(rng.integers(1, num_phones + 1, k).astype(np.int32))
        pron_word.append(w)
    for _ in range(extra_variants):
        w = int(rng.integers(0, V))
        prons.append(rng.integers(1, num_phones + 1, 2).astype(np.int32))
        pron_word.append(w)
    cost = np.zeros(len(prons), np.float32)
    cost[V:] = 0.3
    return prons, pron_word, cost


def graphs(seed, V=7, use_sil=False, n_expl=12, extra_variants=1,
           num_phones=5, model=False, **build):
    """The same graph on both sides -> (JAX graph, port graph, rng).
    model=True: monophone chain (tm, tree) tables over the phones."""
    out = []
    for Lm, Graph, Topo, Tm, mono in (
            (JaxLm, JaxGraph, JaxTopo, JaxTm, jax_mono),
            (BigramBackoffLm, LexChainGraph, HmmTopology, TransitionModel,
             monophone_context_dependency)):
        rng = np.random.default_rng(seed)
        lm = random_lm(Lm, V, rng, n_expl=n_expl)
        prons, pron_word, pron_cost = random_lexicon(
            V, rng, num_phones=num_phones, extra_variants=extra_variants)
        kw = dict(build)
        if model:
            phones = list(range(1, num_phones + 1))
            tree = mono(phones, {p: 2 for p in phones})
            kw.update(tm=Tm(Topo.chain_topology(phones), tree), tree=tree)
        else:
            kw.setdefault("num_pdfs", 12)
        out.append(Graph.build(prons, lm, pron_word=pron_word,
                               pron_cost=pron_cost, use_sil=use_sil,
                               **kw))
    return out[0], out[1], rng


def assert_graphs_equal(jg, tg):
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)
    for name in GRAPH_SCALARS:
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.words == jg.words
    for a, b in zip(tg.prons, jg.prons):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.entry_cost_table(),
                                  jg.entry_cost_table())
    np.testing.assert_array_equal(tg.eos_of_root(), jg.eos_of_root())


def assert_decoder_tables_equal(jd, td):
    """The host tables of the two decoders: dense and bucketed arc
    tables, the variant table and the virtual-context rows."""
    np.testing.assert_array_equal(td._srcw_tab.numpy(),
                                  np.asarray(jd._srcw_tab))
    np.testing.assert_array_equal(td._costw_tab[:, :, 0].numpy(),
                                  np.asarray(jd._costw_tab))
    assert td._use_dense_corr == jd._use_dense_corr
    assert len(td._buckets) == len(jd._buckets)
    for (ts, tc), (js, jc) in zip(td._buckets, jd._buckets):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td._bucket_inv_perm.numpy(),
                                  np.asarray(jd._bucket_inv_perm))
    np.testing.assert_array_equal(td._vtab.numpy(), np.asarray(jd._vtab))
    np.testing.assert_array_equal(td._word_has_var[:, 0].numpy(),
                                  np.asarray(jd._word_has_var))
    assert (td.VC, td.VC_D) == (jd.VC, jd.VC_D)
    for name in ("_vc_ctx", "_vc_dst", "_vc_cost"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)


def assert_hyps_match(got, want, rel=REL):
    assert len(got) == len(want)
    for b, (o, r) in enumerate(zip(got, want)):
        assert (o is None) == (r is None), b
        if r is None:
            continue
        assert o[0] == r[0], f"lane {b} words {o[0]} vs {r[0]}"
        assert o[1] == r[1], f"lane {b} tids"
        assert abs(o[2] - r[2]) <= rel * max(1.0, abs(r[2])), \
            f"lane {b}: {o[2]} vs {r[2]}"


def assert_matches_host(g, hyps, ll, lengths):
    host = FasterDecoder(g.to_flat_graph().to_vector_fst(),
                         FasterDecoderOptions(beam=1e9, max_active=10 ** 9))
    for b, h in enumerate(hyps):
        ref = host.decode(ll[b, :lengths[b]], g.tid2pdf)
        assert ref is not None and h is not None
        assert h[0] == ref[1], f"lane {b} words"
        assert h[1] == ref[0], f"lane {b} tids"
        assert abs(h[2] - ref[2]) < 1e-3 * max(1.0, abs(ref[2]))


@pytest.mark.parametrize("seed,use_sil", [(0, False), (0, True), (1, False),
                                          (1, True), (2, True)])
def test_exact_matches_jax_and_host(seed, use_sil):
    jg, tg, rng = graphs(seed, use_sil=use_sil, sil_phone=5, sil_prob=0.4)
    assert_graphs_equal(jg, tg)
    jd, td = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    assert_decoder_tables_equal(jd, td)
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = [T, T - 2, T - 4]
    got = td.decode_batch(ll, lengths=lengths)
    assert_hyps_match(got, jd.decode_batch(ll, lengths=lengths))
    assert_matches_host(tg, got, ll, lengths)


@pytest.mark.parametrize("seed,use_sil", [(0, True), (1, False), (3, True)])
def test_pruned_full_k_equals_exact(seed, use_sil):
    """Every virtual-context row in the pool: the same candidates the
    exact expansion reduces, so the decode is the exact one, traceback
    included."""
    jg, tg, rng = graphs(seed, use_sil=use_sil, sil_phone=5, sil_prob=0.4)
    td = LexChainDecoder(tg, device="cpu")
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = [T, T - 2, T - 4]
    exact = td.decode_batch(ll, lengths=lengths)
    full = td.decode_batch(ll, lengths=lengths, prune_k=td.VC,
                           exact_topk=True)
    assert_hyps_match(full, exact)
    assert_hyps_match(full, JaxDecoder(jg).decode_batch(
        ll, lengths=lengths, prune_k=td.VC, exact_topk=True))


@pytest.mark.parametrize("seed,K,beam", [(0, 2, 20.0), (1, 3, 4.0),
                                         (4, 5, 2.5)])
def test_pruned_small_k_matches_jax(seed, K, beam):
    """A small pool within a finite beam drops real candidates; the port
    selects the same rows as the reference's exact top_k (lower row first
    among equal values) and traces the same paths."""
    jg, tg, rng = graphs(seed, V=9, n_expl=30, use_sil=True, sil_phone=5,
                         sil_prob=0.4)
    jd, td = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    B, T = 3, 12
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32) * 2
    kw = dict(prune_k=K, prune_beam=beam, exact_topk=True)
    got = td.decode_batch(ll, **kw)
    assert_hyps_match(got, jd.decode_batch(ll, **kw))
    exact = td.decode_batch(ll)
    for o, e in zip(got, exact):
        assert o is not None and len(o[0]) > 0
        assert o[2] >= e[2] - 1e-4


def test_state_count_linear_in_vocab():
    """States grow O(rows + V): V=200 with <= 3-phone prons stays under
    2000 states, and the FlatGraph agrees."""
    jg, tg, _ = graphs(3, V=200, n_expl=300, num_phones=20,
                       extra_variants=0, use_sil=True, sil_phone=1,
                       num_pdfs=40)
    assert tg.num_states == jg.num_states < 2000
    assert tg.to_flat_graph().num_states == tg.num_states


@pytest.mark.parametrize("use_sil", [False, True])
def test_to_flat_graph_matches_jax(use_sil):
    jg, tg, _ = graphs(2, use_sil=use_sil, sil_phone=5, sil_prob=0.4)
    jf, tf = jg.to_flat_graph(), tg.to_flat_graph()
    for name in ("src", "dst", "ilabel", "olabel", "weight", "finals",
                 "tid2pdf"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name),
                                      err_msg=name)
    assert (tf.start, tf.num_pdfs, tf.words) == (jf.start, jf.num_pdfs,
                                                 jf.words)


@pytest.mark.parametrize("use_sil", [False, True])
def test_model_tables_match_jax_and_host(use_sil):
    """Monophone chain (tm, tree) tables: the graph's pdfs and tids are
    the transition model's, equal to JAX's, and the decode is exact."""
    jg, tg, rng = graphs(5, V=5, n_expl=8, model=True, use_sil=use_sil,
                         sil_phone=2)
    assert_graphs_equal(jg, tg)
    assert tg.num_pdfs == 10
    for n in range(tg.n_true):
        assert tg.tid2pdf[tg.tid_fwd_row[n]] == tg.pdf_fwd_row[n]
        assert tg.tid2pdf[tg.tid_self_row[n]] == tg.pdf_self_row[n]
    jd, td = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    B, T = 2, 8
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    got = td.decode_batch(ll)
    assert_hyps_match(got, jd.decode_batch(ll))
    assert_matches_host(tg, got, ll, [T, T])


def test_dense_and_bucketed_corrections_identical():
    """The exact expansion's two layouts of the explicit arcs (one
    padded dense gather, or one gather a bucket of words) give bitwise
    equal decodes, each equal to JAX's."""
    jg, tg, rng = graphs(11, V=30, n_expl=500, num_phones=4,
                         extra_variants=3)
    jd, dense = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    assert dense._use_dense_corr and len(dense._buckets) > 1
    buckets = LexChainDecoder(tg, device="cpu")
    buckets._use_dense_corr = False
    ll = rng.normal(size=(4, 25, tg.num_pdfs)).astype(np.float32) * 2
    got = dense.decode_batch(ll)
    assert buckets.decode_batch(ll) == got
    assert_hyps_match(got, jd.decode_batch(ll))
    jd._use_dense_corr = False
    assert_hyps_match(got, jd.decode_batch(ll))


@pytest.mark.parametrize("prune", [None, (4, 6.0)])
def test_resumable_carry_chunks_equal_one_forward(prune):
    """_forward over frames in chunks, each resuming from the last
    carry, gives the planes and dumps of one _forward over all frames,
    and the same decode; ragged lengths freeze the finished lanes."""
    _, tg, rng = graphs(7, V=9, n_expl=25, use_sil=True, sil_phone=5,
                        sil_prob=0.4, extra_variants=2)
    td = LexChainDecoder(tg, device="cpu")
    B, T = 3, 13
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = np.array([13, 9, 4])
    am = torch.from_numpy(-ll).permute(1, 2, 0).contiguous()
    active = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :])
    with torch.inference_mode():
        whole, ys = td._forward(am, active, prune)
        carry, parts = None, []
        for lo, hi in ((0, 4), (4, 5), (5, 11), (11, 13)):
            carry, part = td._forward(am[lo:hi], active[lo:hi], prune,
                                      carry)
            parts.append(part)
    for a, b in zip(carry, whole):
        assert torch.equal(a, b)
    assert sorted(ys) == sorted(parts[0])
    for name in ys:
        assert torch.equal(torch.cat([p[name] for p in parts]), ys[name]), \
            name
    kw = {} if prune is None else dict(prune_k=prune[0],
                                       prune_beam=prune[1])
    with torch.inference_mode():
        final, cost = td._final_state(carry[1], carry[2])
        first, states = td._follow(ys, active, final)
    want = td.decode_batch(ll, lengths=lengths, **kw)
    got = td._traceback(states.numpy(), first.numpy(), cost.numpy(),
                        lengths)
    assert got == want


def test_stats_decode_empty_lanes_and_errors():
    jg, tg, rng = graphs(0, use_sil=True, sil_phone=5)
    td = LexChainDecoder(tg, device="cpu")
    ll = rng.normal(size=(2, 6, tg.num_pdfs)).astype(np.float32)
    stats = {}
    got = td.decode_batch(torch.as_tensor(ll), lengths=[6, 0], stats=stats)
    assert set(stats) == {"fwd_s", "fol_s", "traceback_s"}
    assert got[1] is not None and got[1][:2] == ([], [])
    one = td.decode(ll[0])
    assert one == got[0]
    assert_hyps_match([one], [JaxDecoder(jg).decode(ll[0])])
    with pytest.raises(ValueError, match="pdf dim"):
        td.decode_batch(ll[:, :, :5])


def test_traceback_refuses_paths_not_from_the_begin_root():
    """A lane whose trajectory does not start at the begin root, or
    passes through it again, gets None (the reference's rule)."""
    _, tg, _ = graphs(0)
    td = LexChainDecoder(tg, device="cpu")
    begin = tg.start_state
    root0 = tg.N
    states = np.array([[root0, begin, root0], [root0, root0, root0]]).T
    first = np.array([begin, root0 + 1])
    out = td._traceback(states, first, np.array([1.0, 1.0]),
                        np.array([3, 3]))
    assert out == [None, None]


def quick_graphs():
    """build_decode_graph on the quick legacy spec with each package's
    chain_tm_tree_for -> (JAX graph, port graph)."""
    out = []
    for bc in (jbc, tbc):
        spec = bc.BenchCorpusSpec(**QUICK)
        lexicon, _, _, _, _, lm_text = bc.make_corpus(spec,
                                                      train_audio=False)
        lang, tm, tree = bc.chain_tm_tree_for(lexicon)
        out.append(bc.build_decode_graph(lexicon, lm_text, tm, tree,
                                         lang=lang))
    return out


def test_build_decode_graph_quick_spec():
    jg, tg = quick_graphs()
    assert_graphs_equal(jg, tg)
    assert tg.use_sil and tg.num_pdfs == 18
    np.testing.assert_array_equal(tg.lm.expl_cost, jg.lm.expl_cost)
    jd, td = JaxDecoder(jg), LexChainDecoder(tg, device="cpu")
    assert_decoder_tables_equal(jd, td)
    rng = np.random.default_rng(13)
    B, T = 3, 20
    ll = (rng.normal(size=(B, T, tg.num_pdfs)) * 2).astype(np.float32)
    lengths = [T, 15, 11]
    got = td.decode_batch(ll, lengths=lengths)
    assert_hyps_match(got, jd.decode_batch(ll, lengths=lengths))
    assert_matches_host(tg, got, ll, lengths)


def test_decoder_on_cuda_without_a_card_raises():
    _, tg, _ = graphs(0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        LexChainDecoder(tg)
