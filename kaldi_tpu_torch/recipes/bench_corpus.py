"""The deterministic synthetic bench corpus, the training ladder and the
writers and loaders of the bench-corpus model files (numpy copies of the
corpus generator, `mfcc_options`, `build_lang`, `train_system`,
`build_decode_graph`, `build_decode_graph_ng`, `chain_tm_tree_for`,
`wer_of`, `save_params`, `save_ivector_extractor` and the loaders of
`kaldi_tpu/recipes/bench_corpus.py`).

The corpus is seed-deterministic: a V-word lexicon over a formant-pair
phone inventory, Markov text with second-order structure, and two-formant
phone audio in noise with per-speaker warps.  `make_corpus` draws the
same numbers as the reference, so `corpus_fingerprint` of the bench
configuration equals the hash recorded beside the committed model
(`egs/bench_corpus/flagship_ng_meta.json`).

The legacy corpus (the default `BenchCorpusSpec()`, V=200) decodes with
the LexChain graph of `build_decode_graph` over the monophone chain
system of `chain_tm_tree_for`, and the committed
`egs/bench_corpus/flagship_params.npz` TDNN-F (no i-vectors).
`egs/bench_corpus/flagship_ng_params.npz` holds the flagship chain
TDNN-F as "/"-joined flax paths ("params/tdnnf1/linear", ...), the big
arrays stored as float16; `flagship_ng_ivec.npz` holds the i-vector
extractor with its diagonal UBM; `flagship_ng.tm` and `.tree` the
trained transition model and triphone tree.
"""

from __future__ import annotations

import hashlib
import logging
import math
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
from kaldi_tpu_torch.decoder.lexchain import LexChainGraph
from kaldi_tpu_torch.decoder.lexchain_ng import NgramLexGraph
from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.feat.frontend import MfccOptions, OfflineFeature
from kaldi_tpu_torch.feat.window import FrameExtractionOptions
from kaldi_tpu_torch.hmm.topology import HmmTopology
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.lm.bigram import BigramBackoffLm
from kaldi_tpu_torch.lm.trigram import TrigramBackoffLm
from kaldi_tpu_torch.ivector.batched import train_bench_extractor
from kaldi_tpu_torch.ivector.extractor import ExtractorOnDevice
from kaldi_tpu_torch.recipes.chain import (ChainTrainOptions,
                                           train_chain_ctx, train_chain_topo)
from kaldi_tpu_torch.recipes.mono import (TrainMonoOptions, _align_all,
                                          train_mono)
from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
from kaldi_tpu_torch.util.edit_distance import edit_distance_counts

_log = logging.getLogger(__name__)


@dataclass
class BenchCorpusSpec:
    vocab: int = 200
    num_phone_groups: int = 8      # confusable groups
    phones_per_group: int = 3      # members differ by a small f2 gap
    fs: float = 16000.0
    noise: float = 2500.0          # additive noise sigma (tones ~1500;
    #                                ~-6 dB SNR — hard enough that the
    #                                flagship WER band stays nonzero)
    f2_gap: float = 60.0           # separation inside a group
    min_pron: int = 2
    max_pron: int = 4
    words_per_utt: int = 12
    num_train: int = 384
    num_test: int = 128
    num_lm_sents: int = 4000
    seed: int = 11
    vec_text: bool = False         # vectorized text sampler (required
    #                                at vocabulary scale; different RNG
    #                                stream than the v1 scalar sampler,
    #                                so committed-model specs keep False)
    num_speakers: int = 0          # > 0: per-speaker VTLN-like formant
    #                                warp + gain (utterances assigned
    #                                round-robin) — the variability the
    #                                i-vector-adapted AM removes
    warp_lo: float = 0.88          # speaker warp range; at ±12% the
    warp_hi: float = 1.12          # warp shift (~±240 Hz at f2=2 kHz)
    #                                dwarfs the in-group f2_gap, so
    #                                narrow it when the corpus must
    #                                stay separable without perfect
    #                                speaker normalization
    log_spaced: bool = False       # multiplicative formant spacing:
    #                                the speaker warp is MULTIPLICATIVE,
    #                                so with additive spacing the same
    #                                Hz gap is aliased at high f2 and
    #                                resolvable at low f2 (measured:
    #                                cross-cluster substitutions, not
    #                                the designed minimal pairs).  With
    #                                log spacing every phone contrast is
    #                                a fixed RATIO vs the warp ratio —
    #                                uniform difficulty across groups.
    f2_member_ratio: float = 1.06  # in-group member step (log_spaced);
    #                                ~= the ±3% warp SPREAD, so speaker
    #                                normalization (i-vectors) stays
    #                                load-bearing for the minimal pairs

    @property
    def num_phones(self) -> int:
        return self.num_phone_groups * self.phones_per_group


def bench_scale_spec(**over) -> BenchCorpusSpec:
    """The round-4 vocabulary-scale bench configuration: V=20k over a
    30-phone inventory, trigram LM text, triphone-tree training.  The
    decode graph this yields (build_decode_graph_ng, prune (2,3)) has
    ~500k states — the reference's own headline runs on a graph of
    this order (LibriSpeech tgsmall HCLG, cuda-fst.h:62)."""
    kw = dict(vocab=20000, num_phone_groups=10, phones_per_group=3,
              min_pron=2, max_pron=5, words_per_utt=12,
              num_train=384, num_test=128, num_lm_sents=600000,
              noise=1600.0, seed=11, vec_text=True,
              num_speakers=24, warp_lo=0.97, warp_hi=1.03,
              log_spaced=True, f2_member_ratio=1.06)
    # warp +-3% multiplicative + LOG-SPACED formants: with the round-3
    # additive 60 Hz member gap the warp shift at high f2 (~+-110 Hz
    # at 3.7 kHz) exceeded the gap, aliasing phone identity outright —
    # measured cross-cluster (not minimal-pair) substitutions and a
    # 0.78 linear-probe phone-accuracy ceiling.  Log spacing makes
    # every contrast a fixed ratio: groups 16-19% apart (any speaker),
    # members 6% apart vs a 6% cross-speaker warp spread — confusable
    # WITHOUT speaker normalization, separable with it, which is
    # exactly the job the i-vector leg exists to do (run_tdnn_1d.sh's
    # online-ivector configuration).
    kw.update(over)
    return BenchCorpusSpec(**kw)


def phone_inventory(spec: BenchCorpusSpec) -> Dict[str, Tuple[float, float]]:
    """Phone -> (f1, f2).  Groups share f1; members differ by a small
    f2 offset (the confusability axis)."""
    inv: Dict[str, Tuple[float, float]] = {}
    for g in range(spec.num_phone_groups):
        if spec.log_spaced:
            # group identity rides f1 (16%/step >> warp spread, so it
            # survives any speaker); member identity is an f2 ratio
            f1 = 280.0 * 1.16 ** g
            f2_base = 1100.0 * 1.19 ** g
            for m in range(spec.phones_per_group):
                inv[f"p{g}_{m}"] = (f1,
                                    f2_base * spec.f2_member_ratio ** m)
            continue
        f1 = 280.0 + 160.0 * g
        f2_base = 1100.0 + 290.0 * g
        for m in range(spec.phones_per_group):
            inv[f"p{g}_{m}"] = (f1, f2_base + spec.f2_gap * m)
    return inv


def make_lexicon(spec: BenchCorpusSpec) -> Dict[str, List[List[str]]]:
    """V words; confusable clusters share their prefix and differ in
    the LAST phone within one formant group."""
    rng = np.random.default_rng(spec.seed)
    inv = sorted(phone_inventory(spec))
    lex: Dict[str, List[List[str]]] = {}
    seen = set()
    w = 0
    while len(lex) < spec.vocab:
        k = int(rng.integers(spec.min_pron, spec.max_pron + 1))
        prefix = [inv[rng.integers(len(inv))] for _ in range(k - 1)]
        g = int(rng.integers(spec.num_phone_groups))
        # a cluster of words sharing `prefix`, distinguished only by
        # the group-m member of the last phone
        for m in range(spec.phones_per_group):
            if len(lex) >= spec.vocab:
                break
            pron = prefix + [f"p{g}_{m}"]
            key = tuple(pron)
            if key in seen:
                continue
            seen.add(key)
            lex[f"W{w:04d}"] = [pron]
            w += 1
    return lex


def make_text(spec: BenchCorpusSpec, n_sents: int, seed: int
              ) -> List[List[str]]:
    """Markov text with SECOND-ORDER structure: Zipf unigram +
    per-context preferred successors (bigram mass) + hashed
    pair-context preferred successors (trigram mass a bigram LM cannot
    capture — what makes the trigram first pass earn its keep).  The
    PROCESS tables depend only on spec.seed; `seed` drives the
    sampling — train/test/LM text must come from the SAME process."""
    rng = np.random.default_rng(seed)
    proc_rng = np.random.default_rng(spec.seed + 777)
    V = spec.vocab
    words = [f"W{w:04d}" for w in range(V)]
    zipf = 1.0 / np.arange(1, V + 1) ** 0.8
    zipf /= zipf.sum()
    n_hot = 4
    hot = proc_rng.integers(0, V, size=(V + 1, n_hot))
    # hashed pair-context table: successor prefers hot2[(u,v) hash]
    M2 = 1 << 14
    hot2 = proc_rng.integers(0, V, size=(M2, n_hot))
    if spec.vec_text:
        # vectorized across sentences (position-major): same process
        # tables, different draw order than the v1 scalar sampler
        lens = np.maximum(
            spec.words_per_utt + rng.integers(-2, 3, n_sents), 1)
        Lmax = int(lens.max())
        prev2 = np.full(n_sents, V, np.int64)
        prev = np.full(n_sents, V, np.int64)
        cols = []
        for _t in range(Lmax):
            r = rng.random(n_sents)
            h_i = rng.integers(0, n_hot, n_sents)
            w2 = hot2[(prev2 * 1000003 + prev * 8191) % M2, h_i]
            w1 = hot[prev, h_i]
            wz = rng.choice(V, size=n_sents, p=zipf)
            w = np.where(r < 0.35, w2, np.where(r < 0.7, w1, wz))
            cols.append(w)
            prev2, prev = prev, w
        toks = np.stack(cols, axis=1)
        return [[words[toks[i, t]] for t in range(lens[i])]
                for i in range(n_sents)]
    sents = []
    for _ in range(n_sents):
        n = spec.words_per_utt + int(rng.integers(-2, 3))
        sent = []
        prev2, prev = V, V
        for _ in range(max(n, 1)):
            r = rng.random()
            if r < 0.35:
                h2 = (prev2 * 1000003 + prev * 8191) % M2
                w = int(hot2[h2, rng.integers(n_hot)])
            elif r < 0.7:
                w = int(hot[prev, rng.integers(n_hot)])
            else:
                w = int(rng.choice(V, p=zipf))
            sent.append(words[w])
            prev2, prev = prev, w
        sents.append(sent)
    return sents


def speaker_params(spec: BenchCorpusSpec
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(warps, gains) per speaker, deterministic in spec.seed."""
    rng = np.random.default_rng(spec.seed + 555)
    S = max(spec.num_speakers, 1)
    if spec.num_speakers == 0:
        return np.ones(1), np.ones(1)
    return (rng.uniform(spec.warp_lo, spec.warp_hi, S),
            rng.uniform(0.7, 1.3, S))


def synth_utterance(words: Sequence[str],
                    lexicon: Dict[str, List[List[str]]],
                    inv: Dict[str, Tuple[float, float]],
                    spec: BenchCorpusSpec, seed: int,
                    warp: float = 1.0,
                    spk_gain: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    fs = spec.fs

    def sil(dur):
        n = int(dur * fs)
        return spec.noise * 0.5 * rng.normal(size=n)

    parts = [sil(0.15 + 0.1 * rng.random())]
    for w in words:
        pron = lexicon[w][0]
        for ph in pron:
            f1, f2 = inv[ph]
            f1, f2 = f1 * warp, f2 * warp
            dur = 0.07 + 0.05 * rng.random()
            n = int(dur * fs)
            t = np.arange(n) / fs
            gain = (0.75 + 0.5 * rng.random()) * spk_gain
            seg = gain * (1500 * np.sin(2 * np.pi * f1 * t)
                          + 950 * np.sin(2 * np.pi * f2 * t)) \
                + spec.noise * rng.normal(size=n)
            env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                             / (0.008 * fs))
            parts.append(seg * env)
        if rng.random() < 0.35:
            parts.append(sil(0.06 + 0.12 * rng.random()))
    parts.append(sil(0.15 + 0.1 * rng.random()))
    return np.concatenate(parts).astype(np.float32)


def make_corpus(spec: BenchCorpusSpec, train_audio: bool = True):
    """-> (lexicon, train_txt, train_wav, test_txt, test_wav, lm_text).
    All deterministic in spec.seed.  train_audio=False skips the train
    waveform synthesis (decode-side reconstruction, e.g. bench.py)."""
    lexicon = make_lexicon(spec)
    inv = phone_inventory(spec)
    train_sents = make_text(spec, spec.num_train, spec.seed + 1)
    test_sents = make_text(spec, spec.num_test, spec.seed + 2)
    lm_text = make_text(spec, spec.num_lm_sents, spec.seed + 3)
    train_txt = {f"tr{i:04d}": s for i, s in enumerate(train_sents)}
    test_txt = {f"te{i:04d}": s for i, s in enumerate(test_sents)}
    warps, gains = speaker_params(spec)
    S = len(warps)
    train_wav = {} if not train_audio else \
        {u: synth_utterance(s, lexicon, inv, spec, 10_000 + i,
                            warps[i % S], gains[i % S])
         for i, (u, s) in enumerate(train_txt.items())}
    test_wav = {u: synth_utterance(s, lexicon, inv, spec, 50_000 + i,
                                   warps[i % S], gains[i % S])
                for i, (u, s) in enumerate(test_txt.items())}
    return lexicon, train_txt, train_wav, test_txt, test_wav, lm_text


def corpus_fingerprint(spec: BenchCorpusSpec, lexicon, test_txt,
                       test_wav, lm_text) -> str:
    """Stable hash of everything a committed trained model depends on:
    spec fields, phone inventory (formant layout), lexicon, test text,
    LM text (head + length), speaker warps, and a slice of the first
    test waveform.  Written into the *_meta.json of each trained
    artifact by egs/bench_corpus/train.py and re-checked by bench.py,
    so that corpus-generator drift can never silently invalidate a
    committed model again (round-4 regression: corpus edits changed
    the text under the round-3 flagship, WER 2.24% -> 5.89% with no
    signal; VERDICT r4 weak #1)."""
    h = hashlib.sha256()
    h.update(repr(sorted(asdict(spec).items())).encode())
    h.update(repr(sorted(phone_inventory(spec).items())).encode())
    for u in sorted(test_txt):
        h.update((u + " " + " ".join(test_txt[u])).encode())
    h.update(str(len(lm_text)).encode())
    for s in lm_text[:200]:
        h.update(" ".join(s).encode())
    for w in sorted(lexicon):
        h.update((w + ":" + ";".join(
            " ".join(p) for p in lexicon[w])).encode())
    warps, gains = speaker_params(spec)
    h.update(np.asarray(warps, np.float64).tobytes())
    h.update(np.asarray(gains, np.float64).tobytes())
    if test_wav:
        u0 = sorted(test_wav)[0]
        h.update(np.asarray(test_wav[u0][:4000],
                            np.float32).tobytes())
    return h.hexdigest()[:16]


# ----------------------------------------------------------------------
def mfcc_options(spec: BenchCorpusSpec, num_ceps: int = 40) -> MfccOptions:
    """The bench MFCC configuration: num_ceps cepstra over
    max(num_ceps, 23) mel bins, dither 0."""
    opts = MfccOptions(frame_opts=FrameExtractionOptions(
        samp_freq=spec.fs, dither=0.0))
    opts.num_ceps = num_ceps
    opts.mel_opts.num_bins = max(num_ceps, 23)
    return opts


def build_lang(lexicon) -> Lang:
    return Lang(lexicon, sil_phone="SIL", sil_prob=0.5)


def train_system(spec: BenchCorpusSpec, cfg=None,
                 chain_opts: Optional[ChainTrainOptions] = None,
                 num_ceps: int = 40, mono_iters: int = 8,
                 mono_totgauss: int = 500, ctx: bool = False,
                 max_leaves: int = 500, min_gain: float = 50.0,
                 ivector_dim: int = 0, window_den=None,
                 device: DeviceLike = None,
                 stats: Optional[dict] = None) -> dict:
    """The full ladder: corpus -> MFCC -> mono GMM -> alignment -> chain
    TDNN-F, with the card doing the MFCC, the GMM scoring and the chain
    training.  With ctx=True the chain system uses a triphone tree over
    word-internal windows (`recipes.chain.train_chain_ctx`: max_leaves,
    min_gain, window_den; cfg may be a factory num_pdfs -> cfg), else the
    monophone chain topology.  With ivector_dim > 0 a diag-UBM i-vector
    extractor is trained on the training features (on the host, float64)
    and the chain AM takes each utterance's offset-removed i-vector as
    its second input (cfg must set the same ivector_dim).  Returns a dict
    with everything the decode side needs (and the trained variables, in
    flax's layout).  stats, when given, receives each stage's seconds
    (corpus_s, mfcc_s, mono_s, graphs_s, align_s, ivector_s, chain_s,
    and with ctx tree_s, den_s, egs_s), the aligner of the last
    alignment, the mono GMM's average loglike of each iteration, and what
    the chain trainer records."""
    if stats is None:
        stats = {}
    t0 = time.perf_counter()
    lexicon, train_txt, train_wav, test_txt, test_wav, lm_text = \
        make_corpus(spec)
    lang = build_lang(lexicon)
    stats["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = OfflineFeature(mfcc_options(spec, num_ceps), device=device)
    _log.info("bench_corpus: extracting %d train utterances",
              len(train_wav))
    feats_d, nframes = comp.compute_batch_device(list(train_wav.values()))
    feats_h = feats_d.cpu().numpy()
    feats = {u: feats_h[i, :nframes[i]] for i, u in enumerate(train_wav)}
    del feats_d, feats_h
    stats["mfcc_s"] = time.perf_counter() - t0
    _log.info("bench_corpus: training mono GMM")
    t0 = time.perf_counter()
    gmm = train_mono(lang, feats, train_txt,
                     TrainMonoOptions(num_iters=mono_iters,
                                      totgauss=mono_totgauss),
                     device=device)
    stats["mono_s"] = time.perf_counter() - t0
    stats["mono_avg_loglikes"] = list(gmm.avg_loglikes)
    t0 = time.perf_counter()
    # the trained transition model's graphs, expanded from the phone-level
    # graphs train_mono made (the reference compiles them anew, to the
    # same graphs)
    compiler = TrainingGraphCompiler(gmm.tm, gmm.tree, lang)
    graphs = {u: compiler.expand(gmm.word_graphs[u]) for u in feats}
    stats["graphs_s"] = time.perf_counter() - t0
    _log.info("bench_corpus: aligning")
    t0 = time.perf_counter()
    ali = _align_all(gmm, graphs, feats, 10.0, 0.1, 1.0)
    stats["align_s"] = time.perf_counter() - t0
    stats["aligner"] = gmm.aligner
    ivec_ex, ivectors = None, None
    if ivector_dim > 0:
        _log.info("bench_corpus: training i-vector extractor")
        t0 = time.perf_counter()
        ivec_ex = train_bench_extractor(feats, ivector_dim=ivector_dim,
                                        device=device)
        utts = list(feats)
        ivs = ExtractorOnDevice(ivec_ex, device).extract(
            [feats[u] for u in utts], remove_offset=True)
        ivectors = {u: iv.astype(np.float32) for u, iv in zip(utts, ivs)}
        stats["ivector_s"] = time.perf_counter() - t0
    _log.info("bench_corpus: chain training")
    if chain_opts is None:
        chain_opts = ChainTrainOptions(num_epochs=8, learning_rate=1e-3,
                                       minibatch_size=32, chunk_width=150,
                                       left_tolerance=5, right_tolerance=5)
    if ctx:
        word_prons = {
            u: [[lang.phones[p] for p in lexicon[w][0]]
                for w in train_txt[u]] for u in feats}
        model, variables, den, chain_tm, chain_tree = train_chain_ctx(
            gmm, feats, ali, word_prons, cfg, chain_opts,
            max_leaves=max_leaves, min_gain=min_gain, ivectors=ivectors,
            window_den=window_den, device=device, stats=stats)
    else:
        t0 = time.perf_counter()
        model, variables, den, chain_tm, chain_tree = train_chain_topo(
            gmm, feats, ali, cfg, chain_opts, ivectors=ivectors,
            device=device, stats=stats)
        stats["chain_s"] = time.perf_counter() - t0
    return dict(spec=spec, lexicon=lexicon, lang=lang,
                train_txt=train_txt, test_txt=test_txt,
                test_wav=test_wav, lm_text=lm_text, gmm=gmm,
                model=model, variables=variables, den=den,
                chain_tm=chain_tm, chain_tree=chain_tree,
                ivector_extractor=ivec_ex, feats=feats, alignments=ali,
                ivectors=ivectors)


def _lexicon_arrays(lexicon, lang: Lang):
    """Every pronunciation variant of the sorted words as phone ids, its
    word index and its cost ln(number of variants of the word)."""
    prons, pron_word, pron_cost = [], [], []
    for wi, w in enumerate(sorted(lexicon)):
        variants = lexicon[w]
        for pron in variants:
            prons.append(np.asarray([lang.phones[p] for p in pron],
                                    np.int32))
            pron_word.append(wi)
            pron_cost.append(math.log(max(len(variants), 1)))
    return prons, pron_word, pron_cost


def build_decode_graph(lexicon, lm_text, chain_tm, chain_tree,
                       lang=None) -> LexChainGraph:
    """LexChainGraph from the corpus artifacts: estimated backoff bigram
    + the chain system's pdf/tid tables + optional-silence lexicon (the
    legacy graph)."""
    if lang is None:
        lang = build_lang(lexicon)
    lm = BigramBackoffLm.from_counts(lm_text, sorted(lexicon))
    prons, pron_word, pron_cost = _lexicon_arrays(lexicon, lang)
    return LexChainGraph.build(
        prons, lm, pron_word=pron_word, pron_cost=pron_cost,
        tm=chain_tm, tree=chain_tree, use_sil=True,
        sil_phone=lang.phones[lang.sil_phone], sil_prob=lang.sil_prob)


def chain_tm_tree_for(lexicon):
    """The deterministic chain system of a corpus, made without training
    artifacts: the chain topology and a monophone tree (two pdf-classes
    a phone) over the lang's phones -> (lang, transition model, tree)."""
    lang = build_lang(lexicon)
    phones = sorted(lang.phones.values())
    topo = HmmTopology.chain_topology(phones)
    tree = monophone_context_dependency(phones, {p: 2 for p in phones})
    return lang, TransitionModel(topo, tree), tree


def build_decode_graph_ng(lexicon, lm_text, chain_tm, chain_tree,
                          lang=None, prune_bi: int = 1,
                          prune_tri: int = 2) -> NgramLexGraph:
    """NgramLexGraph from the corpus artifacts: estimated backoff
    trigram + trained triphone-tree pdf/tid tables (word-internal
    windows) + optional-silence lexicon: the bench graph."""
    if lang is None:
        lang = build_lang(lexicon)
    vocab = sorted(lexicon)
    lm = TrigramBackoffLm.from_counts(lm_text, vocab, prune_bi=prune_bi,
                                      prune_tri=prune_tri)
    prons, pron_word, pron_cost = _lexicon_arrays(lexicon, lang)
    return NgramLexGraph.build(
        prons, lm, pron_word=pron_word, pron_cost=pron_cost,
        tm=chain_tm, tree=chain_tree, use_sil=True,
        sil_phone=lang.phones["SIL"], sil_prob=0.5)


def wer_of(hyps: Dict[str, List[str]], refs: Dict[str, List[str]]
           ) -> float:
    """Percent word errors of hyps against refs (a missing hyp is an
    empty one)."""
    errs = tot = 0
    for u, ref in refs.items():
        ins, dels, subs = edit_distance_counts(ref, hyps.get(u, []))
        errs += ins + dels + subs
        tot += len(ref)
    return 100.0 * errs / max(tot, 1)


def save_params(path: str, variables: dict) -> None:
    """Flatten the {params, batch_stats} tree to an npz of "/"-joined
    paths, float16 for the float32 arrays of more than 1024 values (the
    model runs in bf16 anyway): the format `load_params` reads."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        else:
            a = np.asarray(tree)
            if a.dtype == np.float32 and a.size > 1024:
                a = a.astype(np.float16)
            flat[prefix] = a
    for coll in ("params", "batch_stats"):
        if coll in variables and variables[coll]:
            walk(coll, variables[coll])
    np.savez_compressed(path, **flat)


def load_params(path: str) -> dict:
    """-> {"params": {...}, "batch_stats": {...}} nested dicts of numpy
    arrays, float16 upcast to float32 (the layout flax's `model.init`
    gives, which `chain_tdnnf_from_flax` reads)."""
    out: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            a = data[key]
            if a.dtype == np.float16:
                a = a.astype(np.float32)
            node[parts[-1]] = a
    return out


def save_ivector_extractor(path: str, ex) -> None:
    """An IvectorExtractor (diagonal UBM) to the npz `load_ivector_extractor`
    reads: M and sigma_inv as float32, the prior offset, and the UBM's
    weights, means and inverse variances as float64."""
    np.savez_compressed(
        path, M=ex.M.astype(np.float32),
        sigma_inv=ex.sigma_inv.astype(np.float32),
        prior=np.float64(ex.prior_offset),
        weights=ex.ubm.weights.astype(np.float64),
        means=ex.ubm.get_means().astype(np.float64),
        inv_vars=ex.ubm.inv_vars.astype(np.float64))


def load_ivector_extractor(path: str) -> Dict[str, np.ndarray]:
    """-> the arrays BatchedIvectorExtractor takes: M (G, D, R) and
    sigma_inv (G, D) as float64, prior (the prior offset), and the
    diagonal UBM's weights, means and inv_vars."""
    with np.load(path) as d:
        return {
            "M": d["M"].astype(np.float64),
            "sigma_inv": d["sigma_inv"].astype(np.float64),
            "prior": float(d["prior"]),
            "weights": np.asarray(d["weights"], np.float64),
            "means": np.asarray(d["means"], np.float64),
            "inv_vars": np.asarray(d["inv_vars"], np.float64),
        }
