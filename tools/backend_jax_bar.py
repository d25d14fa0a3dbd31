#!/usr/bin/env python3
"""The JAX package's speaker and language back ends and linear VTLN, once,
on the CPU: the bars that the PyTorch port's `backend_lid`,
`backend_diar` and `gmm_vtln` phases (chip_smoke.py) are held to.

The corpus is the bench scale corpus (`bench_scale_spec()`: 384 training
and 128 test utterances, 24 speakers assigned round-robin), made and
featurized (40-cepstra MFCC) by the JAX package; the i-vectors are the
committed flagship extractor's (egs/bench_corpus/flagship_ng_ivec.npz:
a 64-Gaussian diagonal UBM, 32-dim i-vectors) through ivector-extract.
Then, with the JAX package's tools and chip_smoke.py's options:

  backend_lid: logistic-regression-train on the training i-vectors with
    the speakers as classes, at its defaults and with --mix-up=48, and
    logistic-regression-eval of the test i-vectors: the final objective
    and the top-1 accuracy of each;
  backend_diar: ivector-subtract-global-mean and ivector-normalize-length
    of both sets, ivector-compute-plda on the training set's,
    ivector-plda-scoring-dense of 8 recordings (the test utterances of
    speakers 3r..3r+2 in recording r), agglomerative-cluster with the
    true speaker counts and with --threshold=0: each recording's
    segments whose cluster maps to another speaker (best one-to-one
    mapping);
  gmm_vtln: gmm-init-lvtln --dim=40 (31 classes, warps 0.85-1.15),
    gmm-train-lvtln-special of each class from the unwarped and that
    class's warped MFCC of the first 96 training utterances, and
    gmm-global-est-lvtln-trans over the flagship's UBM of each training
    speaker: each speaker's warp.

Prints one JSON line (BACKEND_JAX_BAR's numbers and each part's seconds).

Run: JAX_PLATFORMS=cpu python tools/backend_jax_bar.py [--out DIR]
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# chip_smoke.py's options
MIX_UP = 48
SPEAKERS_A_RECORDING = 3
THRESHOLD = 0.0
LVTLN_CLASSES, LVTLN_DEFAULT, LVTLN_UTTS = 31, 15, 96


def run(tool, *args) -> str:
    """One JAX tool in this process -> its stderr and stdout."""
    from kaldi_tpu.cli import get_tool
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = get_tool(tool)([tool] + [str(a) for a in args])
    out.flush()
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}:\n{err.getvalue()[-4000:]}")
    return err.getvalue() + buf.getvalue().decode()


def write_ark(path, feats: dict, keys) -> None:
    from kaldi_tpu.util.table import TableWriter
    with TableWriter("matrix", f"ark:{path}") as w:
        for u in keys:
            w.write(u, feats[u])


def speaker_errors(labels, truth) -> int:
    from scipy.optimize import linear_sum_assignment
    clusters, speakers = sorted(set(labels)), sorted(set(truth))
    count = np.zeros((len(clusters), len(speakers)))
    for c, s in zip(labels, truth):
        count[clusters.index(c), speakers.index(s)] += 1
    rows, cols = linear_sum_assignment(-count)
    return int(len(labels) - count[rows, cols].sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="keep the files here")
    args = ap.parse_args()
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.recipes.bench_corpus import (bench_scale_spec,
                                                load_ivector_extractor,
                                                make_corpus, mfcc_options)
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.table import SequentialTableReader
    res: dict = {"stage_s": {}}
    st = res["stage_s"]
    with contextlib.ExitStack() as stack:
        d = args.out or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(d, exist_ok=True)

        def p(name):
            return os.path.join(d, name)

        def a(name):
            return "ark:" + p(name)

        t0 = time.perf_counter()
        spec = bench_scale_spec()
        _, _, train_wav, _, test_wav, _ = make_corpus(spec)
        S = spec.num_speakers
        comp = OfflineFeature(mfcc_options(spec, 40))
        feats = {"train": {}, "test": {}}
        for name, src in (("train", train_wav), ("test", test_wav)):
            keys = sorted(src)
            for i in range(0, len(keys), 64):
                part = keys[i:i + 64]
                feats[name].update(zip(part, comp.compute_batch(
                    [src[u] for u in part])))
            write_ark(p(f"{name}.ark"), feats[name], keys)

        def spk(u):
            return int(u[2:]) % S

        for name in ("train", "test"):
            keys = sorted(feats[name])
            by = {}
            for u in keys:
                by.setdefault(f"spk{spk(u):02d}", []).append(u)
            with open(p(f"{name}.spk2utt"), "w") as f:
                f.writelines(f"{s} {' '.join(us)}\n"
                             for s, us in sorted(by.items()))
            with open(p(f"{name}.utt2class"), "w") as f:
                f.writelines(f"{u} {spk(u)}\n" for u in keys)
        st["corpus_mfcc"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex = load_ivector_extractor(os.path.join(
            REPO, "egs", "bench_corpus", "flagship_ng_ivec.npz"))
        kaldi_io.write_kaldi_object(ex.write, p("flagship.ie"))
        kaldi_io.write_kaldi_object(ex.ubm.write, p("flagship.dubm"))
        for name in ("train", "test"):
            run("ivector-extract", p("flagship.ie"), a(f"{name}.ark"),
                a(f"{name}.ivec"))
        st["ivectors"] = time.perf_counter() - t0

        # backend_lid
        t0 = time.perf_counter()
        truth = {u: spk(u) for u in feats["test"]}
        lid = {"final_objf": {}, "accuracy": {}}
        for name, opts in (("default", []), ("mix_up", [f"--mix-up={MIX_UP}"])):
            log = run("logistic-regression-train", *opts, a("train.ivec"),
                      a("train.utt2class"), p(f"{name}.lr"))
            lid["final_objf"][name] = float(
                re.findall(r"final objf (\S+)", log)[-1])
            run("logistic-regression-eval", p(f"{name}.lr"), a("test.ivec"),
                a(f"{name}.post"))
            post = dict(SequentialTableReader("vector", a(f"{name}.post")))
            lid["accuracy"][name] = sum(int(np.argmax(v)) == truth[u]
                                        for u, v in post.items())
        res["lid"] = lid
        st["lid"] = time.perf_counter() - t0

        # backend_diar
        t0 = time.perf_counter()
        for name in ("train", "test"):
            run("ivector-subtract-global-mean", a(f"{name}.ivec"),
                a(f"{name}.dcen"))
            run("ivector-normalize-length", a(f"{name}.dcen"),
                a(f"{name}.dnorm"))
        run("ivector-compute-plda", a("train.spk2utt"), a("train.dnorm"),
            p("diar.plda"))
        recos = {}
        for u in sorted(feats["test"]):
            recos.setdefault(f"reco{spk(u) // SPEAKERS_A_RECORDING}",
                             []).append(u)
        with open(p("reco2utt"), "w") as f:
            f.writelines(f"{r} {' '.join(us)}\n" for r, us in recos.items())
        with open(p("reco2num"), "w") as f:
            f.writelines(f"{r} {len({spk(u) for u in us})}\n"
                         for r, us in recos.items())
        run("ivector-plda-scoring-dense", p("diar.plda"), a("reco2utt"),
            a("test.dnorm"), a("scores"))
        diar = {}
        for mode, opts in (("num_spk",
                            ["--reco2num-spk-rspecifier=" + a("reco2num")]),
                           ("threshold", [f"--threshold={THRESHOLD}"])):
            run("agglomerative-cluster", *opts, a("scores"), a("reco2utt"),
                a(f"labels.{mode}"))
            labels = {u: int(v[0]) for u, v in SequentialTableReader(
                "int-vector", a(f"labels.{mode}"))}
            diar[mode] = {r: speaker_errors([labels[u] for u in us],
                                            [spk(u) for u in us])
                          for r, us in recos.items()}
        res["diar"] = diar
        st["diar"] = time.perf_counter() - t0

        # gmm_vtln
        t0 = time.perf_counter()
        sub = sorted(train_wav)[:LVTLN_UTTS]
        write_ark(p("sub.ark"), feats["train"], sub)
        run("gmm-init-lvtln", "--dim=40", p("lvtln"))
        for c in range(LVTLN_CLASSES):
            w = 1.0 + 0.01 * (c - LVTLN_DEFAULT)
            warped = {}
            for i in range(0, len(sub), 64):
                part = sub[i:i + 64]
                warped.update(zip(part, comp.compute_batch(
                    [train_wav[u] for u in part], w)))
            write_ark(p("warped.ark"), warped, sub)
            run("gmm-train-lvtln-special", f"--warp={w}", c, p("lvtln"),
                p("lvtln"), a("sub.ark"), a("warped.ark"))
        st["lvtln_classes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run("gmm-global-est-lvtln-trans", "--spk2utt=" + a("train.spk2utt"),
            p("flagship.dubm"), p("lvtln"), a("train.ark"), a("trans"),
            "ark,t:" + p("spk.warp"))
        res["vtln"] = {s: float(v) for s, v in SequentialTableReader(
            "float", a("spk.warp"))}
        st["lvtln_trans"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
