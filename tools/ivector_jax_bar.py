#!/usr/bin/env python3
"""The JAX package's i-vector tool chain, once, on the CPU: the bars that
the PyTorch port's `ivector_train`, `ivector_sid` and `ivector_flagship`
phases (chip_smoke.py) are held to.

The corpus is the bench scale corpus (`bench_scale_spec()`: 384 training
and 128 test utterances, 24 speakers assigned round-robin), made and
featurized (40-cepstra MFCC) by the JAX package.  Then, with the JAX
package's tools and chip_smoke.py's options:

  ivector_train: gmm-global-init-from-feats --num-gauss=512 --num-iters=20
    --num-frames=500000, 4 x (gmm-global-acc-stats, gmm-global-est),
    gmm-global-to-fgmm, 4 x (fgmm-global-acc-stats over 4 splits, each a
    process of its own, fgmm-global-sum-accs, fgmm-global-est),
    ivector-extractor-init --use-full-ubm --ivector-dim=100, 10 x
    (ivector-extractor-acc-stats over 4 splits, each a process of its
    own, ivector-extractor-sum-accs, ivector-extractor-est); the UBM's
    average log-likelihood per frame over the training frames after each
    of those 9 UBM files;
  ivector_sid: compute-vad, select-voiced-frames, ivector-extract of the
    training (4 processes) and test utterances, ivector-mean over the
    training spk2utt (24 models), ivector-compute-lda --dim=23,
    ivector-transform, ivector-subtract-global-mean,
    ivector-normalize-length and ivector-compute-plda over the training
    i-vectors, ivector-plda-scoring of 24 models x 128 test utterances and
    compute-eer; ivector-compute-dot-products and compute-eer;
  ivector_flagship: egs/bench_corpus/flagship_ng_ivec.npz over the 128
    test utterances, the gap between the JAX package's own
    `IvectorExtractor.extract_offset_removed` and its
    `BatchedIvectorExtractor.extract_batch`, and between
    `OnlineIvectorEstimationStats` fed 10-frame chunks and the batched
    `init_state`/`acc_chunk`/`ivector` fed the same chunks.

Prints one JSON line (and writes it to <out>/bar.json): the numbers and
the seconds of each stage.

Run: JAX_PLATFORMS=cpu python tools/ivector_jax_bar.py [--out DIR]
     [--extractor-iters N]
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# chip_smoke.py's IVECTOR_* options
UBM_GAUSS = 512
UBM_INIT_ITERS = 20
UBM_FRAMES = 500000
DIAG_ITERS = 4
FULL_ITERS = 4
IVECTOR_DIM = 100
EXTRACTOR_ITERS = 10
SPLITS = 4
LDA_DIM = 23
PERIOD = 10


def run(tool, *args) -> str:
    """One JAX tool in this process -> its standard output."""
    from kaldi_tpu.cli import get_tool
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")   # tools write .buffer
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = get_tool(tool)([tool] + [str(a) for a in args])
    out.flush()
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}:\n{err.getvalue()[-4000:]}")
    return buf.getvalue().decode()


def run_procs(calls) -> None:
    """JAX tools, each in a process of its own, all at once."""
    code = ("import sys; from kaldi_tpu.cli import get_tool; "
            "sys.exit(get_tool(sys.argv[1])(sys.argv[1:]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, tool] + [str(a) for a in args],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for tool, *args in calls]
    for p, call in zip(procs, calls):
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{call[0]} exited {p.returncode}:\n"
                             f"{err.decode()[-4000:]}")


def write_ark(path, feats: dict, keys) -> None:
    from kaldi_tpu.util.table import TableWriter
    w = TableWriter("matrix", f"ark:{path}")
    for k in keys:
        w.write(k, feats[k])
    w.close()


def read_vectors(path) -> dict:
    from kaldi_tpu.util.table import SequentialTableReader
    return {k: np.asarray(v, np.float64)
            for k, v in SequentialTableReader("vector", f"ark:{path}")}


def write_lines(path, lines) -> None:
    with open(path, "w") as f:
        f.write("".join(line + "\n" for line in lines))


def _loglike_sum(path: str, full: bool, ark: str):
    """(sum of the frames' log-likelihoods, frames) of one archive under
    the UBM at `path`, as the acc-stats tools score a frame (float32 for
    the diagonal UBM, float64 for the full one)."""
    from kaldi_tpu.gmm.diag_gmm import DiagGmm
    from kaldi_tpu.gmm.full_gmm import FullGmm
    from kaldi_tpu.util import kaldi_io
    from kaldi_tpu.util.table import SequentialTableReader
    gmm = kaldi_io.read_kaldi_object(FullGmm.read if full else DiagGmm.read,
                                     path)
    tot, n = 0.0, 0
    for _, x in SequentialTableReader("matrix", f"ark:{ark}"):
        x = np.asarray(x).astype(np.float64 if full else np.float32)
        tot += float(np.sum(gmm.log_likelihood(x), dtype=np.float64))
        n += x.shape[0]
    return tot, n


def avg_loglike(path: str, full: bool, arks) -> float:
    """The UBM's average log-likelihood a frame over the archives, one
    process each."""
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(len(arks),
                                mp_context=mp.get_context("spawn")) as ex:
        parts = list(ex.map(_loglike_sum, [path] * len(arks),
                            [full] * len(arks), arks))
    return sum(t for t, _ in parts) / sum(n for _, n in parts)


def eer_of(scores_path: str, targets: set, d: str, name: str) -> float:
    lines = []
    with open(scores_path) as f:
        for line in f:
            a, b, s = line.split()
            label = "target" if (a, b) in targets else "nontarget"
            lines.append(f"{s} {label}")
    lab = os.path.join(d, name + ".labeled")
    write_lines(lab, lines)
    return float(run("compute-eer", lab).strip().rstrip("%"))


def flagship_gaps(test_feats: dict) -> dict:
    from kaldi_tpu.ivector.batched import BatchedIvectorExtractor
    from kaldi_tpu.ivector.extractor import OnlineIvectorEstimationStats
    from kaldi_tpu.recipes.bench_corpus import load_ivector_extractor
    ex = load_ivector_extractor(os.path.join(
        REPO, "egs", "bench_corpus", "flagship_ng_ivec.npz"))
    bat = BatchedIvectorExtractor(ex)
    utts = sorted(test_feats)
    lens = np.asarray([test_feats[u].shape[0] for u in utts])
    T = int(-(-lens.max() // PERIOD) * PERIOD)
    padded = np.zeros((len(utts), T, ex.dim), np.float32)
    for i, u in enumerate(utts):
        padded[i, :lens[i]] = test_feats[u]
    host = np.stack([ex.extract_offset_removed(test_feats[u]) for u in utts])
    dev = np.asarray(bat.extract_batch(padded, lens), np.float64)
    offline_gap = float(np.abs(host - dev).max())
    state = bat.init_state(len(utts))
    online_gap, rows = 0.0, 0
    stats = [OnlineIvectorEstimationStats(ex) for _ in utts]
    for t0 in range(0, T, PERIOD):
        mask = (np.arange(t0, t0 + PERIOD)[None, :] < lens[:, None])
        state = bat.acc_chunk(state, padded[:, t0:t0 + PERIOD],
                              mask.astype(np.float32))
        got = np.asarray(bat.ivector(state), np.float64)
        for i, u in enumerate(utts):
            if t0 >= lens[i]:
                continue
            stats[i].acc_frames(test_feats[u][t0:t0 + PERIOD])
            want = stats[i].ivector()
            want[0] -= ex.prior_offset
            online_gap = max(online_gap, float(np.abs(got[i] - want).max()))
            rows += 1
    return {"offline_gap": offline_gap, "online_gap": online_gap,
            "online_rows": rows, "utterances": len(utts),
            "mean_norm": float(np.linalg.norm(host, axis=1).mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="keep the files here (default: a "
                    "temporary directory)")
    ap.add_argument("--extractor-iters", type=int, default=EXTRACTOR_ITERS)
    ap.add_argument("--num-gauss", type=int, default=UBM_GAUSS,
                    help="a smaller UBM, to try the tool out quickly")
    ap.add_argument("--ivector-dim", type=int, default=IVECTOR_DIM,
                    help="a smaller extractor, to try the tool out")
    args = ap.parse_args()
    t_all = time.perf_counter()
    from kaldi_tpu.feat.frontend import OfflineFeature
    from kaldi_tpu.recipes.bench_corpus import (bench_scale_spec,
                                                make_corpus, mfcc_options)
    res: dict = {"stage_s": {}}
    st = res["stage_s"]
    with contextlib.ExitStack() as stack:
        d = args.out or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(d, exist_ok=True)
        p = lambda name: os.path.join(d, name)  # noqa: E731
        t0 = time.perf_counter()
        spec = bench_scale_spec()
        _, train_txt, train_wav, test_txt, test_wav, _ = make_corpus(spec)
        S = spec.num_speakers
        comp = OfflineFeature(mfcc_options(spec, 40))
        feats, test_feats = {}, {}
        for src, dst in ((train_wav, feats), (test_wav, test_feats)):
            keys = sorted(src)
            for i in range(0, len(keys), 64):
                part = keys[i:i + 64]
                dst.update(zip(part, comp.compute_batch(
                    [src[u] for u in part])))
        del train_wav, test_wav
        st["corpus_mfcc"] = time.perf_counter() - t0
        train_keys, test_keys = sorted(feats), sorted(test_feats)
        spk = {u: f"spk{int(u[2:]) % S:02d}" for u in train_keys + test_keys}
        write_ark(p("train.ark"), feats, train_keys)
        write_ark(p("test.ark"), test_feats, test_keys)
        splits = [train_keys[i::SPLITS] for i in range(SPLITS)]
        for j, keys in enumerate(splits):
            write_ark(p(f"train.{j}.ark"), feats, keys)
        spk2utt = {}
        for u in train_keys:
            spk2utt.setdefault(spk[u], []).append(u)
        write_lines(p("spk2utt"), [f"{s} {' '.join(us)}"
                                   for s, us in sorted(spk2utt.items())])
        write_lines(p("utt2spk"), [f"{u} {spk[u]}" for u in train_keys])
        trials = [(s, u) for s in sorted(spk2utt) for u in test_keys]
        write_lines(p("trials"), [f"{s} {u}" for s, u in trials])
        targets = {(s, u) for s, u in trials if spk[u] == s}
        res["frames"] = int(sum(f.shape[0] for f in feats.values()))

        # ivector_train ------------------------------------------------
        t0 = time.perf_counter()
        ll = {}
        run("gmm-global-init-from-feats", f"--num-gauss={args.num_gauss}",
            f"--num-iters={UBM_INIT_ITERS}", f"--num-frames={UBM_FRAMES}",
            "ark:" + p("train.ark"), p("0.dubm"))
        st["ubm_init"] = time.perf_counter() - t0
        split_arks = [p(f"train.{j}.ark") for j in range(SPLITS)]
        ll["init"] = avg_loglike(p("0.dubm"), False, split_arks)
        t0 = time.perf_counter()
        for it in range(DIAG_ITERS):
            run("gmm-global-acc-stats", p(f"{it}.dubm"),
                "ark:" + p("train.ark"), p(f"{it}.dacc"))
            run("gmm-global-est", p(f"{it}.dubm"), p(f"{it}.dacc"),
                p(f"{it + 1}.dubm"))
            ll[f"diag{it + 1}"] = avg_loglike(p(f"{it + 1}.dubm"), False,
                                              split_arks)
        st["ubm_diag"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run("gmm-global-to-fgmm", p(f"{DIAG_ITERS}.dubm"), p("0.ubm"))
        for it in range(FULL_ITERS):
            run_procs([("fgmm-global-acc-stats", p(f"{it}.ubm"),
                        "ark:" + p(f"train.{j}.ark"), p(f"{it}.{j}.facc"))
                       for j in range(SPLITS)])
            run("fgmm-global-sum-accs", p(f"{it}.facc"),
                *[p(f"{it}.{j}.facc") for j in range(SPLITS)])
            run("fgmm-global-est", p(f"{it}.ubm"), p(f"{it}.facc"),
                p(f"{it + 1}.ubm"))
            ll[f"full{it + 1}"] = avg_loglike(p(f"{it + 1}.ubm"), True,
                                              split_arks)
        st["ubm_full"] = time.perf_counter() - t0
        res["ubm_avg_loglike"] = ll
        t0 = time.perf_counter()
        run("ivector-extractor-init", "--use-full-ubm",
            f"--ivector-dim={args.ivector_dim}", p(f"{FULL_ITERS}.ubm"),
            p("0.ie"))
        iter_s = []
        for it in range(args.extractor_iters):
            t1 = time.perf_counter()
            run_procs([("ivector-extractor-acc-stats", p(f"{it}.ie"),
                        "ark:" + p(f"train.{j}.ark"), p(f"{it}.{j}.iacc"))
                       for j in range(SPLITS)])
            run("ivector-extractor-sum-accs", p(f"{it}.iacc"),
                *[p(f"{it}.{j}.iacc") for j in range(SPLITS)])
            run("ivector-extractor-est", p(f"{it}.ie"), p(f"{it}.iacc"),
                p(f"{it + 1}.ie"))
            iter_s.append(time.perf_counter() - t1)
        final_ie = p(f"{args.extractor_iters}.ie")
        st["extractor"] = time.perf_counter() - t0
        res["extractor_iters"] = args.extractor_iters
        res["extractor_iter_s"] = iter_s

        # ivector_sid --------------------------------------------------
        t0 = time.perf_counter()
        for name in ["test"] + [f"train.{j}" for j in range(SPLITS)]:
            run("compute-vad", "ark:" + p(f"{name}.ark"),
                "ark:" + p(f"{name}.vad"))
            run("select-voiced-frames", "ark:" + p(f"{name}.ark"),
                "ark:" + p(f"{name}.vad"), "ark:" + p(f"{name}.voiced.ark"))
        voiced = sum(int(np.sum(v)) for name in
                     ["test"] + [f"train.{j}" for j in range(SPLITS)]
                     for v in read_vectors(p(f"{name}.vad")).values())
        res["voiced_frames"] = voiced
        run_procs([("ivector-extract", final_ie,
                    "ark:" + p(f"{name}.voiced.ark"),
                    "ark:" + p(f"{name}.ivec"))
                   for name in ["test"] + [f"train.{j}"
                                           for j in range(SPLITS)]])
        st["sid_extract"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_iv = {}
        for j in range(SPLITS):
            train_iv.update(read_vectors(p(f"train.{j}.ivec")))
        from kaldi_tpu.util.table import TableWriter
        w = TableWriter("vector", "ark:" + p("train.ivec"))
        for k in sorted(train_iv):
            w.write(k, train_iv[k])
        w.close()
        run("ivector-mean", "ark:" + p("spk2utt"), "ark:" + p("train.ivec"),
            "ark:" + p("spk.ivec"), "ark:" + p("num_utts.ark"))
        run("ivector-compute-lda", f"--dim={LDA_DIM}",
            "ark:" + p("train.ivec"), "ark:" + p("utt2spk"), p("lda.mat"))
        for name in ("train", "spk", "test"):
            run("ivector-transform", p("lda.mat"), "ark:" + p(f"{name}.ivec"),
                "ark:" + p(f"{name}.lda"))
            run("ivector-subtract-global-mean", "ark:" + p(f"{name}.lda"),
                "ark:" + p(f"{name}.cen"))
            run("ivector-normalize-length", "ark:" + p(f"{name}.cen"),
                "ark:" + p(f"{name}.norm"))
        run("ivector-compute-plda", "ark:" + p("spk2utt"),
            "ark:" + p("train.norm"), p("plda"))
        run("ivector-plda-scoring", "--num-utts=ark:" + p("num_utts.ark"),
            p("plda"), "ark:" + p("spk.norm"), "ark:" + p("test.norm"),
            p("trials"), p("scores.plda"))
        run("ivector-compute-dot-products", p("trials"),
            "ark:" + p("spk.norm"), "ark:" + p("test.norm"),
            p("scores.dot"))
        res["eer_plda"] = eer_of(p("scores.plda"), targets, d, "plda")
        res["eer_dot"] = eer_of(p("scores.dot"), targets, d, "dot")
        res["trials"] = len(trials)
        res["target_trials"] = len(targets)
        res["test_ivector_norm_mean"] = float(np.mean(
            [np.linalg.norm(v)
             for v in read_vectors(p("test.ivec")).values()]))
        st["sid_backend"] = time.perf_counter() - t0

        # ivector_flagship ---------------------------------------------
        t0 = time.perf_counter()
        res["flagship"] = flagship_gaps(test_feats)
        st["flagship"] = time.perf_counter() - t0
    res["seconds"] = time.perf_counter() - t_all
    line = json.dumps(res)
    if args.out:
        with open(os.path.join(args.out, "bar.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
