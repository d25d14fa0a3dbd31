#!/usr/bin/env python3
"""The main path's phases of chip_smoke.py alone, on one NVIDIA GPU,
plus diagnostics of its WER and of its lattice mode.

Runs what chip_smoke.py runs for the main path (ng_graph, slice_ng,
profile_ng, ng_cpu_check, cross_check_ng: the V=20,000 bench corpus and
graph, 128 test utterances through BatchedOfflinePipeline2 with the
n-gram decoder, WER; slice_ng_lattice, ng_lattice_cpu_check: the same
utterances in lattice mode), without the kernel phases, so that work on
the main path's search can be measured alone.  Then:
  probe_f32_am      the WER of the same utterances with the flagship
                    model in float32 instead of bf16;
  probe_exact_pool  16 lanes' loglikes decoded with every
                    virtual-context row in the pool (exact search)
                    against the bench's pool of 128 rows, beam 16;
  probe_survivor_rule, probe_reference_events
                    lattice mode under the two rules of the reference
                    that the port changed: the word-end events its
                    survivor rule keeps, and lattices, differing lanes
                    and WER without the best path's word ends put into
                    the events, at 64 and 256 events a frame.
The WER band of chip_smoke.py is not applied here.  JSON lines as in
chip_smoke.py; exits nonzero on any failed check.

With --online it runs chip_smoke.py's online phases of the main path
alone instead: slice_online_ng, online_ng_stream_offline (against one
decode_batch of the 128 utterances with the bench's pool) and
online_batcher_ng.

With --legacy it runs chip_smoke.py's legacy-path phases alone (the same
function chip_smoke.py calls, legacy_phases): lex_graph, slice_lex (with
profile_lex, slice_lex_int16 and lex_pruned_full_k), lex_cpu_check,
slice_lex_lattice (with profile_lex_lattice), lex_lattice_cpu_check,
lattice_functions (on slice_lex_lattice's lattices only: the main path's
lattice phase does not run), cross_check_lex and slice_online_lex.

With --train it runs chip_smoke.py's training phases alone (the same
function chip_smoke.py calls, train_phases): train_lex (the legacy
training recipe of egs/bench_corpus/train.py main() through the port's
recipes/train_bench.py, its 8 epochs or --epochs N, then the decode of
the test set and one profiled step) and train_lex_check (the card against the CPU from
one state and one minibatch).

With --train-scale it runs chip_smoke.py's phases of the --scale
training recipe alone (train_scale_phases): train_scale
(egs/bench_corpus/train.py main_scale through the port's
recipes/train_scale.py, 16 epochs or --epochs N, the test set
decoded through the main path to a WER) and train_scale_check (the
card's gradient against the CPU's on real chunks through the bucketed
window-LM denominator).

With --nnet3 it runs chip_smoke.py's nnet3 phases alone (nnet3_phases,
after the main path's graph and without its decode): nnet3_ref_golden,
nnet3_import_flagship, nnet3_cli_batch and nnet3_recurrent.

With --online2 it runs chip_smoke.py's online2 phases alone
(online2_phases, after the legacy graph and one decode of its test
utterances on the int16 wire, slice_lex_int16's words):
online2_graph, online2_wav and online2_tcp (not the xconfig phases
that chip_smoke.py runs after them).

With --xconfig it runs chip_smoke.py's xconfig phases alone
(xconfig_phases, after online2_graph, which makes the HCLG.fst and the
16 utterances): xconfig_graph, xconfig_latgen, xconfig_latgen_variants
and xconfig_zoo.

With --latgen it runs chip_smoke.py's xconfig_graph and xconfig_latgen
over all 128 test utterances of the legacy corpus (after online2_graph,
which makes the HCLG.fst and the utterances): the legacy TDNN-F as an
xconfig checkpoint directory, `nnet3-latgen-faster` at decode.sh's beams,
the lattice tools and compute-wer; the WER must lie within 0.5 points
and 8 words of slice_lex_int16's 6.088% (94 of 1544).

With --chain-cli it runs chip_smoke.py's phases of chain training
through the command-line tools alone (chain_cli_phases), after
train_lex's system without its chain training (the corpus, MFCC, the
mono GMM, the alignment, the chain transition model and tree):
chain_cli, chain_cli_check, chain_cli_e2e and nnet3_train_cli.

With --disc it runs chip_smoke.py's disc_smbr alone, after
online2_graph, xconfig_graph and xconfig_latgen (the untuned WER), and
copies the archives tools/disc_jax_bar.py reads (the training
utterances' features, their alignments and lattices, the test features,
final.tm, HCLG.fst) to _chip/disc_smbr/.

With --chain-frame it runs chip_smoke.py's train_chain_frame and
ng_precondition alone (chain_frame_phases), after train_lex's system
without its chain training (as --chain-cli).

With --template it runs chip_smoke.py's generic corpus recipe phases
alone (template_phases): egs/template/run.py through the port's
recipes/template_run.py and tools on the fabricated corpus, one call at
the recipe's defaults (stages 0-7: template_gmm and template_lda_sat,
the card's statistics against the CPU's, the transform tools against the
in-process matrices), then --stage 8 --chain-epochs N
(template_chain_e2e; N is TEMPLATE_CHAIN_EPOCHS, or --epochs), each held
to tools/template_jax_bar.py's bars.

With --ivector it runs chip_smoke.py's i-vector phases alone
(ivector_phases): the --scale corpus made and featurized here (not
trained), then ivector_train, ivector_sid and ivector_flagship, each held
to tools/ivector_jax_bar.py's bars.

With --backend it runs chip_smoke.py's back-end, VTLN and MMI phases
alone (backend_phases: backend_lid, backend_diar, gmm_vtln over the
flagship extractor's data, then mmi_phases: gmm_mmi over the generic
recipe's corpus), each held to tools/backend_jax_bar.py's and
tools/mmi_synthetic_jax_bar.py's bars; with --synthetic the synthetic
demo recipe alone (synthetic_run).

With --mkgraph it runs chip_smoke.py's graph and scoring tool phases
alone: mkgraph_legacy and scoring_legacy (mkgraph_phases, after the
legacy graph's int16-wire decode, online2_graph and xconfig_graph, which
make the .mdl, words and the xconfig checkpoint that
nnet3-latgen-faster reads), then mkgraph_template after one call of the
generic recipe at its defaults (stages 0-7), each held to
tools/mkgraph_jax_bar.py's and tools/template_jax_bar.py's bars.

With --profile-check it runs the main path's slice_ng and profile_ng
with profile_ng's tables built twice: from the profiler's raw events (as
chip_smoke.py builds them) and from torch's event tree (key_averages and
the events' children, as chip_smoke.py built them before), the seconds
of each reported, the two held equal.

Run: python3 chip_main_path.py [--online | --legacy | --train |
     --train-scale | --nnet3 | --online2 | --xconfig | --latgen |
     --chain-cli | --disc | --chain-frame | --template | --ivector |
     --backend | --synthetic | --mkgraph | --profile-check]
     (needs CUDA)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from kaldi_tpu_torch.decoder.lexchain_ng import INF
from kaldi_tpu_torch.lat.functions import lattice_best_path


def probe_lattice_rules(dec, ll, lens, wer, utts) -> None:
    """Lattice mode under the reference's two rules that the port
    changed, on the 128 lanes' loglikes: how many word-end events its
    survivor rule (cost within the beam of the lane's final best) keeps,
    and the lattices, the lanes whose lattice best path differs from
    decode_batch with the same pool, and the WER when the best path's word
    ends are not put into the events (the reference's selection), with 64
    and with 256 events a frame."""
    best = dec.decode_batch(ll, lengths=lens, prune_k=cs.NG_LAT_POOL)
    T, B = ll.shape[1], ll.shape[0]
    K = min(cs.NG_LAT_POOL, dec.VC)
    with torch.inference_mode():
        am = (-ll).permute(1, 2, 0).contiguous()
        active = torch.as_tensor(np.arange(T)[:, None] < lens[None, :],
                                 device=dec.device)
        none = torch.full((T, B), -1, device=dec.device)
        roots, sil, sil_t, outs = dec._forward_lattice(am, active, K, 64,
                                                       none)
        lane_best = dec._finals(roots, sil, sil_t)[4]
        ev_val = outs["ev_val"]
        live = (ev_val < INF / 2) & active[:, :, None]
        kept = live & (ev_val <= lane_best[None, :, None] + cs.LAT_BEAM
                       + 1e-3)
        n_live, n_kept = int(live.sum()), int(kept.sum())
        lanes_kept = int(kept.any(dim=2).any(dim=0).sum())
        del outs, ev_val, live, kept
    cs.emit("probe_survivor_rule", events=n_live,
            events_within_beam_of_final_best=n_kept,
            lanes_with_such_events=lanes_kept, beam=cs.LAT_BEAM)
    forced = dec._viterbi_word_ends
    dec._viterbi_word_ends = lambda am, active, K: torch.full(
        active.shape, -1, device=active.device)
    try:
        for cap in (64, 256):
            stats = {}
            t0 = time.perf_counter()
            lats = dec.decode_batch_lattice(ll, lengths=lens,
                                            lattice_beam=cs.LAT_BEAM,
                                            event_cap=cap, stats=stats)
            seconds = time.perf_counter() - t0
            words = [[] if lat is None else lattice_best_path(lat)[1]
                     for lat in lats]
            cs.emit("probe_reference_events", event_cap=cap,
                    lattices=sum(lat is not None for lat in lats),
                    lanes_words_differ=[i for i, (w, h) in
                                        enumerate(zip(words, best))
                                        if w != h[0]],
                    wer=wer([(w,) for w in words], utts),
                    wer_same_pool=wer(best, utts), seconds=seconds,
                    stats=stats)
    finally:
        dec._viterbi_word_ends = forced


def online() -> None:
    """chip_smoke.py's online phases of the main path alone."""
    cfg, _variables, model, ivec, fe = cs.flagship_am()
    ng = cs.build_ng_path()
    utts = sorted(ng["test_wav"])
    waves = [cs.mulaw_encode(np.clip(ng["test_wav"][u], -32767, 32767))
             for u in utts]
    pipe = cs.BatchedOfflinePipeline2(model, ng["dec"], fe,
                                      sample_rate=ng["spec"].fs,
                                      ivector_extractor=ivec, device="cuda")
    ll, lens = pipe.loglikes(*fe.compute_batch_device(waves))
    hyps = ng["dec"].decode_batch(ll, lengths=lens, **cs.NG_SEARCH)
    outs = [None if h is None else (h[0], h[2]) for h in hyps]
    test_txt = ng["test_txt"]
    wer = cs.wer_of(dict(zip(utts, cs.ng_words(ng["graph"], hyps))),
                    test_txt)
    errors = cs.word_errors(wer, test_txt)
    cs.emit("offline_ng", wer=wer, word_errors=errors)
    cs.run_online_ng(ng, model, ivec, fe)
    cs.run_online_stream_offline(ng, ll, lens, outs, errors)
    cs.run_online_batcher(ng, ll, lens)


def latgen() -> dict:
    """xconfig_graph and xconfig_latgen over the 128 test utterances;
    the WER bar of slice_lex_int16."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sysd = cs.run_online2_graph(tmp, n_utts=None)
        x = cs.run_xconfig_graph(sysd)
        r = cs.run_xconfig_latgen(x, sysd)["res"]
    out = {"utterances": r["utterances"], "wer": r["wer"],
           "word_errors": r["word_errors"], "ref_words": r["ref_words"],
           "bar_wer": cs.SLICE_LEX_INT16_WER,
           "bar_word_errors": cs.SLICE_LEX_INT16_ERRORS,
           "rtf": r["rtf"], "search_ms_a_frame": r["search_ms_a_frame"],
           "seconds": time.perf_counter() - t0}
    if abs(r["wer"] - cs.SLICE_LEX_INT16_WER) > 0.5 or \
            abs(r["word_errors"] - cs.SLICE_LEX_INT16_ERRORS) > 8:
        cs.emit("latgen_summary", **out)
        raise SystemExit(f"latgen: WER {r['wer']:.3f}% ({r['word_errors']} "
                         f"errors), outside 0.5 points and 8 words of "
                         f"{cs.SLICE_LEX_INT16_WER:.3f}%")
    return out


def mkgraph() -> dict:
    """mkgraph_legacy, scoring_legacy and mkgraph_template."""
    lex = cs.build_lex_path()
    words16 = cs.lex_int16_words(lex, *cs.legacy_am(lex))
    del lex
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        sysd = cs.run_online2_graph(tmp)
        cs.run_xconfig_graph(sysd)
        out = cs.mkgraph_phases(sysd, words16)
    with tempfile.TemporaryDirectory() as root:
        with contextlib.redirect_stdout(sys.stderr):
            run = cs.run_template_recipe(root)
        run["root"] = root
        tmpl = cs.run_mkgraph_template(run)
    out.pop("launches")
    out["mkgraph_template"] = {k: v for k, v in tmpl.items()
                               if k != "launches"}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--online", action="store_true",
                      help="run chip_smoke.py's online phases of the main "
                      "path alone")
    mode.add_argument("--legacy", action="store_true",
                      help="run chip_smoke.py's legacy-path phases alone")
    mode.add_argument("--train", action="store_true",
                      help="run chip_smoke.py's training phases alone")
    mode.add_argument("--train-scale", action="store_true",
                      help="run chip_smoke.py's --scale training phases "
                      "alone")
    ap.add_argument("--epochs", type=int, default=None,
                    help="with --train or --train-scale: the epochs to "
                    "train (the recipe's by default, 8 and 16; "
                    "chip_smoke.py trains SMOKE_TRAIN_EPOCHS and "
                    "SMOKE_SCALE_EPOCHS); with --template: stage 8's "
                    "(TEMPLATE_CHAIN_EPOCHS by default)")
    mode.add_argument("--nnet3", action="store_true",
                      help="run chip_smoke.py's nnet3 phases alone")
    mode.add_argument("--online2", action="store_true",
                      help="run chip_smoke.py's online2 phases alone")
    mode.add_argument("--xconfig", action="store_true",
                      help="run chip_smoke.py's xconfig phases alone")
    mode.add_argument("--chain-cli", action="store_true",
                      help="run chip_smoke.py's chain tool phases alone, "
                      "after train_lex's system without its training")
    mode.add_argument("--disc", action="store_true",
                      help="run chip_smoke.py's disc_smbr alone and export "
                      "tools/disc_jax_bar.py's inputs")
    mode.add_argument("--chain-frame", action="store_true",
                      help="run chip_smoke.py's train_chain_frame and "
                      "ng_precondition alone")
    mode.add_argument("--latgen", action="store_true",
                      help="run xconfig_graph and xconfig_latgen over the "
                      "128 test utterances")
    mode.add_argument("--template", action="store_true",
                      help="run chip_smoke.py's template_gmm phase alone")
    mode.add_argument("--ivector", action="store_true",
                      help="run chip_smoke.py's i-vector phases alone")
    mode.add_argument("--backend", action="store_true",
                      help="the back-end, VTLN and MMI phases alone")
    mode.add_argument("--synthetic", action="store_true",
                      help="the synthetic demo recipe alone")
    mode.add_argument("--mkgraph", action="store_true",
                      help="the graph and scoring tool phases alone")
    mode.add_argument("--profile-check", action="store_true",
                      help="run slice_ng and profile_ng with profile_ng's "
                      "tables also built from torch's event tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_main_path: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    if args.online or args.legacy or args.train or args.train_scale \
            or args.nnet3 or args.online2 or args.xconfig or args.latgen \
            or args.chain_cli or args.template or args.profile_check \
            or args.disc or args.chain_frame or args.ivector \
            or args.backend or args.synthetic or args.mkgraph:
        if args.mkgraph:
            cs.emit("mkgraph_summary", **mkgraph())
            done = "mkgraph_done"
        elif args.backend:
            cs.emit("backend_summary", **{
                name: {k: v for k, v in phase.items() if k != "launches"}
                for name, phase in {**cs.backend_phases(),
                                    **cs.mmi_phases()}.items()})
            done = "backend_done"
        elif args.synthetic:
            with tempfile.TemporaryDirectory() as root:
                with contextlib.redirect_stdout(sys.stderr):
                    out = cs.run_synthetic(root)
            cs.emit("synthetic_summary", **{k: v for k, v in out.items()
                                            if k != "launches"})
            done = "synthetic_done"
        elif args.ivector:
            cs.emit("ivector_summary", **{
                name: {k: v for k, v in phase.items() if k != "launches"}
                for name, phase in cs.ivector_phases().items()})
            done = "ivector_done"
        elif args.template:
            cs.emit("template_summary", **{
                name: {k: v for k, v in phase.items() if k != "launches"}
                for name, phase in cs.template_phases(
                    args.epochs or cs.TEMPLATE_CHAIN_EPOCHS).items()})
            done = "template_done"
        elif args.profile_check:
            cfg, _variables, model, ivec, fe = cs.flagship_am()
            cs.run_ng_slice(cs.build_ng_path(), model, ivec, fe,
                            cross_check=True)
            done = "profile_check_done"
        elif args.xconfig:
            with tempfile.TemporaryDirectory() as tmp:
                cs.emit("xconfig_summary", **cs.xconfig_phases(
                    cs.run_online2_graph(tmp)))
            done = "xconfig_done"
        elif args.latgen:
            cs.emit("latgen_summary", **latgen())
            done = "latgen_done"
        elif args.disc:
            with tempfile.TemporaryDirectory() as tmp:
                sysd = cs.run_online2_graph(tmp)
                x = cs.run_xconfig_graph(sysd)
                lat = cs.run_xconfig_latgen(x, sysd)
                cs.run_disc_smbr(x, sysd, lat["res"]["wer"],
                                 export=os.path.join(cs.REPO, "_chip",
                                                     "disc_smbr"))
            done = "disc_done"
        elif args.chain_frame:
            cs.emit("chain_frame_summary",
                    **cs.chain_frame_phases(cs.chain_cli_system()))
            done = "chain_frame_done"
        elif args.online2:
            lex = cs.build_lex_path()
            words16 = cs.lex_int16_words(lex, *cs.legacy_am(lex))
            del lex
            cs.emit("online2_summary", **cs.online2_phases(words16,
                                                            xconfig=False))
            done = "online2_done"
        elif args.nnet3:
            cfg, variables, _model, ivec, fe = cs.flagship_am()
            cs.emit("nnet3_summary", **cs.nnet3_phases(
                cs.build_ng_path(), cfg, variables, ivec, fe))
            done = "nnet3_done"
        elif args.online:
            online()
            done = "online_done"
        elif args.legacy:
            legacy = cs.legacy_phases()
            legacy.pop("words_int16")
            cs.emit("legacy_summary", **legacy)
            done = "legacy_done"
        elif args.train_scale:
            cs.emit("train_scale_summary",
                    **cs.train_scale_phases(args.epochs
                                            or cs.SCALE_EPOCHS))
            done = "train_scale_done"
        elif args.chain_cli:
            cs.emit("chain_cli_summary",
                    **cs.chain_cli_phases(cs.chain_cli_system()))
            done = "chain_cli_done"
        else:
            cs.emit("train_summary", **cs.train_phases(
                args.epochs or cs.TRAIN_EPOCHS)[0])
            done = "train_done"
        cs.emit(done, seconds=time.perf_counter() - t_all)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    cfg, variables, model, ivec, fe = cs.flagship_am()
    ng = cs.build_ng_path()
    cs.NG_WER_BAND = float("inf")
    res = cs.run_ng_slice(ng, model, ivec, fe)
    ll, lens = res["loglikes"], res["out_lens"]
    cs.ng_cpu_check(ng, ll, lens)
    cs.cross_check_ng(ng)
    cs.run_ng_lattice(ng, model, ivec, fe, ll, lens)
    cs.ng_lattice_cpu_check(ng, ll, lens)
    graph, dec, test_txt = ng["graph"], ng["dec"], ng["test_txt"]
    utts = sorted(ng["test_wav"])
    waves = [cs.mulaw_encode(np.clip(ng["test_wav"][u], -32767, 32767))
             for u in utts]

    def wer(outs, lanes):
        return cs.wer_of({u: [graph.words[w] for w in o[0]]
                          for u, o in zip(lanes, outs)},
                         {u: test_txt[u] for u in lanes})

    pipe32 = cs.BatchedOfflinePipeline2(
        cs.chain_tdnnf_from_flax(cfg, variables, device="cuda"), dec, fe,
        ivector_extractor=ivec, search_kwargs=cs.NG_SEARCH, device="cuda")
    cs.emit("probe_f32_am", wer=wer(pipe32.decode_batch(waves), utts))
    n = 16
    t0 = time.perf_counter()
    exact = dec.decode_batch(ll[:n], lengths=lens[:n])
    exact_s = time.perf_counter() - t0
    pruned = dec.decode_batch(ll[:n], lengths=lens[:n], **cs.NG_SEARCH)
    cs.emit("probe_exact_pool", lanes=n, wer_exact=wer(exact, utts[:n]),
            wer_pruned=wer(pruned, utts[:n]), exact_s=exact_s,
            lanes_words_equal=sum(a[0] == b[0]
                                  for a, b in zip(exact, pruned)),
            cost_exact=[a[2] for a in exact[:4]],
            cost_pruned=[b[2] for b in pruned[:4]])
    probe_lattice_rules(dec, ll, lens, wer, utts)
    cs.emit("probe_done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
