"""Context-dependent (triphone) GMM training (port of
`kaldi_tpu/recipes/deltas.py`, the steps/train_deltas.sh equivalent):
tree stats from a previous system's alignments, question generation,
tree building, model init from tree stats, alignment conversion, then EM
with realignment and mixing-up.  The statistics stay on the host; the
GMMs score on the device of the previous system's model, and the
alignments are `recipes/mono.py` `_align_all`'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.base.logging import log, warn
from kaldi_tpu_torch.decoder.graph import Lang, TrainingGraphCompiler
from kaldi_tpu_torch.device import DeviceLike
from kaldi_tpu_torch.gmm.am_diag_gmm import AmDiagGmm
from kaldi_tpu_torch.gmm.diag_gmm import DiagGmm
from kaldi_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_tpu_torch.recipes.mono import (MonoSystem, TrainMonoOptions,
                                          _align_all, _estimate)
from kaldi_tpu_torch.tree.build_tree import (BuildTreeOptions,
                                             accumulate_tree_stats,
                                             build_tree, cluster_phones)
from kaldi_tpu_torch.tree.clusterable import sum_clusterables
from kaldi_tpu_torch.tree.event_map import PDF_CLASS_KEY


@dataclass
class TrainDeltasOptions:
    num_iters: int = 25
    max_iter_inc: int = 15
    totgauss: int = 2000
    num_leaves: int = 100
    beam: float = 10.0
    realign_iters: Sequence[int] = field(default_factory=lambda: (
        10, 20, 30))
    transition_scale: float = 1.0
    acoustic_scale: float = 0.1
    self_loop_scale: float = 0.1
    min_gaussian_occupancy: float = 3.0
    tree_min_gain: float = 20.0
    cluster_thresh: float = -1.0


def convert_alignment(old_ali: Sequence[int], old_tm: TransitionModel,
                      new_tm: TransitionModel, new_tree,
                      topo) -> Optional[List[int]]:
    """convert-ali: map a previous system's alignment onto a new tree
    (same topology/phone sequence; pdfs re-assigned by context)."""
    N, P = new_tree.context_width(), new_tree.central_position()
    # segment into phones with (hmm_state, trans_index) per frame
    segs: List[Tuple[int, List[Tuple[int, int]]]] = []
    for tid in old_ali:
        phone = old_tm.transition_id_to_phone(tid)
        hmm_state = old_tm.transition_id_to_hmm_state(tid)
        ts = old_tm.transition_id_to_transition_state(tid)
        idx = tid - old_tm.state2id[ts]
        is_start = hmm_state == 0 and not old_tm.is_self_loop(tid)
        if is_start or not segs:
            segs.append((phone, []))
        segs[-1][1].append((hmm_state, idx))
    phone_seq = [p for p, _ in segs]
    out: List[int] = []
    for i, (phone, frames) in enumerate(segs):
        window = []
        for off in range(-P, N - P):
            j = i + off
            window.append(phone_seq[j] if 0 <= j < len(phone_seq) else 0)
        entry = topo.topology_for_phone(phone)
        for hmm_state, idx in frames:
            st = entry[hmm_state]
            fwd_pdf = new_tree.compute(window, st.forward_pdf_class)
            slf_pdf = new_tree.compute(window, st.self_loop_pdf_class)
            if fwd_pdf is None or slf_pdf is None:
                warn(f"convert_alignment: no pdf for window {window}")
                return None
            ts = new_tm.tuple_to_transition_state(phone, hmm_state,
                                                  fwd_pdf, slf_pdf)
            out.append(new_tm.pair_to_transition_id(ts, idx))
    return out if len(out) == len(old_ali) else None


def init_model_from_tree_stats(tree, tm: TransitionModel,
                               stats: Dict, dim: int,
                               device: DeviceLike = None) -> AmDiagGmm:
    """gmm-init-model: each pdf gets a single Gaussian from its pooled
    tree stats (falling back to global stats); it scores on `device`."""
    per_pdf: Dict[int, List] = {}
    for event, stat in stats.items():
        d = dict(event)
        window = [d.get(k, 0) for k in range(tree.context_width())]
        pdf = tree.compute(window, d[PDF_CLASS_KEY])
        if pdf is not None:
            per_pdf.setdefault(pdf, []).append(stat)
    glob = sum_clusterables(list(stats.values()))
    am = AmDiagGmm(device=device)
    for pdf in range(tree.num_pdfs):
        g = DiagGmm(1, dim)
        src = (sum_clusterables(per_pdf[pdf]) if pdf in per_pdf else glob)
        if src.count < 3:
            src = glob
        g.set_from_means_and_vars([1.0], src.mean()[None, :],
                                  src.var()[None, :])
        am.add_pdf(g)
    return am


def train_deltas(lang: Lang, feats: Dict[str, np.ndarray],
                 transcripts: Dict[str, List[str]],
                 prev_sys: MonoSystem,
                 prev_alignments: Dict[str, List[int]],
                 opts: Optional[TrainDeltasOptions] = None,
                 N: int = 3, P: int = 1) -> MonoSystem:
    if opts is None:
        opts = TrainDeltasOptions()
    topo = prev_sys.tm.topo
    sil_id = lang.phones[lang.sil_phone]
    # 1. tree stats
    stats: Dict = {}
    for utt, ali in prev_alignments.items():
        accumulate_tree_stats(prev_sys.tm, topo, feats[utt], ali, N, P,
                              stats, ci_phones=[sil_id])
    log(f"tree stats: {len(stats)} events")
    # 2. questions
    phones = sorted(lang.phones.values())
    phone_qs = cluster_phones(stats, phones, P)
    max_pc = max(topo.num_pdf_classes(p) for p in phones)
    pc_qs = [list(range(k + 1)) for k in range(max_pc)]
    questions = {k: phone_qs for k in range(N)}
    questions[PDF_CLASS_KEY] = pc_qs
    # 3. roots: silence = its own shared non-split root; the rest shared+split
    roots = [([p], True, True) for p in phones if p != sil_id]
    roots.append(([sil_id], True, False))
    tree = build_tree(stats, questions, roots, N, P,
                      BuildTreeOptions(max_leaves=opts.num_leaves,
                                       min_gain=opts.tree_min_gain),
                      topo=topo)
    tm = TransitionModel(topo, tree)
    dim = next(iter(feats.values())).shape[1]
    am = init_model_from_tree_stats(tree, tm, stats, dim,
                                    device=prev_sys.am.device)
    sys_ = MonoSystem(lang, tree, tm, am)
    # 4. convert alignments + first estimate
    alignments = {}
    for utt, ali in prev_alignments.items():
        conv = convert_alignment(ali, prev_sys.tm, tm, tree, topo)
        if conv is not None:
            alignments[utt] = conv
    log(f"converted {len(alignments)}/{len(prev_alignments)} alignments")
    est_opts = TrainMonoOptions(
        min_gaussian_occupancy=opts.min_gaussian_occupancy,
        acoustic_scale=opts.acoustic_scale)
    _estimate(sys_, feats, alignments, est_opts, mixup=None)
    # 5. graphs + EM
    compiler = TrainingGraphCompiler(tm, tree, lang, opts.transition_scale,
                                     opts.self_loop_scale)
    graphs = {utt: compiler.compile(transcripts[utt]) for utt in feats}
    num_gauss = am.num_gauss()
    inc = max(1, (opts.totgauss - num_gauss) // opts.max_iter_inc) \
        if opts.totgauss > num_gauss else 0
    for it in range(1, opts.num_iters):
        if it in opts.realign_iters:
            alignments = _align_all(sys_, graphs, feats, opts.beam,
                                    opts.acoustic_scale,
                                    opts.transition_scale, prev=alignments)
        if num_gauss < opts.totgauss:
            num_gauss = min(opts.totgauss, num_gauss + inc)
        _estimate(sys_, feats, alignments, est_opts, mixup=num_gauss)
    return sys_
