"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and nvcc, so they skip elsewhere;
on a machine with a card run them with
`python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q`.
They import no jax, so they run where only the port is installed."""

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.decoder.batched_viterbi import BatchedViterbi
from kaldi_tpu_torch.decoder.block_chain import (BlockChainDecoder,
                                                 BlockChainGraph)
from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                  synth_bigram, synth_lexicon)
from kaldi_tpu_torch.online.batched_device_pipeline import \
    BatchedDeviceOnlinePipeline
from kaldi_tpu_torch.ops import block_chain_lattice_step as bcl
from kaldi_tpu_torch.ops import block_chain_step as bcs
from kaldi_tpu_torch.ops import viterbi_relax as vr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_decoder(seed, device, V=23):
    spec = DirectGraphSpec(vocab=V, num_phones=6, min_pron=1, max_pron=5,
                           num_pdfs=64, seed=seed)
    g = BlockChainGraph.build(synth_lexicon(spec), synth_bigram(spec),
                              num_pdfs=64)
    return BlockChainDecoder(g, device=device)


@pytest.mark.parametrize("seed,B", [(0, 1), (1, 19), (2, 64), (3, 129)])
def test_step_kernel_equals_plain(cuda, seed, B):
    dec = small_decoder(seed, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    Up, N = dec.Up, dec.g.N
    cost = torch.randn(Up, N, B, generator=gen, device=cuda) * 5 + 20
    cost[torch.rand(cost.shape, generator=gen, device=cuda) < 0.2] = bcs.INF
    ovr = torch.randn(Up, B, generator=gen, device=cuda) * 5 + 15
    ovr[torch.rand(ovr.shape, generator=gen, device=cuda) < 0.2] = bcs.INF
    amf = torch.randn(N, B, generator=gen, device=cuda)
    ams = torch.randn(N, B, generator=gen, device=cuda)
    active = torch.rand(B, generator=gen, device=cuda) < 0.8
    args = (cost, ovr, amf, ams, dec._first, dec._bigram_ends, dec._end_src,
            active)
    before = bcs.launches
    got = bcs.block_chain_step(*args)
    assert bcs.launches == before + 1
    want = bcs.block_chain_step_reference(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("new", "bits", "rootexp", "rootarg"), got, want):
        assert torch.equal(g, w), name


def test_step_kernel_rejects_bad_inputs(cuda):
    dec = small_decoder(0, cuda)
    Up, N, B = dec.Up, dec.g.N, 4
    cost = torch.zeros(Up, N, B, device=cuda)
    ovr = torch.zeros(Up, B, device=cuda)
    am = torch.zeros(N, B, device=cuda)
    active = torch.ones(B, dtype=torch.bool, device=cuda)
    base = [cost, ovr, am, am, dec._first, dec._bigram_ends, dec._end_src,
            active]
    with pytest.raises(TypeError):
        bcs.block_chain_step(*([cost.double()] + base[1:]))
    with pytest.raises(ValueError):
        bcs.block_chain_step(*base, new=cost)
    with pytest.raises(ValueError):
        bcs.block_chain_step(*(base[:2] + [am[:, :2]] + base[3:]))


def test_decode_kernel_equals_plain(cuda):
    dec = small_decoder(5, cuda, V=31)
    plain = BlockChainDecoder(dec.g, device=cuda,
                              step=bcs.block_chain_step_reference)
    rng = np.random.default_rng(5)
    ll = rng.normal(size=(7, 25, 64)).astype(np.float32)
    lengths = [25, 24, 20, 13, 9, 25, 3]
    got = dec.decode_batch(ll, lengths=lengths)
    want = plain.decode_batch(ll, lengths=lengths)
    assert got == want
    assert all(h is not None for h in got)


def test_online_kernel_equals_plain(cuda):
    """Kernel a in the online pattern: the carry resumes from chunk to
    chunk, chunks are padded with act False, some lanes sit idle for
    whole chunks and come back, and three lanes are reset mid-session by
    init_channel.  After every chunk the carry is torch.equal to the
    plain step's, and each chunk launches the kernel Tc times."""
    dec = small_decoder(6, cuda, V=31)
    plain = BlockChainDecoder(dec.g, device=cuda,
                              step=bcs.block_chain_step_reference)
    rng = np.random.default_rng(6)
    B, Tc, P = 19, 4, dec.g.num_pdfs
    lls = [rng.normal(size=(int(rng.integers(6, 15)), P)).astype(np.float32)
           for _ in range(B + 3)]
    pipes = [BatchedDeviceOnlinePipeline(d, lambda f: f, feat_dim=P,
                                         num_lanes=B, chunk_frames=Tc)
             for d in (dec, plain)]
    lane_utt = list(range(B))
    cursor = [0] * B
    for pipe in pipes:
        for b in range(B):
            pipe.init_channel(b, f"u{b}")
    for rnd in range(14):
        if rnd == 4:                      # lanes 0-2 start anew
            for b in range(3):
                lane_utt[b], cursor[b] = B + b, 0
                for pipe in pipes:
                    pipe.init_channel(b, f"u{B + b}")
        idle = rng.random(B) < 0.3
        sizes = rng.integers(1, Tc + 3, B)
        for b in range(B):
            ll = lls[lane_utt[b]]
            if idle[b] or cursor[b] >= len(ll):
                continue
            for pipe in pipes:
                pipe.accept_features(b, ll[cursor[b]:cursor[b] + sizes[b]])
            cursor[b] += int(sizes[b])
        for pipe, launched in zip(pipes, (Tc, 0)):
            before = bcs.launches
            advanced = pipe.compute()
            assert bcs.launches - before == (launched if advanced else 0)
        torch.cuda.synchronize()
        assert torch.equal(pipes[0]._cost, pipes[1]._cost), rnd
        assert torch.equal(pipes[0]._ovr, pipes[1]._ovr), rnd
    got, want = ([p.finalize(b) for b in range(B)] for p in pipes)
    assert got == want and all(h is not None for h in got)


def lattice_step_args(dec, B, seed, t, ties=False):
    gen = torch.Generator(device=dec.device).manual_seed(seed)
    Up, N = dec.Up, dec.g.N

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dec.device)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dec.device)

    cost = randn(Up, N, B) * 5 + 20
    cost[rand(Up, N, B) < 0.2] = bcs.INF
    ovr = randn(Up, B) * 5 + 15
    ovr[rand(Up, B) < 0.2] = bcs.INF
    ent = torch.floor(rand(Up, N, B) * (t + 1))
    bigram_ends = dec._bigram_ends
    if ties:
        # equal candidates in every block, then some blocks lowered, so
        # that smaller candidates displace entries of equal cost
        cost[:] = cost[0].clone()
        ovr[:] = ovr[0].clone()
        for plane in (cost, ovr):
            plane[4:] += 1.0
            plane[3] -= 2.0
            plane[7] -= 5.0
        bigram_ends = torch.where(bigram_ends < bcs.INF, 1.25, bcs.INF)
    active = rand(B) < 0.8
    return (t, cost, ent, ovr, randn(N, B), randn(N, B), dec._first,
            bigram_ends, dec._end_src, active)


@pytest.mark.parametrize("seed,B,J,ties", [
    (0, 1, 4, False), (1, 19, 4, False), (2, 64, 2, False),
    (3, 129, 8, False), (4, 33, 4, True), (5, 7, 1, True)])
def test_lattice_step_kernel_equals_plain(cuda, seed, B, J, ties):
    dec = small_decoder(seed, cuda)
    args = lattice_step_args(dec, B, seed, t=seed + 3, ties=ties)
    before = bcl.launches
    got = bcl.block_chain_lattice_step(*args, J=J)
    assert bcl.launches == before + 1
    want = bcl.block_chain_lattice_step_reference(*args, J=J)
    torch.cuda.synchronize()
    for name, g, w in zip(("new", "ent_new", "rc", "ru", "re"), got, want):
        assert torch.equal(g, w), name
    if ties and J == 4:
        # blocks [7, 3, 2, 0]: a displaced entry passed its equals
        rc, ru = want[2], want[3]
        assert ((rc[2] == rc[3]) & (ru[2] > ru[3]) & (rc[3] < bcs.INF)).any()


def test_lattice_step_kernel_rejects_bad_inputs(cuda):
    dec = small_decoder(0, cuda)
    args = list(lattice_step_args(dec, 4, 0, t=2))
    cost, ent = args[1], args[2]
    with pytest.raises(TypeError):
        bcl.block_chain_lattice_step(*(args[:2] + [ent.double()] + args[3:]))
    with pytest.raises(ValueError, match="alias"):
        bcl.block_chain_lattice_step(*args, new=cost)
    with pytest.raises(ValueError, match="alias"):
        bcl.block_chain_lattice_step(*args, ent_new=ent)
    with pytest.raises(ValueError, match="J="):
        bcl.block_chain_lattice_step(*args, J=bcl.MAX_J + 1)
    with pytest.raises(ValueError):
        bcl.block_chain_lattice_step(*(args[:4] + [args[4][:, :2]]
                                       + args[5:]))


def lattice_key(lat):
    return (lat.start, lat.finals,
            [[tuple(a) for a in arcs] for arcs in lat.arcs])


def test_lattice_decode_kernel_equals_plain(cuda):
    dec = small_decoder(5, cuda, V=31)
    plain = BlockChainDecoder(
        dec.g, device=cuda,
        lattice_step=bcl.block_chain_lattice_step_reference)
    rng = np.random.default_rng(5)
    ll = rng.normal(size=(7, 25, 64)).astype(np.float32)
    lengths = [25, 24, 20, 13, 9, 25, 3]
    got = dec.decode_batch_lattice(ll, lengths=lengths, lattice_beam=10.0)
    want = plain.decode_batch_lattice(ll, lengths=lengths, lattice_beam=10.0)
    assert all(lat is not None for lat in got)
    assert [lattice_key(g) for g in got] == [lattice_key(w) for w in want]


def relax_args(device, seed, B, S, A, P, per_lane, lanes_fastest,
               full=0, big_ll0=False):
    """Seeded tables (per lane: graphs of different sizes, padded to a
    common K), their live counts, costs with INF entries and loglikes.
    full: state 0 gets exactly `full` in-arcs (a power of two) and no
    other state more, so that its K slots are all live; from 32 on, state
    1 gets five eighths of that, a long walk that ends in a dead slot, and
    the last state gets none.  big_ll0: loglikes column 0 is 1e25, so a
    dead slot's candidate is not 2e30."""
    rng = np.random.default_rng(seed)
    tabs = []
    for b in range(B if per_lane else 1):
        a = max(0, A - 3 * b)
        s_b = max(2, S - b)               # smaller graphs in later lanes
        src = rng.integers(0, s_b, a).astype(np.int32)
        dst = rng.integers(0, s_b, a).astype(np.int32)
        if a > 5:
            dst[:5] = 0                   # one state of in-degree >= 5
        if full:
            dst = (2 + np.arange(a) % (s_b - 3)).astype(np.int32)
            dst[:full] = 0
            if full >= 32:
                dst[full:full + 5 * full // 8] = 1
        w = rng.uniform(0, 2, a).astype(np.float32)
        pdf = rng.integers(0, P, a).astype(np.int32)
        tabs.append(vr.build_incoming_table(S, src, dst, w, pdf))
    K = max(t[3] for t in tabs)

    def pad(arr, fill):
        out = np.full((S, K), fill, arr.dtype)
        out[:, :arr.shape[1]] = arr
        return out

    fills = (S, vr.INF, 0)
    arrs = [np.stack([pad(t[i], fills[i]) for t in tabs]) for i in range(3)]
    if not per_lane:
        arrs = [a[0] for a in arrs]
    deg = vr.live_counts(*arrs)
    if full:
        assert K == full and (deg == K).any() and (deg == 0).any()
    cost = rng.uniform(0, 50, (B, S + 1)).astype(np.float32)
    cost[rng.random(cost.shape) < 0.3] = vr.INF
    cost[:, S] = vr.INF
    ll = (rng.normal(size=(B, P)) * 4).astype(np.float32)
    if big_ll0:
        ll[:, 0] = 1e25
    cost, ll, in_src, in_w, in_pdf, deg = (
        torch.from_numpy(a).to(device) for a in (cost, ll, *arrs, deg))
    if lanes_fastest:
        cost, ll = cost.T.contiguous().T, ll.T.contiguous().T
    return cost, in_src, in_w, in_pdf, ll, deg


@pytest.mark.parametrize("with_deg", [False, True])
@pytest.mark.parametrize("seed,B,S,A,per_lane,lanes_fastest,full,big_ll0", [
    (0, 1, 1, 0, False, True, 0, False),
    (1, 19, 37, 90, False, True, 0, False),
    (2, 19, 37, 90, True, True, 0, False),
    (3, 128, 301, 700, False, True, 0, False),
    (4, 33, 257, 400, True, False, 0, False),
    (5, 7, 64, 10, False, False, 0, False),
    (6, 64, 90, 200, False, True, 8, False),
    (7, 12, 40, 100, True, True, 8, True),
    (8, 128, 301, 700, False, True, 0, True),
    (9, 20, 70, 300, False, True, 64, False),
    (10, 7, 70, 300, False, True, 64, True)])
def test_relax_kernel_equals_plain(cuda, seed, B, S, A, per_lane,
                                   lanes_fastest, full, big_ll0, with_deg):
    """with_deg: the walk over live slots; without: the first version over
    all K slots.  Both equal the plain version bit for bit."""
    cost, in_src, in_w, in_pdf, ll, deg = relax_args(
        cuda, seed, B, S, A, 11, per_lane, lanes_fastest, full, big_ll0)
    kw = {"in_deg": deg} if with_deg else {}
    before = vr.launches
    got = vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, 0.7, **kw)
    want = vr.relax_padded(cost, in_src, in_w, in_pdf, ll, 0.7)
    closed = vr.viterbi_relax(cost, in_src, in_w, **kw)
    closed_want = vr.relax_padded(cost, in_src, in_w)
    assert vr.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(closed, closed_want)
    assert bool(torch.isfinite(got).all())
    # into a lanes-fastest (S+1, B) buffer, dead column included
    out = torch.zeros((S + 1, B), device=cuda)
    vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, 0.7, out=out.T, **kw)
    assert torch.equal(out.T[:, :S], want)
    assert bool((out[S] == float(vr.INF)).all())
    # the instantiation that this call took: the first version, or the live
    # walk with 4 lanes a thread where the layout allows it
    plan = vr.PreparedRelax(in_src, in_w, in_pdf, 0.7, kw.get("in_deg"))
    four = not per_lane and lanes_fastest and B % 4 == 0
    assert plan.lanes_a_thread(cost, ll, out.T) == \
        (0 if not with_deg else 4 if four else 1)
    # a closure step into such a buffer keeps the old dead column
    cost[:, S] = 3.0
    out.fill_(float("nan"))
    vr.viterbi_relax(cost, in_src, in_w, out=out.T, **kw)
    assert torch.equal(out.T[:, :S], vr.relax_padded(cost, in_src, in_w))
    assert bool((out[S] == 3.0).all())


def test_relax_kernel_rejects_bad_inputs(cuda):
    cost, in_src, in_w, in_pdf, ll, deg = relax_args(cuda, 0, 4, 9, 20, 5,
                                                     False, True)
    with pytest.raises(TypeError):
        vr.viterbi_relax(cost.double(), in_src, in_w, in_pdf, ll)
    with pytest.raises(TypeError):
        vr.viterbi_relax(cost, in_src.long(), in_w, in_pdf, ll)
    with pytest.raises(ValueError, match="go together"):
        vr.viterbi_relax(cost, in_src, in_w, in_pdf)
    with pytest.raises(ValueError):
        vr.viterbi_relax(cost[:, :-1], in_src, in_w, in_pdf, ll)
    with pytest.raises(ValueError, match="overlap"):
        vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, out=cost)
    with pytest.raises(ValueError):
        vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll.cpu())
    with pytest.raises(TypeError):
        vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, in_deg=deg.long())
    with pytest.raises(ValueError):
        vr.viterbi_relax(cost, in_src, in_w, in_pdf, ll, in_deg=deg[:-1])
    plan = vr.PreparedRelax(in_src, in_w, in_pdf, 1.0, deg)
    with pytest.raises(ValueError, match="overlap"):
        plan(cost, ll, out=cost)
    with pytest.raises(ValueError, match="go together"):
        plan(cost)
    with pytest.raises(TypeError):
        plan(cost, ll.double())
    with pytest.raises(ValueError, match="the tables on"):
        vr.PreparedRelax(in_src.cpu(), in_w.cpu(), in_pdf.cpu())(cost, ll)


def relax_all_slots(*args, in_deg=None, **kw):
    """The first version of the kernel: the live counts are dropped."""
    return vr.viterbi_relax(*args, **kw)


@pytest.mark.parametrize("with_deg", [False, True])
@pytest.mark.parametrize("per_lane", [False, True])
def test_batched_viterbi_kernel_equals_plain(cuda, per_lane, with_deg):
    """Shared tables and one graph a lane: the kernel (the live walk, and
    the first version over all slots) and the plain relaxation give
    identical hypotheses, and every relaxation of a run is one launch; a
    table set whose closure is the identity takes no closure launch."""
    dec = small_decoder(5, "cpu", V=13)
    flat = dec.g.to_flat_graph()
    fsts = [flat.to_vector_fst()]
    if per_lane:
        spec = DirectGraphSpec(vocab=7, num_phones=6, min_pron=1, max_pron=3,
                               num_pdfs=64, seed=9)
        other = BlockChainGraph.build(synth_lexicon(spec),
                                      synth_bigram(spec), num_pdfs=64)
        fsts = [fsts[0], other.to_flat_graph().to_vector_fst()] * 3
    rng = np.random.default_rng(6)
    ll = rng.normal(size=(6, 21, 64)).astype(np.float32)
    lengths = [21, 20, 13, 9, 21, 3]
    kernel = BatchedViterbi(fsts, flat.tid2pdf, device=cuda,
                            **({} if with_deg else
                               {"relax": vr.each_call(relax_all_slots)}))
    plain = BatchedViterbi(fsts, flat.tid2pdf, device=cuda,
                           relax=vr.each_call(vr.relax_padded))
    _, arrays, _, eps_iters = kernel._prepare(6)
    identity = vr.closure_is_identity(
        arrays["ne_in_src"], arrays["ne_in_w"],
        vr.live_counts(arrays["ne_in_src"], arrays["ne_in_w"]),
        arrays["e_in_src"], arrays["e_in_w"],
        vr.live_counts(arrays["e_in_src"], arrays["e_in_w"],
                       arrays["e_in_pdf"]))
    before = vr.launches
    got = kernel.run(ll, lengths)
    assert vr.launches == before + 21 + (0 if identity else 22 * eps_iters)
    assert got == plain.run(ll, lengths)
    assert all(h is not None for h in got)
    assert [len(h[0]) for h in got] == lengths


def test_bucketed_denominator_gradient_on_the_card(cuda):
    """The chain objective over the bucketed in-arc layout (PyTorch ops,
    no atomics) on the card: the gradient of a minibatch is bit-equal on
    two runs, and objective and gradient match the CPU's float64 within
    1e-5 relative (the gradient against its largest value)."""
    from kaldi_tpu_torch.chain import graphs as cg
    from kaldi_tpu_torch.chain import objective as obj
    from kaldi_tpu_torch.chain.supervision import make_denominator_graph
    from kaldi_tpu_torch.hmm.topology import HmmTopology
    from kaldi_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_tpu_torch.tree.context_dep import monophone_context_dependency
    phones = list(range(1, 26))
    tree = monophone_context_dependency(phones, {p: 2 for p in phones})
    tm = TransitionModel(HmmTopology.chain_topology(phones), tree)
    rng = np.random.default_rng(0)
    den = make_denominator_graph(
        [list(rng.integers(1, 26, int(rng.integers(8, 40))))
         for _ in range(100)], tm, tree)
    B, T, P = 8, 50, tm.num_pdfs
    nums = []
    for _ in range(B):
        init = np.full(T + 1, -1e30, np.float32)
        init[0] = 0.0
        final = np.full(T + 1, -1e30, np.float32)
        final[-1] = 0.0
        nums.append(cg.PackedGraph(
            np.arange(T, dtype=np.int32), np.arange(1, T + 1, dtype=np.int32),
            rng.integers(0, P, T).astype(np.int32),
            np.zeros(T, np.float32), init, final))
    packed = cg.batch_pack(nums)
    out = rng.normal(size=(B, T, P)).astype(np.float32) * 2
    opts = obj.ChainTrainingOptions(l2_regularize=5e-5,
                                    leaky_hmm_coefficient=0.1)
    runs = []
    for dev, dt in ((cuda, torch.float32), (cuda, torch.float32),
                    ("cpu", torch.float64)):
        x = torch.tensor(out, dtype=dt, device=dev, requires_grad=True)
        objf, _ = obj.chain_loss(opts, den, packed, x)
        objf.backward()
        runs.append((float(objf.detach()), x.grad.cpu().double().numpy()))
    assert runs[0][0] == runs[1][0]
    assert np.array_equal(runs[0][1], runs[1][1])
    assert abs(runs[0][0] - runs[2][0]) <= 1e-5 * abs(runs[2][0])
    ref = runs[2][1]
    assert np.abs(runs[0][1] - ref).max() <= 1e-5 * np.abs(ref).max()
