"""Port parity: the block-chain frame step and decoder of
kaldi_tpu_torch against the JAX reference (Pallas kernel a in interpret
mode).  The step's plain version must equal kernel a exactly (adds, mins
and compares only); decode_batch must give equal words and tids, and
costs within 1e-5 relative.  The port's block-chain decoder is also held
against two independent decoders of the port on `to_flat_graph()`: equal
words and tids, costs within 1e-3 * max(1, |cost|) (the bar of the JAX
package's own tests/test_block_chain.py)."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas

from kaldi_tpu.decoder.block_chain import BlockChainDecoder as JaxDecoder
from kaldi_tpu.decoder.block_chain import BlockChainGraph as JaxGraph
from kaldi_tpu.decoder.graph_direct import DirectGraphSpec as JaxSpec
from kaldi_tpu.decoder.graph_direct import synth_bigram as jax_bigram
from kaldi_tpu.decoder.graph_direct import synth_lexicon as jax_lexicon
from kaldi_tpu_torch.decoder.batched_viterbi import BatchedViterbi
from kaldi_tpu_torch.decoder.block_chain import (BlockChainDecoder,
                                                 BlockChainGraph)
from kaldi_tpu_torch.decoder.graph_direct import (DirectGraphSpec,
                                                  synth_bigram, synth_lexicon)
from kaldi_tpu_torch.decoder.viterbi import (FasterDecoder,
                                             FasterDecoderOptions)
from kaldi_tpu_torch.ops.block_chain_step import (INF, block_chain_step,
                                                  block_chain_step_reference)


def graphs(seed=0, V=9, num_pdfs=48, max_pron=4):
    """The same small graph (one-phone words included) on both sides."""
    kw = dict(vocab=V, num_phones=6, min_pron=1, max_pron=max_pron,
              num_pdfs=num_pdfs, seed=seed)
    jg = JaxGraph.build(jax_lexicon(JaxSpec(**kw)), jax_bigram(JaxSpec(**kw)),
                        eos_cost=1.5, num_pdfs=num_pdfs)
    spec = DirectGraphSpec(**kw)
    tg = BlockChainGraph.build(synth_lexicon(spec), synth_bigram(spec),
                               eos_cost=1.5, num_pdfs=num_pdfs)
    return jg, tg


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_build_matches(seed):
    jg, tg = graphs(seed)
    for name in ("word_order", "row_word", "row_pos", "row_phone",
                 "row_is_first", "end_row", "pdf_fwd_row", "pdf_self_row",
                 "pdf_wend_fwd", "pdf_root_self", "bigram", "eos_cost"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)
    assert tg.seg_lens == jg.seg_lens
    assert (tg.N, tg.n_true, tg.num_states) == (jg.N, jg.n_true,
                                                jg.num_states)


def _jax_kernel_a(monkeypatch, jdec, B):
    """Capture the pallas_call kernel a that _make_step builds."""
    captured = []
    orig = pallas.pallas_call

    def spy(*args, **kwargs):
        fn = orig(*args, **kwargs)
        captured.append(fn)
        return fn

    monkeypatch.setattr(pallas, "pallas_call", spy)
    jdec._make_step(B)
    assert len(captured) == 1
    return captured[0]


def _random_step_inputs(rng, dec, B):
    g = dec.g
    Up, N = dec.Up, g.N
    cost = (rng.normal(size=(Up, N, B)) * 5 + 20).astype(np.float32)
    cost[rng.random(cost.shape) < 0.2] = INF
    ovr = (rng.normal(size=(Up, B)) * 5 + 15).astype(np.float32)
    ovr[rng.random(ovr.shape) < 0.2] = INF
    amf = rng.normal(size=(N, B)).astype(np.float32)
    ams = rng.normal(size=(N, B)).astype(np.float32)
    return cost, ovr, amf, ams


@pytest.mark.parametrize("seed,B", [(0, 3), (1, 5)])
def test_step_plain_equals_kernel_a(monkeypatch, seed, B):
    jg, tg = graphs(seed)
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    assert (dec.Up, dec.Vp) == (jdec.Up, jdec.Vp)
    kernel_a = _jax_kernel_a(monkeypatch, jdec, B)
    rng = np.random.default_rng(seed + 7)
    cost, ovr, amf, ams = _random_step_inputs(rng, dec, B)
    first_f = jg.row_is_first.astype(np.float32)[:, None]
    j_new, j_bits, j_exp, j_arg = kernel_a(
        cost, ovr, amf, ams, first_f, np.asarray(jdec._bigram_ends))
    active = torch.ones(B, dtype=torch.bool)
    t_new, t_bits, t_exp, t_arg = block_chain_step_reference(
        torch.from_numpy(cost), torch.from_numpy(ovr), torch.from_numpy(amf),
        torch.from_numpy(ams), dec._first, dec._bigram_ends, dec._end_src,
        active)
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_bits))
    np.testing.assert_array_equal(t_exp.numpy(), np.asarray(j_exp))
    np.testing.assert_array_equal(t_arg.numpy(), np.asarray(j_arg))
    # the bits and both root planes exercise real decisions
    assert 0 < np.count_nonzero(np.asarray(j_bits))
    assert (np.asarray(j_exp) < INF).any()


def test_step_freezes_inactive_lanes_and_fills_outputs():
    _, tg = graphs(2)
    dec = BlockChainDecoder(tg, device="cpu")
    B = 4
    rng = np.random.default_rng(5)
    cost, ovr, amf, ams = [torch.from_numpy(a) for a in
                           _random_step_inputs(rng, dec, B)]
    active = torch.tensor([True, False, True, False])
    new = torch.empty_like(cost)
    bits = torch.empty((dec.Up, tg.N // 8, B), dtype=torch.uint8)
    out = block_chain_step(cost, ovr, amf, ams, dec._first,
                           dec._bigram_ends, dec._end_src, active,
                           new=new, bits=bits)
    assert out[0] is new and out[1] is bits
    torch.testing.assert_close(new[:, :, ~active], cost[:, :, ~active],
                               rtol=0, atol=0)
    all_on = block_chain_step_reference(
        cost, ovr, amf, ams, dec._first, dec._bigram_ends, dec._end_src,
        torch.ones(B, dtype=torch.bool))
    torch.testing.assert_close(new[:, :, active], all_on[0][:, :, active],
                               rtol=0, atol=0)
    for a, b in zip(out[1:], all_on[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_batch_matches_jax(seed):
    jg, tg = graphs(seed)
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    rng = np.random.default_rng(seed + 20)
    B, T = 3, 9
    ll = rng.normal(size=(B, T, jg.num_pdfs)).astype(np.float32)
    lengths = [T, T - 2, T - 5]
    ref = jdec.decode_batch(ll, acoustic_scale=1.0, lengths=lengths)
    out = dec.decode_batch(ll, acoustic_scale=1.0, lengths=lengths)
    for b in range(B):
        assert ref[b] is not None and out[b] is not None
        assert out[b][0] == ref[b][0], f"lane {b} words"
        assert out[b][1] == ref[b][1], f"lane {b} tids"
        assert abs(out[b][2] - ref[b][2]) <= 1e-5 * max(1.0, abs(ref[b][2]))


def test_decode_batch_long_words_scaled_acoustics():
    """Longer pronunciations (several length segments) and an acoustic
    scale other than 1."""
    jg, tg = graphs(4, V=12, num_pdfs=64, max_pron=6)
    jdec = JaxDecoder(jg, interpret=True)
    dec = BlockChainDecoder(tg, device="cpu")
    rng = np.random.default_rng(44)
    ll = rng.normal(size=(2, 14, 64)).astype(np.float32)
    ref = jdec.decode_batch(ll, acoustic_scale=0.7, lengths=[14, 11])
    out = dec.decode_batch(ll, acoustic_scale=0.7, lengths=[14, 11])
    for r, o in zip(ref, out):
        assert o[0] == r[0] and o[1] == r[1]
        assert abs(o[2] - r[2]) <= 1e-5 * max(1.0, abs(r[2]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_match_batched_viterbi_and_host(seed):
    """Three decoders of the port on one graph: the block-chain layout,
    the dense batched Viterbi over its flat form, and host token
    passing."""
    _, tg = graphs(seed)
    fst = tg.to_flat_graph().to_vector_fst()
    dec = BlockChainDecoder(tg, device="cpu")
    dense = BatchedViterbi(fst, tg.tid2pdf, device="cpu")
    host = FasterDecoder(fst, FasterDecoderOptions(beam=1e9,
                                                   max_active=10 ** 9))
    rng = np.random.default_rng(seed + 20)
    B, T = 3, 9
    ll = rng.normal(size=(B, T, tg.num_pdfs)).astype(np.float32)
    lengths = [T, T - 2, T - 5]
    out = dec.decode_batch(ll, acoustic_scale=1.0, lengths=lengths)
    out_dense = dense.run(ll, lengths)
    for b in range(B):
        ref = host.decode(ll[b, :lengths[b]], tg.tid2pdf, acoustic_scale=1.0)
        assert ref is not None and out[b] is not None
        words, tids, cost = out[b]
        for name, (r_ali, r_words, r_cost) in (("host", ref),
                                               ("dense", out_dense[b])):
            assert abs(cost - r_cost) < 1e-3 * max(1.0, abs(r_cost)), \
                f"lane {b} {name}: {cost} vs {r_cost}"
            assert words == r_words, f"lane {b} {name}"
            assert tids == r_ali, f"lane {b} {name}"
