"""Batched Viterbi relaxation over a padded incoming-arc table: the CUDA
kernel `csrc/viterbi_relax.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel of `kaldi_tpu/ops/pallas_viterbi.py`,
`pallas_relax` (body :82-91, pallas_call :93), and keeps numpy copies of
that module's `INF` and `build_incoming_table`.

The decoder's per-frame hot op is, for every lane b and state s:

    new[b, s] = min_k ( cost[b, in_src[s, k]] + in_w[s, k]
                        - scale * loglikes[b, in_pdf[s, k]] )

over the padded incoming-arc table built once at pack time: K is the
largest in-degree rounded up to a power of two, a state's live slots come
first, and dead slots carry `src = S` (a dead state whose cost the caller
keeps at INF), `w = INF`, `pdf = 0`.  INF is 1e30, not infinity: a dead
candidate is the finite 2e30, and a state with no live in-arc ends there.
The padded table is the public form, as in the reference; `live_counts`
gives the per-state live counts (`in_deg`) with which the kernel walks
only the live slots and one dead slot a state, to the same result.

`relax_padded` and `viterbi_relax` take the same arguments:
  cost        (B, S+1) f32, column S the dead state
  in_src      (S, K) i32 shared by all lanes, or (B, S, K), one a lane
  in_w        f32, in_pdf i32: the shape of in_src
  loglikes_t  (B, P) f32
  out         optional (B, S) or (B, S+1) f32 to write into; with S+1
              columns the dead column is written too
  in_deg      optional (S,) or (B, S) i32 live counts of the tables
and return the (B, S) relaxed costs (a view of `out` when given).
With `in_pdf=None` they compute the epsilon-closure step instead: no
acoustic term, and the result is `min(cost[:, :S], update)` (the dead
column of `out` then keeps the old value).

cost, loglikes_t and out may be strided views: the batched decoder keeps
its tables lanes-fastest and passes transposed views, so that a warp of
the kernel reads one table entry and 32 neighbouring lanes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.ops import _build

INF = np.float32(1e30)

# calls that launched the CUDA kernel (not the plain version)
launches = 0

# A state of a shared table whose walk (its live slots and one dead slot)
# is longer than this gets a block of the kernel to itself, eight warps
# sharing the walk, ahead of all other blocks
LONG_WALK = 16


def build_incoming_table(num_states, src, dst, weight, pdf
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad incoming arcs per destination to a power-of-two K.
    Returns (in_src (S,K) int32, in_w (S,K) f32, in_pdf (S,K) int32, K).
    Dead slots: src = S (a dead state the caller keeps at INF),
    w = INF, pdf = 0.  A state's arcs fill its first slots in arc order."""
    S = num_states
    dst = np.asarray(dst, np.int64)
    counts = np.bincount(dst, minlength=S)
    kmax = int(counts.max(initial=1))
    K = 1
    while K < kmax:
        K *= 2
    in_src = np.full((S, K), S, np.int32)
    in_w = np.full((S, K), INF, np.float32)
    in_pdf = np.zeros((S, K), np.int32)
    # arcs grouped by destination, arc order kept; the slot of an arc is
    # its rank within its destination's run
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    slot = np.arange(len(d)) - (np.cumsum(counts) - counts)[d]
    in_src[d, slot] = np.asarray(src)[order]
    in_w[d, slot] = np.asarray(weight)[order]
    in_pdf[d, slot] = np.asarray(pdf)[order]
    return in_src, in_w, in_pdf, K


def live_counts(in_src: np.ndarray, in_w: np.ndarray,
                in_pdf: Optional[np.ndarray] = None) -> np.ndarray:
    """Live slots of each state of a padded table, (S,) or (B, S) int32:
    the length of the leading run of slots that are not the dead triple
    (src = S, w = INF, pdf = 0; an epsilon table has no pdf).  Raises when
    a live slot follows a dead one: the kernel walks `in_deg` slots and
    takes the dead triple for all the others.  Called once where the
    tables are made."""
    S, K = in_src.shape[-2:]
    live = (in_src != S) | (in_w != INF)
    if in_pdf is not None:
        live |= in_pdf != 0
    total = live.sum(-1)
    lead = np.where(live.all(-1), K, live.argmin(-1))
    if (lead != total).any():
        bad = np.argwhere(lead != total)[0]
        raise ValueError(f"the table has a live slot after a dead one at "
                         f"{tuple(int(i) for i in bad)}")
    return total.astype(np.int32)


# Slack of the bound D = fl(INF + INF) on every cost (closure_is_identity):
# fl(D + x) = D for 0 <= x <= 2 * DEAD_SLACK, far inside half a unit in the
# last place of D (7.5e22)
DEAD_SLACK = 1e22


def closure_is_identity(ne_in_src: np.ndarray, ne_in_w: np.ndarray,
                        ne_deg: np.ndarray, e_in_src: np.ndarray,
                        e_in_w: np.ndarray, e_deg: np.ndarray) -> bool:
    """True when a closure step over this epsilon table cannot change any
    cost row that emitting steps over this emitting table produce from
    loglikes with scale * ll >= -DEAD_SLACK everywhere.  The `*_deg` are
    the tables' `live_counts`.

    Two kinds of slot can meet a state s in a closure step:
      * a filled slot.  If it is a self-arc (src = s) of weight w >= 0, its
        candidate fl(cost[s] + w) >= cost[s], because rounding is monotone:
        it never wins.  Any other filled slot may win, so: not the identity.
        (A weight of INF alone proves nothing: an INF arc from a reachable
        state into an unreachable one lowers 2e30 to 1e30.)
      * a dead slot, whose candidate is D = fl(cost[S] + INF) = fl(INF +
        INF): the caller keeps the dead column at INF, and both kinds of
        step write it back so.  It never wins while cost[s] <= D.
    So every state with a dead epsilon slot needs cost[s] <= D in every
    row.  A start row holds 0 and INF.  After an emitting step:
      * a state with a dead emitting slot is at most that slot's candidate,
        fl(D - scale * ll[b, 0]) <= D under the condition on the loglikes;
      * a state whose K slots are all live is bounded if one of them has a
        weight <= DEAD_SLACK and comes from the dead column or from a state
        of the first kind: fl(fl(c + w) - scale * ll) <= D for c <= D.
        Without such a slot it may pass D (the pad arcs of
        `DeviceGraph.padded`, weight INF from the last state to itself,
        add INF a frame), and then a dead epsilon slot would lower it."""
    S, KN = ne_in_src.shape[-2:]
    KE = e_in_src.shape[-1]
    filled = np.arange(KN) < ne_deg[..., None]
    own = np.arange(S, dtype=ne_in_src.dtype)[:, None]
    never_wins = (ne_in_src == own) & (ne_in_w >= 0)
    if (filled & ~never_wins).any():
        return False
    has_dead = e_deg < KE
    if not ((ne_deg < KN) & ~has_dead).any():
        return True
    at_most_d = np.concatenate(
        [has_dead, np.ones(has_dead.shape[:-1] + (1,), bool)], -1)
    src_ok = np.take_along_axis(
        at_most_d, e_in_src.reshape(e_in_src.shape[:-2] + (-1,)).astype(
            np.int64), -1).reshape(e_in_src.shape)
    e_filled = np.arange(KE) < e_deg[..., None]
    bounded = has_dead | (e_filled & src_ok
                          & (e_in_w <= DEAD_SLACK)).any(-1)
    return not ((ne_deg < KN) & ~bounded).any()


def _gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, C), idx (S, K) or (B, S, K) -> x[b, idx[(b,) s, k]]."""
    B = x.shape[0]
    if idx.dim() == 2:
        flat = x.index_select(1, idx.reshape(-1).long())
    else:
        flat = torch.gather(x, 1, idx.reshape(B, -1).long())
    return flat.reshape(B, *idx.shape[-2:])


def _finish(new: torch.Tensor, dead: Optional[torch.Tensor],
            out: Optional[torch.Tensor], S: int) -> torch.Tensor:
    if out is None:
        return new
    out[:, :S] = new
    if out.shape[1] == S + 1:
        out[:, S] = INF.item() if dead is None else dead
    return out[:, :S]


def relax_padded(cost, in_src, in_w, in_pdf=None, loglikes_t=None,
                 acoustic_scale: float = 1.0,
                 out: Optional[torch.Tensor] = None,
                 in_deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, on any device: gathers, adds and `amin` over
    all K slots.  `in_deg` is accepted and ignored: the result does not
    depend on it."""
    S = in_src.shape[-2]
    shared = in_src.dim() == 2
    prev = _gather_cols(cost, in_src)                       # (B, S, K)
    cand = prev + (in_w[None] if shared else in_w)
    if in_pdf is None:
        new = torch.minimum(cost[:, :S], torch.amin(cand, dim=-1))
        return _finish(new, cost[:, S].clone(), out, S)
    ac = _gather_cols(loglikes_t, in_pdf)                   # (B, S, K)
    cand = cand - acoustic_scale * ac
    return _finish(torch.amin(cand, dim=-1), None, out, S)


def _extent(t: torch.Tensor) -> Tuple[int, int]:
    """Addresses of the first and the last byte that t touches."""
    first = t.data_ptr()
    span = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return first, first + span * t.element_size() + t.element_size() - 1


def _check(name: str, t: torch.Tensor, shape, dtype, device,
           contiguous: bool) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib: ctypes.CDLL):
    """-> (the launch, the question which instantiation it would take)."""
    fns = lib.viterbi_relax, lib.viterbi_relax_lanes_a_thread
    for fn in fns:
        if fn.argtypes is None:
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            fn.argtypes = [p, ll, ll, p, p, p, p, p, i, i, ll, p, ll, ll,
                           ctypes.c_float, p, ll, ll, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
    return fns


class PreparedRelax:
    """The tables of one relaxation, checked once, to be launched many
    times: `plan(cost, loglikes_t, out=...)` for an emitting step,
    `plan(cost, out=...)` for a closure step (`in_pdf=None`).  A call
    checks only what can change between frames: shapes, types, devices and
    that `out` does not overlap `cost`.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise).

    in_deg: the tables' live counts (`live_counts`), (S,) or (B, S) int32.
    With it the kernel walks each state's live slots and one dead slot;
    without it all K slots (the first version).  The results are equal bit
    for bit.  Like the table indices, the counts are not checked here.
    For shared tables the states with a walk longer than LONG_WALK are
    listed here, once (a device-to-host synchronisation).  All tensors of
    a call lie on the tables' device."""

    def __init__(self, in_src, in_w, in_pdf=None,
                 acoustic_scale: float = 1.0, in_deg=None):
        if in_src.dim() not in (2, 3) or in_src.shape[-1] < 1:
            raise ValueError("in_src must be (S, K) or (B, S, K), K >= 1")
        self.tables = (in_src, in_w, in_pdf, in_deg)
        self.scale = float(acoustic_scale)
        self.closure = in_pdf is None
        self.dev = dev = in_src.device
        self.S, self.K = in_src.shape[-2:]
        self.lanes = None if in_src.dim() == 2 else in_src.shape[0]
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        tshape = tuple(in_src.shape)
        _check("in_src", in_src, tshape, torch.int32, dev, True)
        _check("in_w", in_w, tshape, torch.float32, dev, True)
        if not self.closure:
            _check("in_pdf", in_pdf, tshape, torch.int32, dev, True)
        if in_deg is not None:
            _check("in_deg", in_deg, tshape[:-1], torch.int32, dev, True)
        self._fn, self._lanes_fn = _bind(_build.load("viterbi_relax"))
        self._long = None
        if in_deg is not None and self.lanes is None:
            walk = in_deg + (in_deg < self.K)
            self._long = torch.nonzero(walk > LONG_WALK).flatten().to(
                torch.int32)
        n_long = 0 if self._long is None else self._long.numel()
        self._table_args = (
            in_src.data_ptr(), in_w.data_ptr(),
            (in_src if self.closure else in_pdf).data_ptr(),
            None if in_deg is None else in_deg.data_ptr(),
            self._long.data_ptr() if n_long else None, n_long, LONG_WALK,
            0 if self.lanes is None else self.S * self.K)

    def _check_rows(self, cost, ll, out) -> None:
        """The full checks of one call's tensors, with their messages."""
        dev, S = self.dev, self.S
        if self.closure != (ll is None):
            raise ValueError("in_pdf and loglikes_t go together: both for "
                             "an emitting step, neither for a closure step")
        if cost.dim() != 2:
            raise ValueError("cost must be (B, S+1)")
        B = cost.shape[0] if self.lanes is None else self.lanes
        _check("cost", cost, (B, S + 1), torch.float32, dev, False)
        if ll is not None:
            if ll.dim() != 2:
                raise ValueError("loglikes_t must be (B, P)")
            _check("loglikes_t", ll, (B, ll.shape[1]), torch.float32, dev,
                   False)
        if out.dim() != 2 or out.shape[1] not in (S, S + 1):
            raise ValueError(f"out must be (B, S) or (B, S+1), got "
                             f"{tuple(out.shape)}")
        _check("out", out, (B, out.shape[1]), torch.float32, dev, False)

    def _args(self, cost, ll, out) -> tuple:
        """The C interface's arguments but for the stream, every tensor
        checked."""
        dev, S = self.dev, self.S
        f32 = torch.float32
        ok = (cost.dim() == 2 and cost.shape[1] == S + 1
              and cost.dtype is f32 and cost.device == dev
              and out.dim() == 2 and out.shape[0] == cost.shape[0]
              and (out.shape[1] == S or out.shape[1] == S + 1)
              and out.dtype is f32 and out.device == dev
              and (self.lanes is None or cost.shape[0] == self.lanes)
              and ((ll is None) if self.closure else
                   (ll is not None and ll.dim() == 2
                    and ll.shape[0] == cost.shape[0] and ll.dtype is f32
                    and ll.device == dev)))
        if not ok:
            self._check_rows(cost, ll, out)         # raises, and says why
            raise ValueError("unsupported arguments")
        o_first, o_last = _extent(out)
        c_first, c_last = _extent(cost)
        if o_first <= c_last and c_first <= o_last:
            raise ValueError("out must not overlap cost (a relaxation reads "
                             "other states' old costs while it writes)")
        if ll is None:
            ll = cost                               # closure: never read
        return (cost.data_ptr(), cost.stride(0), cost.stride(1),
                *self._table_args, ll.data_ptr(), ll.stride(0), ll.stride(1),
                self.scale, out.data_ptr(), out.stride(0), out.stride(1),
                cost.shape[0], S, self.K, out.shape[1], int(self.closure))

    def lanes_a_thread(self, cost: torch.Tensor,
                       loglikes_t: Optional[torch.Tensor],
                       out: torch.Tensor) -> int:
        """Which instantiation of the kernel a call with these CUDA
        tensors launches, as the lanes a thread takes: 0 the first version
        (no `in_deg`), 1 or 4 the live walk (4 needs shared tables, lanes
        in multiples of 4 with stride 1 and rows aligned to 16 bytes, as
        the batched decoder keeps them).  Launches nothing."""
        if self.dev.type != "cuda":
            raise ValueError("the tables are not on a CUDA device")
        return self._lanes_fn(*self._args(cost, loglikes_t, out), None)

    def __call__(self, cost: torch.Tensor,
                 loglikes_t: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev, S = self.dev, self.S
        if cost.device != dev:
            raise ValueError(f"cost is on {cost.device}, the tables on {dev}")
        if dev.type == "cpu":
            in_src, in_w, in_pdf, _ = self.tables
            return relax_padded(cost, in_src, in_w, in_pdf, loglikes_t,
                                self.scale, out)
        if out is None and cost.dim() == 2:
            out = torch.empty((cost.shape[0], S), dtype=torch.float32,
                              device=dev)
        args = self._args(cost, loglikes_t, out)
        if torch.cuda.current_device() == dev.index:
            rc = self._fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        else:
            with torch.cuda.device(dev):
                rc = self._fn(*args,
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"viterbi_relax kernel launch failed: CUDA "
                               f"error {rc}")
        global launches
        launches += 1
        return out[:, :S]


def viterbi_relax(cost, in_src, in_w, in_pdf=None, loglikes_t=None,
                  acoustic_scale: float = 1.0,
                  out: Optional[torch.Tensor] = None,
                  in_deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One relaxation, every argument checked.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise): with `in_deg`
    (`live_counts` of the tables) the walk over live slots, without it the
    first version over all K slots; the results are equal bit for bit.
    Table indices and counts are not checked here: whoever builds the
    tables checks them once (`check_tables`, `live_counts`).  With `in_deg`
    over shared tables a call waits for the device once (`PreparedRelax`
    lists the long walks on the host).  A loop over frames prepares once
    instead (`PreparedRelax`, or `each_call` for any other function of
    these arguments)."""
    if cost.device.type == "cpu":
        return relax_padded(cost, in_src, in_w, in_pdf, loglikes_t,
                            acoustic_scale, out)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    if cost.dim() != 2 or in_src.dim() not in (2, 3):
        raise ValueError("cost must be (B, S+1) and in_src (S, K) or "
                         "(B, S, K)")
    if (in_pdf is None) != (loglikes_t is None):
        raise ValueError("in_pdf and loglikes_t go together: both for an "
                         "emitting step, neither for a closure step")
    if in_src.device != cost.device:
        raise ValueError(f"in_src is on {in_src.device}, cost on "
                         f"{cost.device}")
    return PreparedRelax(in_src, in_w, in_pdf, acoustic_scale, in_deg)(
        cost, loglikes_t, out)


def each_call(relax):
    """A relaxation function with `viterbi_relax`'s arguments in the form
    of `PreparedRelax`: `each_call(relax)(tables...)` gives the callable
    of one table set, and each of its calls passes the tables to `relax`
    again (which then checks them again)."""
    def prepare(in_src, in_w, in_pdf=None, acoustic_scale: float = 1.0,
                in_deg=None):
        if in_pdf is None:
            return lambda cost, out=None: relax(cost, in_src, in_w, out=out,
                                                in_deg=in_deg)
        return lambda cost, loglikes_t, out=None: relax(
            cost, in_src, in_w, in_pdf, loglikes_t, acoustic_scale, out=out,
            in_deg=in_deg)
    return prepare


def check_tables(in_src: np.ndarray, in_pdf: Optional[np.ndarray],
                 num_pdfs: Optional[int]) -> None:
    """Raise unless every source index is a state or the dead state and
    every pdf index is a column of the loglikes.  Called once where the
    tables are made, so that no launch has to look."""
    S = in_src.shape[-2]
    if in_src.size and (in_src.min() < 0 or in_src.max() > S):
        raise ValueError(f"in_src outside [0, {S}]")
    if in_pdf is not None and in_pdf.size and (
            in_pdf.min() < 0 or in_pdf.max() >= num_pdfs):
        raise ValueError(f"in_pdf outside [0, {num_pdfs})")
