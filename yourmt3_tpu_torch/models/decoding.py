"""Autoregressive greedy and beam decode.

The token loop is a Python loop over positions: each step runs
`YMT3.decode_step` for every stream, chooses the next tokens and updates
the loop's state in place (decoder inputs, done flags, self caches and,
in a beam search, scores). The host reads the "all done" flag once every
`unroll` steps; finished streams emit PAD, so the extra steps leave the
tokens unchanged. Channels are folded into the batch by the caller's
model, so one loop serves single- and multi-channel decoders.

With the memory on a CUDA device and dense self caches, a decode call
runs the steps that take host branches eagerly (the forced prefix, the
beam's first step), then captures one step as a CUDA graph on the loop's
state, with the position in a 0-dim device tensor that the graph advances
itself, and replays it at every later position: the host launches one
graph a step instead of each of the step's kernels. The graph and its
memory pool live for the one call (`greedy_decode` captures once per
phase). Paged self caches (their kernels take the position as a host
scalar), the CPU and a decode inside another capture run every step
eagerly, through the same step function. `greedy_decode_early_exit` runs
the eager step in chunks and drops finished streams from the batch
between chunks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..tokens.codec import EOS_ID, PAD_ID
from ..utils import profiling
from .ymt3 import YMT3


class _GreedyState:
    """The loop state of a greedy decode: decoder inputs (S, L+1), the
    done flags, the self caches, the repetition-guard run lengths and the
    lockstep position (a host int)."""

    def __init__(self, model: YMT3, streams: int, max_length: int, dev):
        self.buf = torch.full((streams, max_length + 1), PAD_ID,
                              dtype=torch.long, device=dev)
        self.buf[:, 0] = model.cfg.decoder_start_token_id
        self.done = torch.zeros(streams, dtype=torch.bool, device=dev)
        self.self_kvs = model.empty_self_kvs(streams, max_length, dev)
        self.rep = torch.zeros(streams, dtype=torch.long, device=dev)
        self.rep2 = torch.zeros(streams, dtype=torch.long, device=dev)
        self.pos = 0


def _column(buf: torch.Tensor, pos) -> torch.Tensor:
    """buf[..., pos:pos + 1]; pos a host int or a 0-dim device tensor."""
    if isinstance(pos, torch.Tensor):
        return buf.index_select(buf.ndim - 1, pos.view(1))
    return buf[..., pos:pos + 1]


def _put_column(buf: torch.Tensor, pos, values: torch.Tensor) -> None:
    """buf[..., pos] = values; pos as in `_column`."""
    if isinstance(pos, torch.Tensor):
        buf.index_copy_(buf.ndim - 1, pos.view(1), values[..., None])
    else:
        buf[..., pos] = values


def _decode(model: YMT3, tok: torch.Tensor, pos, self_kvs, cross_kvs,
            kv_len: int = 0) -> torch.Tensor:
    """model.decode_step's logits. An eager step's model call is the span
    `decode.step`; a graphed step's span is around its replay."""
    if isinstance(pos, torch.Tensor):
        return model.decode_step(tok, pos, self_kvs, cross_kvs, kv_len=kv_len)[0]
    with profiling.span("decode.step"):
        return model.decode_step(tok, pos, self_kvs, cross_kvs, kv_len=kv_len)[0]


def _graphable(memory: torch.Tensor, self_kvs) -> bool:
    """Whether a decode loop replays its step as a CUDA graph: the memory
    is on a CUDA device, the self caches are dense and no capture is
    running already."""
    cache = self_kvs[0][0]
    if isinstance(cache, tuple):
        cache = cache[0]
    return (memory.is_cuda and cache.ndim == 4
            and not torch.cuda.is_current_stream_capturing())


class _Stepper:
    """Runs a decode loop's `step(pos)` at each host position: eagerly
    below `eager_until` (where the step takes host branches) or when
    `graphed` is False; from there on by replaying one CUDA graph of it,
    captured at the first such position on the loop's static state, with
    the position in a 0-dim int64 tensor on `device` that the graph
    advances. A replay adds the kernel launches its capture recorded to
    the launch counters, which the kernels' wrappers advance only when
    Python calls them. Used as a context manager around the loop: on exit
    it frees the graph and clears cuBLAS's workspaces, since the capture
    stream's workspace lies in the graph's memory pool and would otherwise
    stay allocated after the call."""

    captures = 0  # graph captures and replays since the last reset
    replays = 0

    def __init__(self, step: Callable, graphed: bool, eager_until: int,
                 device: torch.device):
        self.step, self.graphed, self.eager_until = step, graphed, eager_until
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pos: Optional[torch.Tensor] = None  # the graph reads it: keep it
        self.launches: Dict[str, int] = {}

    def __enter__(self) -> "_Stepper":
        return self

    def __exit__(self, *exc) -> bool:
        if self.graph is not None:
            torch.cuda.current_stream(self.device).synchronize()  # last replay
            self.graph = self.pos = None
            torch._C._cuda_clearCublasWorkspaces()
        return False

    def __call__(self, pos: int) -> None:
        if not self.graphed or pos < self.eager_until:
            self.step(pos)
            return
        if self.graph is None:
            with profiling.span("decode.capture"):
                self._capture(pos)
        with profiling.span("decode.step"):
            self.graph.replay()
        profiling.add_launches(self.launches)
        _Stepper.replays += 1

    def _capture(self, pos: int) -> None:
        self.pos = torch.full((), pos, dtype=torch.long, device=self.device)
        before = profiling.launches()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            self.step(self.pos)
            self.pos.add_(1)
        after = profiling.launches()
        self.launches = {n: c - before.get(n, 0) for n, c in after.items()
                         if c != before.get(n, 0)}
        profiling.add_launches({n: -c for n, c in self.launches.items()})
        _Stepper.captures += 1


profiling.register("decode.graph_captures", lambda: _Stepper.captures)
profiling.register("decode.graph_replays", lambda: _Stepper.replays)


def _greedy_step(model: YMT3, st: _GreedyState, pos, cross_kvs,
                 prefix: List[int], eos_id: int, kv_len: int, ban_eos: bool,
                 repetition_guard: int) -> None:
    """One greedy step on `st` in place: the next token of every stream
    into `st.buf` at pos + 1, the done flags and the repetition guard's
    run lengths. pos: a host int, or the device position of a captured
    step, which lies past the forced prefix and position 0."""
    host = not isinstance(pos, torch.Tensor)
    buf, done = st.buf, st.done
    tok = _column(buf, pos)
    logits = _decode(model, tok, pos, st.self_kvs, cross_kvs, kv_len)
    if ban_eos:
        logits[:, eos_id] = -1e9
    nxt = torch.argmax(logits, dim=-1)
    forced = host and pos < len(prefix)
    if forced:
        nxt = torch.full_like(nxt, prefix[pos])
    if repetition_guard > 0:
        if forced:
            st.rep.zero_()
            st.rep2.zero_()
        else:
            live = ~done
            st.rep.copy_(torch.where(live & (nxt == tok[:, 0]), st.rep + 1, 1))
            if host and pos < 1:
                in_cycle = torch.zeros_like(live)
            else:
                in_cycle = live & (nxt == _column(buf, pos - 1)[:, 0])
            st.rep2.copy_(torch.where(in_cycle, st.rep2 + 1, 1))
            trip = (st.rep >= repetition_guard) | (
                st.rep2 >= 2 * repetition_guard)
            nxt = torch.where(trip & live, eos_id, nxt)
    nxt = torch.where(done, PAD_ID, nxt)
    done |= nxt == eos_id
    _put_column(buf, pos + 1, nxt)


def _greedy_steps(model: YMT3, st: _GreedyState, limit: int, cross_kvs,
                  prefix: List[int], eos_id: int, kv_len: int = 0,
                  unroll: int = 1, ban_eos: bool = False,
                  repetition_guard: int = 0, graphed: bool = False) -> None:
    """Run greedy steps on `st` in place until `limit` or until every
    stream is done, reading "all done" on the host every `unroll` steps.
    graphed: replay one capture of the step past the forced prefix and
    position 0 (`_Stepper`)."""
    def step(pos):
        _greedy_step(model, st, pos, cross_kvs, prefix, eos_id, kv_len,
                     ban_eos, repetition_guard)

    with _Stepper(step, graphed, max(len(prefix), 1), st.buf.device) as run, \
            profiling.span("decode.greedy"):
        while st.pos < limit:
            with profiling.span("decode.done_read"):
                finished = bool(st.done.all())
            if finished:
                break
            for _ in range(unroll):
                run(st.pos)
                st.pos += 1
                greedy_decode.steps += 1


def greedy_decode(
    model: YMT3,
    memory: torch.Tensor,  # (B, C, T, D) from model.encode
    max_length: int,
    prefix_ids: Optional[Sequence[int]] = None,  # forced task-token prefix
    eos_id: int = EOS_ID,
    ban_eos: bool = False,  # benchmarking: force a full-length decode
    unroll: int = 1,  # steps between two host reads of "all done"
    phases: int = 1,  # phase p reads only cache[:, :, :(p+1)·L/phases]
    # on the dense self-attention paths (tokens unchanged)
    cross_kvs=None,  # precomputed model.init_cross_kv(memory)
    repetition_guard: int = 0,  # >0: the Nth consecutive identical token
    # (or the 2Nth step of a period-2 cycle) becomes a forced EOS
) -> torch.Tensor:
    """→ (B, C, max_length) int64 token ids (PAD-filled after EOS)."""
    B, C = memory.shape[0], memory.shape[1]
    if max_length % unroll or max_length % phases:
        raise ValueError(f"unroll={unroll} and phases={phases} must divide "
                         f"max_length={max_length}")
    if (max_length // phases) % unroll:
        raise ValueError("each phase must step in whole unroll groups")
    if repetition_guard == 1 or repetition_guard < 0:
        raise ValueError(f"repetition_guard must be 0 (off) or >= 2, got "
                         f"{repetition_guard}")

    if cross_kvs is None:
        cross_kvs = model.init_cross_kv(memory)
    st = _GreedyState(model, B * C, max_length, memory.device)
    prefix = list(prefix_ids or [])
    graphed = _graphable(memory, st.self_kvs)
    span = max_length // phases
    for p in range(phases):
        limit = (p + 1) * span
        _greedy_steps(model, st, limit, cross_kvs, prefix, eos_id,
                      kv_len=0 if limit == max_length else limit,
                      unroll=unroll, ban_eos=ban_eos,
                      repetition_guard=repetition_guard, graphed=graphed)
    return st.buf[:, 1:].reshape(B, C, max_length)


greedy_decode.steps = 0  # greedy steps run since the last reset (both
# greedy decoders)
profiling.register("decode.greedy_steps", lambda f=greedy_decode: f.steps)


def greedy_decode_early_exit(
    model: YMT3,
    memory: torch.Tensor,  # (B, C, T, D)
    max_length: int,
    prefix_ids: Optional[Sequence[int]] = None,
    eos_id: int = EOS_ID,
    chunk: int = 64,
    compact_threshold: float = 0.5,
    cross_kvs=None,  # precomputed model.init_cross_kv(memory); callers
    # comparing decodes pass the same tensors to each
) -> torch.Tensor:
    """Greedy decode that retires finished streams: it decodes in
    `chunk`-step runs of greedy_decode's step and, between runs, reads the
    done flags on the host. When the active streams, padded to a
    power-of-two multiple of 8, fit in `compact_threshold` of the current
    rows, finished rows go to a host buffer and the active rows (padded by
    repeating row 0 with done=True) are gathered in the decoder inputs,
    the self caches and the cross K/V. Tokens equal greedy_decode's.
    → (B, C, max_length) int64 token ids on memory's device."""
    B, C = memory.shape[0], memory.shape[1]
    S = B * C
    dev = memory.device
    if cross_kvs is None:
        cross_kvs = model.init_cross_kv(memory)
    st = _GreedyState(model, S, max_length, dev)
    prefix = list(prefix_ids or [])
    out = np.full((S, max_length + 1), PAD_ID, np.int64)
    order = np.arange(S)  # current row → original stream row

    while True:
        _greedy_steps(model, st, min(st.pos + chunk, max_length), cross_kvs,
                      prefix, eos_id)
        with profiling.span("decode.done_read"):
            done_h = st.done.cpu().numpy()[: len(order)]
        if st.pos >= max_length or done_h.all():
            break
        n_active = int((~done_h).sum())
        padded = 8
        while padded < n_active:
            padded *= 2
        if padded <= compact_threshold * len(done_h):
            fin = np.nonzero(done_h)[0]
            out[order[fin]] = st.buf[torch.from_numpy(fin).to(dev)].cpu().numpy()
            act = np.nonzero(~done_h)[0]
            idx = torch.from_numpy(np.concatenate(
                [act, np.zeros(padded - n_active, np.int64)])).to(dev)
            st.buf = st.buf.index_select(0, idx)
            st.done = torch.arange(padded, device=dev) >= n_active
            st.self_kvs = reorder_cache_streams(st.self_kvs, idx)
            cross_kvs = reorder_cache_streams(cross_kvs, idx)
            order = order[act]
            greedy_decode_early_exit.compactions += 1

    out[order] = st.buf[: len(order)].cpu().numpy()
    return torch.from_numpy(out[:, 1:]).reshape(B, C, max_length).to(dev)


greedy_decode_early_exit.compactions = 0  # compactions since the last reset
profiling.register("decode.early_exit_compactions",
                   lambda f=greedy_decode_early_exit: f.compactions)


def reorder_cache_streams(kvs, parent: torch.Tensor):
    """Gather streams in every cache tensor (beam parents, or the active
    rows of a compaction). `parent` is a flat index into the stream axis:
    axis 1 for paged (5-D) tensors, axis 0 for everything else."""
    if isinstance(kvs, (list, tuple)):
        return type(kvs)(reorder_cache_streams(x, parent) for x in kvs)
    return torch.index_select(kvs, 1 if kvs.ndim == 5 else 0, parent)


def _reorder_cache_streams_(kvs, parent: torch.Tensor) -> None:
    """`reorder_cache_streams` in place, one tensor at a time: the caches
    keep their storage (a graphed step's static state) and the temporary
    is one tensor, not a copy of every cache."""
    if isinstance(kvs, (list, tuple)):
        for x in kvs:
            _reorder_cache_streams_(x, parent)
    else:
        kvs.copy_(reorder_cache_streams(kvs, parent))


def beam_decode(
    model: YMT3,
    memory: torch.Tensor,  # (B, C, T, D)
    max_length: int,
    beam_size: int = 4,
    prefix_ids: Optional[Sequence[int]] = None,
    eos_id: int = EOS_ID,
    length_penalty: float = 0.6,
) -> torch.Tensor:
    """Batched beam search; beams fold into the stream axis (S·K) so the
    same decode_step and caches serve. → (B, C, max_length) best beams."""
    B, C = memory.shape[0], memory.shape[1]
    S = B * C
    K = beam_size
    V = model.cfg.vocab_size
    dev = memory.device
    prefix = list(prefix_ids or [])
    P = len(prefix)

    # expand memory per beam before the cross-KV projection: stream-major
    # (S·K) ordering, B·C major and K minor, as the caches fold
    mem_flat = memory.reshape(S, *memory.shape[2:])
    mem_beam = torch.repeat_interleave(mem_flat, K, dim=0)  # (S·K, T, D)
    with profiling.span("cross_kv"):
        cross_kvs = model.init_cross_kv(mem_beam[:, None])
    self_kvs = model.empty_self_kvs(S * K, max_length, dev)

    NEG = -1e9
    buf = torch.full((S, K, max_length + 1), PAD_ID, dtype=torch.long,
                     device=dev)
    buf[:, :, 0] = model.cfg.decoder_start_token_id
    scores = torch.zeros((S, K), dtype=torch.float32, device=dev)
    done = torch.zeros((S, K), dtype=torch.bool, device=dev)
    pad_only = torch.full((V,), NEG, device=dev)
    pad_only[PAD_ID] = 0.0
    first_mask = (torch.arange(K, device=dev) > 0).to(torch.float32)[None, :, None] * NEG
    base = (torch.arange(S, device=dev) * K)[:, None]

    def step(pos):
        host = not isinstance(pos, torch.Tensor)
        tok = _column(buf, pos).reshape(S * K, 1)
        logits = _decode(model, tok, pos, self_kvs, cross_kvs)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(S, K, V)
        if host and pos < P:
            forced = torch.full((V,), NEG, device=dev)
            forced[prefix[pos]] = 0.0
            logp = forced.expand(S, K, V)
        # finished beams: only PAD continues, score frozen
        logp = torch.where(done[:, :, None], pad_only[None, None], logp)
        if host and pos == 0:  # only beam 0 is alive (identical beams would tie)
            logp = logp + first_mask
        cand = scores[:, :, None] + logp  # (S, K, V)
        top_v, top_i = torch.topk(cand.reshape(S, K * V), K, dim=-1)
        parent = top_i // V
        token = top_i % V
        _reorder_cache_streams_(self_kvs, (base + parent).reshape(-1))
        buf.copy_(torch.gather(buf, 1, parent[:, :, None].expand(-1, -1, buf.shape[2])))
        _put_column(buf, pos + 1, token)
        done.copy_(torch.gather(done, 1, parent) | (token == eos_id))
        scores.copy_(top_v)

    pos = 0
    with _Stepper(step, _graphable(memory, self_kvs), max(P, 1), dev) as run, \
            profiling.span("decode.beam"):
        while pos < max_length:
            with profiling.span("decode.done_read"):
                finished = bool(done.all())
            if finished:
                break
            run(pos)
            pos += 1
            beam_decode.steps += 1

    # best beam with the GNMT length penalty
    lengths = torch.sum(buf[:, :, 1:] != PAD_ID, dim=-1).to(torch.float32)
    denom = ((5.0 + torch.clamp(lengths, min=1.0)) / 6.0) ** length_penalty
    best = torch.argmax(scores / denom, dim=1)  # (S,)
    out = buf[torch.arange(S, device=dev), best, 1:]
    return out.reshape(B, C, max_length)


beam_decode.steps = 0  # decode steps run since the last reset
profiling.register("decode.beam_steps", lambda f=beam_decode: f.steps)
