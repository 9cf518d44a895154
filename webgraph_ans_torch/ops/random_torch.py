"""Batch random access on the device: the successor lists of arbitrary
query nodes. The port of webgraph_ans_tpu/ops/random_tpu.py.

The reference resolves references recursively, one decoder per node
(reference: src/bvgraph/factories/bvgraph_decoder_factory.rs:46-58 plus the
webgraph BvGraph recursion). Three batched forms:

- TorchRandomAccess: wave decoding from the compressed artifact. Wave 0
  decodes one lane per entry segment holding a query (decode_blocks in
  token mode); wave k+1 the segments that the queries' reference chains
  reach and that are not decoded yet. One reconstruction over the
  queries' reference closure follows, then the query rows in query
  order. Given the per-node phases on the card, a wave of one-node
  segments replays one CUDA graph (lane inputs, ring seeds, the kernel).
- TorchCsrServer: the whole graph decoded once to a device CSR by the sort
  path (decode_to_csr_device); every batch is then two ragged gathers on
  the device.
- TorchEmitRandomAccess: one merged-emit lane per unique query, covering
  the query and its 4 * window halo, whose marker row gives the query's
  final sorted list (decode_emit with real_starts = q); past the batch
  size where that re-decodes more than the whole graph, a full merged-emit
  decode and a device gather. Lanes that run past the cap run again alone
  at twice the cap; lists the kernel cannot resolve in their lane go to
  the wave decode. Its successors_batch_device is the device-resident
  serving contract: device queries in, (outv, offs, total) on the device
  out, from a full merged-emit decode of the artifact each batch.

Entry points run on the decoder's device (CUDA unless the decoder was made
with device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvgraph.graph import Adjacency
from ..utils import trace
from .decode_cuda import decode_blocks
from .decode_torch import UNROLL, _comp_table, round_cap, seed_rings
from .emit_cuda import decode_emit
from .emit_post import _expand_spans
from .emit_torch import MAX_WINDOW, emit_init_regs
from .graph_decode import TorchGraphDecoder, _all_done, _grow_cap
from .reconstruct_device import _cumsum, _excl, _fill_forward, _quant
from .reconstruct_torch import _np_ragged, reconstruct

I32 = torch.int32
MAX_WAVES = 64


def _ragged_adjacency(pool: np.ndarray, ubase: np.ndarray,
                      ulen: np.ndarray, inv: np.ndarray) -> Adjacency:
    """The lists pool[ubase[u]:ubase[u] + ulen[u]] of each query's unique
    id u = inv[i], in query order, as one vectorised ragged gather."""
    qlens = ulen[inv]
    out_off = np.zeros(len(inv) + 1, np.int64)
    np.cumsum(qlens, out=out_off[1:])
    src = (np.repeat(ubase[inv] - out_off[:-1], qlens)
           + np.arange(int(out_off[-1]), dtype=np.int64))
    return Adjacency(out_off.astype(np.uint64), pool[src])


def _host_queries(query_nodes) -> np.ndarray:
    """Query nodes as a host int64 array: a torch tensor (on any device)
    is copied to the host once, anything else goes through np.asarray."""
    if isinstance(query_nodes, torch.Tensor):
        return trace.fetch(query_nodes).astype(np.int64)
    return np.asarray(query_nodes, dtype=np.int64)


def _device_queries(query_nodes, device: torch.device) -> torch.Tensor:
    """Query nodes as an int32 tensor on `device`: a tensor is cast there
    with no host round trip, a host array is uploaded once."""
    if isinstance(query_nodes, torch.Tensor):
        return query_nodes.to(device=device, dtype=I32)
    return trace.upload(np.asarray(query_nodes, np.int64).astype(np.int32),
                        device)


def _unpack_tokens(out_t: np.ndarray, cap: int):
    """(vals [L, cap] u32, comps [L, cap] u8) of decode_blocks' token-mode
    output, lane-major: out_t [L, cap + cap // UNROLL] u32, each lane's
    value rows, then its packed component nibbles (step s at bits
    4 * (s % UNROLL) of nibble row s // UNROLL: byte j of a lane's
    little-endian rows holds steps 2j and 2j + 1)."""
    nib = np.ascontiguousarray(out_t[:, cap:], dtype="<u4").view(np.uint8)
    comps = np.empty((len(out_t), cap), np.uint8)
    np.bitwise_and(nib, 0xF, out=comps[:, 0::2])
    np.right_shift(nib, 4, out=comps[:, 1::2])
    return out_t[:, :cap], comps


class TorchRandomAccess:
    """On-demand batch random access: the queried lists are decoded from
    the compressed artifact for each batch. The unit of decode is the
    entry segment, the nodes between two consecutive valid entry points
    (one node at phase_step 1, more on phase-sampled artifacts), so a
    query decodes forward from its preceding entry, as the native
    skip-decoder does."""

    # a wave of at most this many lanes is padded to it with empty lanes,
    # so that one CUDA graph a cap serves it
    WAVE_LANES = 512

    def __init__(self, decoder: TorchGraphDecoder, phases=None):
        self.dec = decoder
        self._entry_nodes = decoder._entries()[0]     # ascending, [0] == 0
        # (entry states int64 [n], entry pointers int64 [n], codec table)
        # on the decoder's device, at per-node phases: with them a wave of
        # up to WAVE_LANES one-node segments on CUDA gathers its lanes on
        # the device and replays one CUDA graph (_decode_captured)
        self._phases = phases
        self._graphs: dict = {}

    def _seg_of(self, nodes: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._entry_nodes, nodes, side="right") - 1

    def _seg_bounds(self, segs: np.ndarray):
        e = self._entry_nodes
        starts = e[segs]
        ends = np.where(segs + 1 < len(e), e[np.minimum(segs + 1, len(e) - 1)],
                        self.dec.num_nodes)
        return starts.astype(np.int64), ends.astype(np.int64)

    def _segment_inputs(self, segs: np.ndarray):
        """decode_blocks' lane inputs for the given entry segments, one
        lane each: (states, ptrs, starts, ends, ring seeds) on the
        device."""
        return self._range_inputs(*self._seg_bounds(segs))

    def _range_inputs(self, starts: np.ndarray, ends: np.ndarray):
        """decode_blocks' lane inputs for the node ranges [starts, ends)
        (host int64; every start an entry point, or start == end == n for
        an empty lane), built on the host and uploaded."""
        d = self.dec
        W, dev = d.window, d.device
        entry_states, entry_ptrs = d._entry_lookup(starts)
        starts_d = trace.upload(starts.astype(np.int32), dev)
        if W > 0 and d.phase_step == 1:
            pre = starts[:, None] - W + np.arange(W)[None, :]
            pre_cl = np.clip(pre, 0, d.num_nodes - 1)
            ring = seed_rings(
                d.tables, trace.upload(d.states_np[pre_cl].astype(np.int64),
                                       dev),
                trace.upload(d.pointers[pre_cl], dev), starts_d, W)
        elif W > 0:
            ring = trace.upload(d._rings_via_native(starts, W), dev)
        else:
            ring = torch.zeros((len(starts), 1), dtype=I32, device=dev)
        return (trace.upload(entry_states.astype(np.int64), dev),
                trace.upload(entry_ptrs, dev), starts_d,
                trace.upload(ends.astype(np.int32), dev), ring)

    def _device_inputs(self, segs_d: torch.Tensor):
        """_range_inputs' lane inputs for the one-node segments segs_d
        [G] int32 (< 0: an empty lane, start == end == n), gathered on
        the device from the per-node phases: no host copy, so a CUDA
        graph can record them."""
        d = self.dec
        n, W = d.num_nodes, d.window
        states_d, ptrs_d, ctab = self._phases
        starts = torch.where(segs_d < 0, n, segs_d)
        ends = torch.clamp(starts + 1, max=n)
        live = starts < n
        at = torch.clamp(starts, max=n - 1).long()
        pre = (starts.long()[:, None] - W
               + torch.arange(W, device=segs_d.device))
        pre_cl = torch.clamp(pre, 0, n - 1)
        ring = seed_rings(d.tables, states_d[pre_cl], ptrs_d[pre_cl], starts,
                          W, ctab)
        return (torch.where(live, states_d[at], 0),
                torch.where(live, ptrs_d[at], 0), starts, ends, ring)

    def _replays(self, lanes: int) -> bool:
        """Whether a wave of `lanes` one-node segments replays a CUDA
        graph: on CUDA, at per-node phases held on the device, with a
        window, and at most WAVE_LANES lanes."""
        d = self.dec
        return (self._phases is not None and d.device.type == "cuda"
                and d.phase_step == 1 and d.window > 0
                and lanes <= self.WAVE_LANES)

    def _decode_segments(self, segs: np.ndarray, cap: int):
        """Decodes every token of the given entry segments, one lane each;
        lanes that do not finish run again alone at a doubled cap, bounded
        as in decode_raw. Returns host (vals [L, cap] u32, comps [L, cap]
        u8, counts [L]), rows in `segs` order, and the cap. A
        `wave.segments` span: `wave.inputs` (the lanes' uploads and ring
        seeds; the segment ids' upload alone where the wave replays a
        CUDA graph), then `wave.decode` (the kernel, its cap loop, the
        read-backs and the tokens' unpacking)."""
        with trace.span("wave.segments", lanes=len(segs)):
            if self._replays(len(segs)):
                return self._decode_captured(segs, cap)
            with trace.span("wave.inputs"):
                args = self._segment_inputs(segs)
            with trace.span("wave.decode"):
                return self._decode_lanes(args, cap)

    def _decode_captured(self, segs: np.ndarray, cap: int):
        """_decode_segments through the wave's CUDA graph: one upload of
        the segment ids padded to WAVE_LANES, one replay (lane inputs,
        ring seeds, the kernel) and one read-back of the flags, counts and
        the live lanes' tokens. Lanes that did not finish at cap take
        _decode_lanes' cap loop."""
        L, G = len(segs), self.WAVE_LANES
        cap = round_cap(self.dec.params, cap)
        rows = cap + cap // UNROLL
        with trace.span("wave.inputs"):
            segs_h = np.full(G, -1, np.int32)
            segs_h[:L] = segs
            segs_d = trace.upload(segs_h, self.dec.device)
        with trace.span("wave.decode"):
            args, packed = self._wave_graph(segs_d, cap)
            small = trace.fetch(packed[:2 * G + L * rows])
            if not small[:L].all():
                return self._decode_lanes([a[:L] for a in args], cap)
            out_t = small[2 * G:].reshape(L, rows).view(np.uint32)
            return (*_unpack_tokens(out_t, cap),
                    small[G:G + L].astype(np.int64), cap)

    def _wave_lanes(self, segs_d: torch.Tensor, cap: int):
        """The wave's device step for the padded segment ids segs_d:
        (the lane inputs, packed int32 [2G + G * rows]: the ok flags, the
        counts, then each lane's output column, lane after lane)."""
        d = self.dec
        args = self._device_inputs(segs_d)
        out, counts, ok = decode_blocks(d.tables, *args, d.window,
                                        d.min_interval, cap)
        return args, torch.cat([ok.to(I32), counts, out.T.reshape(-1)])

    def _wave_graph(self, segs_d: torch.Tensor, cap: int):
        """_wave_lanes, on CUDA replayed from one CUDA graph a cap: the
        first wave of a cap runs eagerly, then records the step (an
        `ra.capture` stage, wave=True); later waves copy their segment ids
        into its input and replay it."""
        if segs_d.device.type != "cuda":
            return self._wave_lanes(segs_d, cap)
        captured = self._graphs.get(cap)
        if captured is None:
            with trace.stage("ra.capture", lanes=segs_d.shape[0], cap=cap,
                             wave=True):
                res = self._wave_lanes(segs_d, cap)
                static = segs_d.clone()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out_g = self._wave_lanes(static, cap)
                self._graphs[cap] = (graph, static, out_g)
            trace.count("ra_graph_captures")
            return res
        graph, static, out_g = captured
        static.copy_(segs_d)
        graph.replay()
        decode_blocks.launches += 1    # the replay runs the kernel once
        trace.count("ra_wave_replays")
        return out_g

    def _decode_lanes(self, args, cap: int):
        d = self.dec

        def launch(lane_args, c):
            return decode_blocks(d.tables, *lane_args, d.window,
                                 d.min_interval, c)

        cap = round_cap(d.params, cap)
        out, counts, ok = launch(args, cap)
        if not bool(trace.fetch(ok.all())):
            cap = _grow_cap(
                lambda idx, c: launch([a[idx] for a in args], c)[2],
                ok, cap, d.step_bound("token"), "decode_blocks")
            out, counts, ok = launch(args, cap)
            _all_done(ok, cap, "decode_blocks")
        return (*_unpack_tokens(trace.fetch(out).view(np.uint32).T, cap),
                trace.fetch(counts).astype(np.int64), cap)

    def _follow(self, frontier: np.ndarray, child: np.ndarray,
                parent: np.ndarray, need: np.ndarray, seen: np.ndarray):
        """Extends the queries' reference closure `need` (ascending) from
        its nodes `frontier`, which are decoded, along the references of
        the decoded nodes (child -> parent, ascending in child) for as
        far as they are decoded. Returns (need, the parents it reaches in
        segments not decoded yet)."""
        missing = [np.zeros(0, np.int64)]
        while frontier.size and child.size:
            i = np.minimum(np.searchsorted(child, frontier), len(child) - 1)
            par = np.unique(parent[i[child[i] == frontier]])
            par = par[~np.isin(par, need, assume_unique=True)]
            need = np.union1d(need, par)
            dec = seen[self._seg_of(par)]
            missing.append(par[~dec])
            frontier = par[dec]
        return need, np.concatenate(missing)

    def successors_batch(self, query_nodes, cap: int = 512,
                         halo: int = 0) -> Adjacency:
        """The lists of query_nodes (repeats allowed) in query order.
        halo > 0 also decodes, in the first wave, the segments of the
        `halo` nodes before each query, where on serial artifacts its
        reference chain lies: one wave then covers chains up to that
        deep. Only the queries' reference closure is reconstructed.
        query_nodes may be a host array or a torch tensor. A `wave` span:
        each wave a `wave.segments` span (the decode) and a `wave.follow`
        span (the decoded references and the closure), then
        `wave.reconstruct` (the lists and the query rows)."""
        with trace.span("wave"):
            return self._successors(query_nodes, cap, halo)

    def _successors(self, query_nodes, cap: int, halo: int) -> Adjacency:
        query = _host_queries(query_nodes)
        if not len(query):
            return Adjacency(np.zeros(1, np.uint64), np.zeros(0, np.uint32))
        nseg = len(self._entry_nodes)
        uq = np.unique(query)
        first = (np.unique(np.maximum(uq[:, None] - np.arange(halo + 1), 0))
                 if halo else uq)
        todo = np.unique(self._seg_of(first))
        seen = np.zeros(nseg, dtype=bool)
        waves = []                    # (segs, flat values, flat comps, counts)
        # decoded nodes with a reference (ascending) and theirs; the
        # queries' reference closure, and its nodes whose reference is
        # not followed yet
        child = parent = np.zeros(0, np.int64)
        need = frontier = uq
        self.last_waves = []          # (lanes, cap) of each wave
        while todo.size:
            if len(waves) == MAX_WAVES:
                raise RuntimeError(
                    "reference chains too deep for random access waves")
            seen[todo] = True
            vals, comps, counts, wcap = self._decode_segments(todo, cap)
            self.last_waves.append((len(todo), wcap))
            with trace.span("wave.follow"):
                starts, _ = self._seg_bounds(todo)
                rowmask = np.arange(vals.shape[1])[None, :] < counts[:, None]
                fv, fc = vals[rowmask], comps[rowmask]
                waves.append((todo, fv, fc, counts))
                # each token's node: its segment's start + outdegrees - 1
                lane = np.repeat(np.arange(len(todo)), counts)
                is_out = fc == 0
                local = np.cumsum(is_out) - 1
                lane_base = np.zeros(len(todo), np.int64)
                lane_base[1:] = np.cumsum(
                    np.bincount(lane[is_out], minlength=len(todo)))[:-1]
                node_of = starts[lane] + (local - lane_base[lane])
                m = (fc == 1) & (fv > 0)
                child = np.concatenate([child, node_of[m]])
                parent = np.concatenate(
                    [parent, node_of[m] - fv[m].astype(np.int64)])
                order = np.argsort(child, kind="stable")
                child, parent = child[order], parent[order]
                need, frontier = self._follow(frontier, child, parent, need,
                                              seen)
                todo = np.unique(self._seg_of(frontier))
        with trace.span("wave.reconstruct", nodes=len(need)):
            return self._reconstruct(waves, need, query)

    def _reconstruct(self, waves, need: np.ndarray, query: np.ndarray):
        """The lists of the closure `need` from the waves' tokens, then
        the query rows in query order."""
        # every segment's tokens in ascending segment order: the nodes
        # are then strictly ascending, as reconstruct(node_ids=...) needs;
        # then only the tokens of the closure's nodes
        segs = np.concatenate([w[0] for w in waves])
        all_v = np.concatenate([w[1] for w in waves])
        all_c = np.concatenate([w[2] for w in waves])
        counts = np.concatenate([w[3] for w in waves])
        tok_end = np.cumsum(counts)
        order = np.argsort(segs, kind="stable")
        seg_counts = counts[order]
        lane, intra = _np_ragged(seg_counts, int(seg_counts.sum()))
        take = (tok_end[order] - seg_counts)[lane] + intra
        sstarts, sends = self._seg_bounds(segs[order])
        lane, intra = _np_ragged(sends - sstarts, int((sends - sstarts).sum()))
        decoded = sstarts[lane] + intra
        tv, tc = all_v[take], all_c[take]
        keep = np.isin(decoded[np.cumsum(tc == 0) - 1], need)
        ids = need
        offsets, succs = reconstruct(tv[keep], tc[keep], len(ids),
                                     self.dec.min_interval, node_ids=ids,
                                     device=self.dec.device)

        # the query rows in query order (ragged gather)
        loc = np.searchsorted(ids, query)
        row_lens = (offsets[loc + 1] - offsets[loc]).astype(np.int64)
        out_off = np.zeros(len(query) + 1, np.uint64)
        out_off[1:] = np.cumsum(row_lens)
        seg, intra = _np_ragged(row_lens, int(out_off[-1]))
        out = succs[offsets[loc[seg]].astype(np.int64) + intra]
        return Adjacency(out_off, out.astype(np.uint32))


def gather_rows(offsets, succs, q, out_cap: int):
    """Ragged row gather from a device CSR: the successor lists of the
    query nodes q (any order, repeats allowed) concatenated into a dense
    [out_cap] buffer. Returns (out, out_off [B+1], total) on the CSR's
    device; entries past total are 0, and total is exact even when it
    exceeds out_cap. One B-scale gather for the row lengths, one
    scatter-add and cumsum for each slot's query, two out_cap-scale
    gathers."""
    dev = succs.device
    B = q.shape[0]
    q = q.long()
    row_start = offsets[q]
    out_off = _excl(_cumsum(offsets[q + 1] - row_start))
    total = out_off[B]
    t = torch.arange(out_cap, dtype=I32, device=dev)
    if B == 0:
        return torch.zeros(out_cap, dtype=I32, device=dev), out_off, total
    bumps = torch.zeros(out_cap + 1, dtype=I32, device=dev)
    bumps.index_add_(0, torch.clamp(out_off[1:].long(), max=out_cap),
                     torch.ones(B, dtype=I32, device=dev))
    seg = torch.clamp(_cumsum(bumps[:out_cap]), 0, B - 1)
    # one value per query folds its row start in succs and in out
    src = (row_start - out_off[:B])[seg.long()] + t
    live = t < total
    src = torch.clamp(torch.where(live, src, 0), 0, succs.numel() - 1)
    return torch.where(live, succs[src.long()], 0), out_off, total


class TorchCsrServer:
    """Random-access serving from a device CSR: the whole graph is decoded
    once by the sort path (decode_to_csr_device; the compressed artifact
    stays the storage format), then every query batch is device gathers.
    The counterpart of the reference's random-access benchmark
    (examples/bench_random_access.rs)."""

    def __init__(self, decoder: TorchGraphDecoder, num_lanes: int = 2048):
        self.dec = decoder
        self.offsets, self.succs, self.num_arcs = \
            decoder.decode_to_csr_device(num_lanes=num_lanes)

    def serve(self, queries, out_cap: int | None = None):
        """(out, out_off, total) on the device for one query batch:
        out[:total] is the concatenation of the queried lists. queries may
        be a tensor (cast to int32 on the CSR's device, with no host round
        trip) or a host array (uploaded once). out_cap defaults to 8
        successors a query; a batch past it runs once more at the exact
        total."""
        q = _device_queries(queries, self.succs.device)
        if out_cap is None:
            out_cap = _quant(int(q.shape[0]) * 8)
        out, out_off, total = gather_rows(self.offsets, self.succs, q,
                                          out_cap)
        size = int(trace.fetch(total))
        if size > out_cap:
            out, out_off, total = gather_rows(self.offsets, self.succs, q,
                                              _quant(size))
        return out, out_off, total

    def successors_batch(self, queries) -> Adjacency:
        """The lists of queries (a host array or a tensor) on the host."""
        out, out_off, total = self.serve(queries)
        size = int(trace.fetch(total))
        return Adjacency(trace.fetch(out_off).astype(np.uint64),
                         trace.fetch(out[:size]).astype(np.uint32))


def _gather_padded(succs2d, starts_flat, degs, qp, out_cap: int):
    """Query-slice extraction from the padded column-major adjacency of
    decode_to_adjacency_device. qp [B] int32 query ids (< 0 = padding;
    repeats are enumerated each time). Returns (outv [out_cap] int32,
    offs [B+1] int32, total): query i's successors are
    outv[offs[i]:offs[i+1]]. Two out_cap-scale gathers."""
    dev = succs2d.device
    G = succs2d.shape[1]
    B = qp.shape[0]
    live = qp >= 0
    qc = torch.where(live, qp, 0).long()
    dd = torch.where(live, degs[qc], 0).to(I32)
    offs = _excl(_cumsum(dd))
    dbase = offs[:B]
    total = offs[B]
    # succ k of query i sits at starts_flat[i] + k*G, so with delta =
    # base - dbase*G the source of output slot g is delta[query] + g*G
    delta = starts_flat[qc] - dbase * G
    g = torch.arange(out_cap, dtype=I32, device=dev)
    # each slot's query: the last span start at or before it (the starts
    # of non-empty spans are distinct)
    starts_pos = torch.clamp(torch.where(live & (dd > 0), dbase, out_cap),
                             0, out_cap).long()
    ids = torch.zeros(out_cap + 1, dtype=I32, device=dev)
    ids[starts_pos] = torch.arange(B, dtype=I32, device=dev)
    # index_fill_ takes the scalar as a kernel argument: `mark[pos] =
    # True` would copy a host scalar to the card, a host synchronisation
    mark = torch.zeros(out_cap + 1, dtype=torch.bool, device=dev)
    mark.index_fill_(0, starts_pos, True)
    node = _fill_forward(mark[:out_cap], ids[:out_cap])
    src = delta[node.long()] + g * G
    flat = succs2d.reshape(-1)
    outv = torch.where(g < total,
                       flat[torch.clamp(src, 0, flat.numel() - 1).long()], 0)
    return outv, offs, total


def _ring_rows(cap: int) -> int:
    """The output ring of a per-query lane: every row it can produce."""
    return 1 << max(int(cap - 1).bit_length(), 3)


class TorchEmitRandomAccess:
    """On-demand batch random access through the merged-emit kernel: each
    unique query is one lane over [query - 4*window, query] whose only
    marked node is the query (real_starts), so the kernel resolves the
    query's reference closure in the lane and writes its final sorted
    list, read back from the lane's marker registers. A round (entry
    gathers, ring seeds, the kernel, the extraction) runs on the device
    without a host synchronisation, on CUDA as one CUDA graph per lane
    count and cap after the first; the host uploads the queries and
    fetches the offsets and flags once a round. Lanes that ran past the
    cap run again alone at twice the cap (the ring follows it), while
    the kernel's ring fits; queries the kernel cannot resolve in their
    lane (a chain deeper than the halo) go to the wave decode
    (TorchRandomAccess) on the same device.

    Serial artifacts only (per-node phases, no encode blocks), with
    windows up to the merged-emit kernel's 16; TorchRandomAccess serves
    every artifact. Reference protocol: examples/bench_random_access.rs."""

    LANE_QUANTUM = 1024       # lane counts are padded to a multiple

    def __init__(self, decoder: TorchGraphDecoder):
        d = decoder
        if d.graph.prelude.blocks is not None:
            raise ValueError("emit random access needs a serial artifact "
                             "(lanes must not cross encode blocks)")
        if d.phase_step != 1:
            raise ValueError("emit random access needs per-node phases")
        if d.window > MAX_WINDOW:
            raise ValueError(f"emit random access serves windows up to "
                             f"{MAX_WINDOW} (use TorchRandomAccess)")
        self.dec = d
        self.H = 4 * d.window
        dev = d.device
        self.ptrs_d = torch.from_numpy(d.pointers).to(dev)
        self.states_d = torch.from_numpy(d.states_np.astype(np.int64)).to(dev)
        self.ctab = _comp_table(d.params, dev)
        self._graphs: dict = {}
        self._wave = None
        # the last batch: one record per round of lanes (cap, T, lanes,
        # queries, over_cap = lanes past the cap, dirty = finished lanes
        # the kernel could not resolve, seconds on the host clock), the
        # queries sent to the wave decode and its seconds
        self.last_rounds: list[dict] = []
        self.last_unclean = 0
        self.last_wave_seconds = 0.0

    def _full_decode_cheaper(self, nuniq: int) -> bool:
        """Per-query lanes re-decode each query's halo (H + 1 nodes); past
        this many unique queries a full decode of the graph costs fewer
        lane steps."""
        return nuniq * (self.H + 1) >= self.dec.num_nodes

    def _padded(self, q: np.ndarray) -> np.ndarray:
        """The query lanes of a round: q padded with -1 (empty lanes) to a
        multiple of the quantum, so that rounds of similar size share one
        CUDA graph."""
        gpad = -(-len(q) // self.LANE_QUANTUM) * self.LANE_QUANTUM
        qp = np.full(gpad, -1, np.int64)
        qp[:len(q)] = q
        return qp

    def _lane_inputs(self, qp):
        """decode_emit's register file and entry pointers for the query
        lanes qp [gpad] int64 on the device (< 0 = padding, an empty
        lane): each lane decodes [q - H, q] and marks only q."""
        d = self.dec
        n, W = d.num_nodes, d.window
        pad = qp < 0
        q = torch.where(pad, 0, qp)
        starts = torch.where(pad, 0, torch.clamp(q - self.H, min=0))
        ends = torch.where(pad, 0, q + 1)
        ptrs = torch.where(pad, 0, self.ptrs_d[starts])
        if W > 0:
            pre = starts[:, None] - W + torch.arange(W, device=qp.device)
            pre_cl = torch.clamp(pre, 0, n - 1)
            ring = seed_rings(d.tables, self.states_d[pre_cl],
                              self.ptrs_d[pre_cl], starts, W, self.ctab)
        else:
            ring = torch.zeros((qp.shape[0], 1), dtype=I32, device=qp.device)
        regs = emit_init_regs(self.states_d[torch.clamp(starts, max=n - 1)],
                              starts, ends, ring, W, real_starts=q)
        return regs, ptrs

    def _lanes(self, qp, cap: int, T: int):
        """The kernel run for the query lanes qp. Returns (val, start_m,
        dd_c, clean, done) on the device; done is False on the lanes that
        did not finish within cap."""
        d = self.dec
        regs, ptrs = self._lane_inputs(qp)
        val, _, _, rows, ok, diag, _ = decode_emit(
            d.tables, regs, ptrs, d.window, d.min_interval, cap, T=T)
        pad = qp < 0
        markrow, mdirty = diag[0], diag[1]
        start_m = markrow + (mdirty & 1)
        dd = torch.where((mdirty & 2) != 0, 0, rows - start_m)
        clean = ((mdirty & 1) == 0) & ok & ~pad
        dd_c = torch.where(clean, torch.clamp(dd, min=0), 0).to(I32)
        return val, start_m, dd_c, clean, ok | pad

    @staticmethod
    def _extract(val, start_m, dd_c, clean, out_cap: int):
        """The clean lanes' lists packed densely in lane order: (outv
        [out_cap] int32, offs [gpad+1] int32). Slots past out_cap are cut
        off; offs stays exact."""
        gpad = dd_c.shape[0]
        offs = _excl(_cumsum(dd_c))
        node, k, valid, _ = _expand_spans(dd_c, clean, out_cap)
        src = (start_m[node.long()] + k) * gpad + node
        flat = val.reshape(-1)
        outv = torch.where(
            valid, flat[torch.clamp(src, 0, flat.numel() - 1).long()], 0)
        return outv, offs

    def _batch(self, qp, cap: int, T: int, out_cap: int):
        """One round on the device for the query lanes qp (on the device):
        (outv, offs, lanes), where lanes = _lanes' outputs, kept for a
        second extraction. On CUDA the first round of a (lane count, cap,
        output size) runs eagerly, then records the whole round into a
        CUDA graph (an `ra.capture` stage) that later rounds replay after
        copying their queries into its input."""
        if qp.device.type != "cuda":
            lanes = self._lanes(qp, cap, T)
            return (*self._extract(*lanes[:4], out_cap), lanes)
        key = (qp.shape[0], cap, out_cap)
        captured = self._graphs.get(key)
        if captured is None:
            with trace.stage("ra.capture", lanes=key[0], cap=cap,
                             out_cap=out_cap):
                lanes = self._lanes(qp, cap, T)
                res = (*self._extract(*lanes[:4], out_cap), lanes)
                static_q = qp.clone()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    lanes_g = self._lanes(static_q, cap, T)
                    out_g = self._extract(*lanes_g[:4], out_cap)
                self._graphs[key] = (graph, static_q, out_g, lanes_g)
            trace.count("ra_graph_captures")
            return res
        graph, static_q, out_g, lanes_g = captured
        static_q.copy_(qp)
        graph.replay()
        decode_emit.launches += 1      # the replay runs the kernel once
        trace.count("ra_graph_replays")
        return (*out_g, lanes_g)

    def _round(self, q: np.ndarray, cap: int, T: int):
        """The unique queries q as one round of lanes at cap. Returns
        (pool u32, offs [len(q)+1] i64, clean, done) on the host: a clean
        query's list is pool[offs[i]:offs[i+1]]. An `ra.round` span, whose
        length is the round record's `seconds`: `ra.prep` (the lanes and
        their upload), `ra.launch` (the round on the device), a `fetch` of
        the offsets and flags, `ra.extract_again` past the output buffer
        and a `fetch` of the lists."""
        d = self.dec
        B = len(q)
        with trace.timed("ra.round", queries=B, cap=cap) as rnd:
            with trace.span("ra.prep"):
                qp_h = self._padded(q)
                gpad = len(qp_h)
                out_cap = _quant(int(
                    gpad * max(d.num_arcs / max(d.num_nodes, 1), 1.0) * 2)
                    + 1)
                qp = trace.upload(qp_h, d.device)
            with trace.span("ra.launch", lanes=gpad):
                outv, offs, lanes = self._batch(qp, cap, T, out_cap)
            small = trace.fetch(
                torch.cat([offs, lanes[3].to(I32), lanes[4].to(I32)]))
            offs_h = small[:B + 1].astype(np.int64)
            clean = small[gpad + 1:gpad + 1 + B] != 0
            done = small[2 * gpad + 1:2 * gpad + 1 + B] != 0
            total = int(offs_h[B])
            if total > out_cap:
                # offs is exact past the buffer: extract once more, at size
                with trace.span("ra.extract_again", total=total):
                    outv, _ = self._extract(*lanes[:4], _quant(total))
            pool = trace.fetch(outv[:total]).astype(np.uint32)
        self.last_rounds.append({
            "cap": cap, "T": T, "lanes": gpad, "queries": B,
            "over_cap": int((~done).sum()),
            "dirty": int((done & ~clean).sum()),
            "seconds": rnd.seconds})
        return pool, offs_h, clean, done

    FULL_DECODE_LANES = 2048

    def successors_batch_device(self, query_nodes, out_cap: int | None
                                = None):
        """Device-resident batch random access, the serving contract of
        the reference's TpuEmitRandomAccess.successors_batch_device: the
        whole graph is decoded from the compressed artifact by the merged
        emit (decode_to_adjacency_device at 2048 lanes; no cache across
        batches: in the verified steady state one CUDA graph replay), then
        each query's list is cut out on the device.

        query_nodes: a torch int tensor on any device (cast to int32 on
        the decoder's device, with no host round trip: the serving case,
        queries from an earlier kernel) or a host array (uploaded once).
        Duplicates are enumerated each time. Returns (outv [out_cap]
        int32, offs [B+1] int32, total) on the device: query i's list is
        outv[offs[i]:offs[i+1]]. out_cap defaults to mean-degree sizing
        (_full_out_cap); past it offs and total stay exact and outv is
        cut off: the caller decides (total is a device scalar that
        depends on the whole pipeline, so reading it drains the batch).
        In the steady state the call issues no host synchronisation."""
        d = self.dec
        qd = _device_queries(query_nodes, d.device)
        adj = d.decode_to_adjacency_device(self.FULL_DECODE_LANES)
        if out_cap is None:
            out_cap = self._full_out_cap(qd.shape[0])
        return _gather_padded(*adj, qd, out_cap)

    def _batch_via_full_decode(self, q: np.ndarray, inv: np.ndarray):
        d = self.dec
        qd = _device_queries(q, d.device)
        adj = d.decode_to_adjacency_device(self.FULL_DECODE_LANES)
        outv, offs, total = _gather_padded(*adj, qd,
                                           self._full_out_cap(len(q)))
        size = int(trace.fetch(total))
        if size > outv.shape[0]:
            # offs is exact past the buffer: gather once more, at size
            # (the reference raises here)
            outv, offs, _ = _gather_padded(*adj, qd, _quant(size))
        self.last_rounds, self.last_unclean = [], 0
        self.last_wave_seconds = 0.0
        offs_h = trace.fetch(offs).astype(np.int64)
        return _ragged_adjacency(trace.fetch(outv).astype(np.uint32),
                                 offs_h[:-1], np.diff(offs_h), inv)

    def _full_out_cap(self, B: int) -> int:
        """Mean-degree sizing of a full-decode batch: at many random
        queries the total concentrates around B * mean degree."""
        d = self.dec
        return _quant(int(B * max(d.num_arcs / max(d.num_nodes, 1), 1.0)
                          * 1.4) + 64)

    def successors_batch(self, query_nodes, cap: int = 768) -> Adjacency:
        """The lists of query_nodes (a host array or a torch tensor,
        repeats allowed) in query order, on the host: per-query lanes
        below the full-decode point, a full merged-emit decode past it.
        An `ra.batch` span: `ra.unique`, an `ra.round` for each record of
        last_rounds, `ra.wave` (the wave decode, whose length is
        last_wave_seconds) and `ra.assemble`."""
        with trace.span("ra.batch") as batch:
            return self._successors(query_nodes, cap, batch)

    def _successors(self, query_nodes, cap: int, batch) -> Adjacency:
        d = self.dec
        with trace.span("ra.unique"):
            query = _host_queries(query_nodes)
            q, inv = np.unique(query, return_inverse=True)
        if not len(query):
            return Adjacency(np.zeros(1, np.uint64), np.zeros(0, np.uint32))
        B = len(q)
        batch.set(queries=len(query), unique=B)
        if self._full_decode_cheaper(B):
            return self._batch_via_full_decode(q, inv)
        self.last_rounds = []
        cap = -(-cap // UNROLL) * UNROLL
        bound = d.step_bound("emit")
        pools, npool = [], 0
        ubase = np.zeros(B, np.int64)
        ulen = np.zeros(B, np.int64)
        todo = np.arange(B)          # queries whose lanes ran past the cap
        unresolved = []
        while todo.size and d._emit_servable(_ring_rows(cap)):
            pool, offs_h, clean, done = self._round(q[todo], cap,
                                                    _ring_rows(cap))
            ubase[todo[clean]] = npool + offs_h[:-1][clean]
            ulen[todo[clean]] = np.diff(offs_h)[clean]
            pools.append(pool)
            npool += len(pool)
            unresolved.append(todo[done & ~clean])
            todo = todo[~done]
            if todo.size and cap >= bound:
                raise RuntimeError(
                    f"decode_emit: query {int(q[todo[0]])} has not finished "
                    f"at cap {cap}, past the {bound} steps that any lane of "
                    "this graph can need; the artifact is corrupt")
            cap *= 2
        # lanes whose ring no longer fits a block stay unresolved too
        unresolved = np.sort(np.concatenate(unresolved + [todo]))
        if len(unresolved) > max(64, B // 2):
            raise RuntimeError(
                f"emit random access: {len(unresolved)}/{B} lanes "
                "unresolved; artifact unsuited (use TorchRandomAccess)")
        self.last_unclean = len(unresolved)
        self.last_wave_seconds = 0.0
        if len(unresolved):
            if self._wave is None:
                self._wave = TorchRandomAccess(
                    d, phases=(self.states_d, self.ptrs_d, self.ctab))
            with trace.timed("ra.wave", queries=len(unresolved)) as wv:
                wave = self._wave.successors_batch(q[unresolved],
                                                   halo=self.H)
            self.last_wave_seconds = wv.seconds
            wave_offs = wave.offsets.astype(np.int64)
            ubase[unresolved] = npool + wave_offs[:-1]
            ulen[unresolved] = np.diff(wave_offs)
            pools.append(wave.succs.astype(np.uint32))
        with trace.span("ra.assemble"):
            pool = (np.concatenate(pools) if pools
                    else np.zeros(0, np.uint32))
            return _ragged_adjacency(pool, ubase, ulen, inv)
