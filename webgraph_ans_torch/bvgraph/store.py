"""The 3-pass ANS compression pipeline (reference: src/bvgraph/random_access.rs:91-222).

Pass 1: BvComp with the Log2 estimator -> raw-symbol histograms -> bootstrap model.
Pass 2: BvComp with the entropy estimator built from the pass-1 model -> refined
        histograms -> final model.
Pass 3: BvComp with the SAME pass-1 entropy estimator (so passes 2 and 3 make
        identical reference-selection decisions) + reverse rANS encoding with
        the pass-2 model, capturing one (state, stream pointer) phase per node.

The BvComp walks and the rANS encode run in the native runtime; model building
runs in Python between the passes; with the device hooks, the model
search and the pass-3 encode run in PyTorch/CUDA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import time

import numpy as np

from ..ans.model import ANSModel, build_model, model_report
from ..ans.prelude import Prelude, save_pointers, save_states
from ..ops.decode_torch import resolve_device
from ..ops.encode_torch import lane_encode_tokens
from ..ops.model_torch import build_model_torch
from ..utils import native
from . import estimators
from .graph import Adjacency, load_bvgraph

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CompressionResult:
    prelude: Prelude
    states: np.ndarray    # u32, reverse node order
    pointers: np.ndarray  # u64, reverse node order (monotone nondecreasing)
    report: list[dict]
    # pass-1 entropy-estimator tables (the estimator that drove the pass-2/3
    # reference decisions); kept so tests can reproduce BvComp's token stream
    est_tables: "estimators.EntropyTables | None" = None
    # host-clock seconds of the stages: histograms, model_search, encode
    # and, on the block-parallel encode, tokens, encode_plan,
    # encode_kernel, encode_assembly
    seconds: dict = dataclasses.field(default_factory=dict)


def _run_histogram_pass(adj: Adjacency, window: int, max_ref: int, min_interval: int,
                        est_type: int, tables: estimators.EntropyTables):
    lib = native.get_lib()
    h = native.check_ptr(
        lib.wgt_bvcomp_histogram(
            adj.num_nodes,
            native.as_ptr(adj.offsets, ctypes.c_uint64),
            native.as_ptr(adj.succs, ctypes.c_uint32),
            window, max_ref, min_interval,
            est_type,
            native.as_ptr(tables.costs, ctypes.c_uint64),
            native.as_ptr(tables.lens, ctypes.c_uint64),
            native.as_ptr(tables.fidelity, ctypes.c_uint32),
            native.as_ptr(tables.radix, ctypes.c_uint32),
        )
    )
    try:
        hists = []
        for comp in range(9):
            k = int(lib.wgt_hist_size(h, comp))
            syms = np.empty(k, dtype=np.uint64)
            counts = np.empty(k, dtype=np.uint64)
            if k:
                lib.wgt_hist_get(
                    h, comp,
                    native.as_ptr(syms, ctypes.c_uint64),
                    native.as_ptr(counts, ctypes.c_uint64),
                )
            hists.append((syms, counts))
        return hists
    finally:
        lib.wgt_hist_free(h)


def _run_encode_pass(adj: Adjacency, window: int, max_ref: int, min_interval: int,
                     tables: estimators.EntropyTables, model: ANSModel,
                     spill_path: str | None = None,
                     spill_chunk_tokens: int = 1 << 22):
    """With spill_path set, pass 3 runs out-of-core: the token buffer
    spills to disk in varint chunks and RAM stays O(spill_chunk_tokens)
    (RevBuffer parity; reference src/utils/rev.rs:116-221). Output is
    bit-identical to the in-RAM path."""
    lib = native.get_lib()
    freqs, lens, log_m, radix, fidelity = model.packed()
    common = (
        adj.num_nodes,
        native.as_ptr(adj.offsets, ctypes.c_uint64),
        native.as_ptr(adj.succs, ctypes.c_uint32),
        window, max_ref, min_interval,
        native.as_ptr(tables.costs, ctypes.c_uint64),
        native.as_ptr(tables.lens, ctypes.c_uint64),
        native.as_ptr(tables.fidelity, ctypes.c_uint32),
        native.as_ptr(tables.radix, ctypes.c_uint32),
        native.as_ptr(freqs, ctypes.c_uint16),
        native.as_ptr(lens, ctypes.c_uint64),
        native.as_ptr(log_m, ctypes.c_uint32),
        native.as_ptr(radix, ctypes.c_uint32),
        native.as_ptr(fidelity, ctypes.c_uint32),
    )
    if spill_path is not None:
        h = native.check_ptr(
            lib.wgt_bvcomp_encode_spill(
                *common, spill_path.encode(), spill_chunk_tokens))
    else:
        h = native.check_ptr(lib.wgt_bvcomp_encode(*common))
    try:
        stream_len = int(lib.wgt_enc_stream_len(h))
        num_phases = int(lib.wgt_enc_num_phases(h))
        final_state = int(lib.wgt_enc_final_state(h))
        stream = np.empty(stream_len, dtype=np.uint16)
        states = np.empty(num_phases, dtype=np.uint32)
        pointers = np.empty(num_phases, dtype=np.uint64)
        if stream_len:
            lib.wgt_enc_get_stream(h, native.as_ptr(stream, ctypes.c_uint16))
        if num_phases:
            lib.wgt_enc_get_states(h, native.as_ptr(states, ctypes.c_uint32))
            lib.wgt_enc_get_pointers(h, native.as_ptr(pointers, ctypes.c_uint64))
        return stream, states, pointers, final_state
    finally:
        lib.wgt_enc_free(h)


def _run_histogram_pass_stream(data, props, window: int, max_ref: int,
                               min_interval: int, est_type: int,
                               tables: estimators.EntropyTables):
    """Histogram pass straight from the mmap'd .graph bitstream: RAM is
    O(input window + output window + histograms), never the adjacency
    (reference shape: mmap'd BvGraphSeq pulled by BvComp,
    src/bvgraph/random_access.rs:101-132)."""
    lib = native.get_lib()
    h = native.check_ptr(
        lib.wgt_bvcomp_histogram_stream(
            native.as_ptr(data, ctypes.c_uint8), len(data), props.nodes,
            props.window_size, props.min_interval_length, props.zeta_k,
            props.outdegree_code, props.reference_code, props.block_code,
            props.residual_code,
            window, max_ref, min_interval,
            est_type,
            native.as_ptr(tables.costs, ctypes.c_uint64),
            native.as_ptr(tables.lens, ctypes.c_uint64),
            native.as_ptr(tables.fidelity, ctypes.c_uint32),
            native.as_ptr(tables.radix, ctypes.c_uint32),
        )
    )
    try:
        hists = []
        for comp in range(9):
            k = int(lib.wgt_hist_size(h, comp))
            syms = np.empty(k, dtype=np.uint64)
            counts = np.empty(k, dtype=np.uint64)
            if k:
                lib.wgt_hist_get(
                    h, comp,
                    native.as_ptr(syms, ctypes.c_uint64),
                    native.as_ptr(counts, ctypes.c_uint64),
                )
            hists.append((syms, counts))
        return hists
    finally:
        lib.wgt_hist_free(h)


def _run_encode_pass_stream(data, props, window: int, max_ref: int,
                            min_interval: int,
                            tables: estimators.EntropyTables,
                            model: ANSModel,
                            spill_path: str | None = None,
                            spill_chunk_tokens: int = 1 << 22):
    """Pass 3 straight from the mmap'd bitstream; with spill_path the
    token buffer also goes out-of-core (O(spill_chunk_tokens) RAM)."""
    lib = native.get_lib()
    freqs, lens, log_m, radix, fidelity = model.packed()
    h = native.check_ptr(
        lib.wgt_bvcomp_encode_stream(
            native.as_ptr(data, ctypes.c_uint8), len(data), props.nodes,
            props.window_size, props.min_interval_length, props.zeta_k,
            props.outdegree_code, props.reference_code, props.block_code,
            props.residual_code,
            window, max_ref, min_interval,
            native.as_ptr(tables.costs, ctypes.c_uint64),
            native.as_ptr(tables.lens, ctypes.c_uint64),
            native.as_ptr(tables.fidelity, ctypes.c_uint32),
            native.as_ptr(tables.radix, ctypes.c_uint32),
            native.as_ptr(freqs, ctypes.c_uint16),
            native.as_ptr(lens, ctypes.c_uint64),
            native.as_ptr(log_m, ctypes.c_uint32),
            native.as_ptr(radix, ctypes.c_uint32),
            native.as_ptr(fidelity, ctypes.c_uint32),
            spill_path.encode() if spill_path is not None else None,
            spill_chunk_tokens,
        )
    )
    try:
        stream_len = int(lib.wgt_enc_stream_len(h))
        num_phases = int(lib.wgt_enc_num_phases(h))
        final_state = int(lib.wgt_enc_final_state(h))
        stream = np.empty(stream_len, dtype=np.uint16)
        states = np.empty(num_phases, dtype=np.uint32)
        pointers = np.empty(num_phases, dtype=np.uint64)
        if stream_len:
            lib.wgt_enc_get_stream(h, native.as_ptr(stream, ctypes.c_uint16))
        if num_phases:
            lib.wgt_enc_get_states(h, native.as_ptr(states, ctypes.c_uint32))
            lib.wgt_enc_get_pointers(h, native.as_ptr(pointers, ctypes.c_uint64))
        return stream, states, pointers, final_state
    finally:
        lib.wgt_enc_free(h)


def compress_bvgraph_streaming(basename: str, compression_window: int = 7,
                               max_ref_count: int = 3,
                               min_interval_length: int = 2,
                               max_frame_log2: int = 12,
                               spill_path: str | None = None,
                               spill_chunk_tokens: int = 1 << 22
                               ) -> CompressionResult:
    """The 3-pass pipeline without EVER materializing the input
    adjacency: each pass re-walks the mmap'd `.graph` bitstream through
    BvComp (two O(window) list rings), so compression RAM is
    O(window + histograms + phases [+ spill chunk]) — the reference's
    streaming shape (BvGraphSeq + BvComp + RevBuffer), where this repo's
    default path loads the graph into an in-RAM CSR first. Output is
    bit-identical to the in-RAM pipeline (same BvComp decisions)."""
    from . import properties as props_mod

    props = props_mod.BvGraphProperties.load(basename)
    data = props_mod.graph_bytes(basename)

    t0 = time.time()
    hist1 = _run_histogram_pass_stream(
        data, props, compression_window, max_ref_count, min_interval_length,
        estimators.LOG2, estimators.empty_tables())
    model1 = build_model(hist1, max_frame_log2)
    log.info("pass 1 (streaming log2 histograms + model) in %.2fs",
             time.time() - t0)

    t1 = time.time()
    tables1 = estimators.entropy_tables(model1)
    hist2 = _run_histogram_pass_stream(
        data, props, compression_window, max_ref_count, min_interval_length,
        estimators.ENTROPY, tables1)
    model2 = build_model(hist2, max_frame_log2)
    log.info("pass 2 (streaming entropy histograms + model) in %.2fs",
             time.time() - t1)

    t2 = time.time()
    stream, states, pointers, final_state = _run_encode_pass_stream(
        data, props, compression_window, max_ref_count, min_interval_length,
        tables1, model2, spill_path=spill_path,
        spill_chunk_tokens=spill_chunk_tokens)
    log.info("pass 3 (streaming encode) in %.2fs", time.time() - t2)

    prelude = Prelude(
        model=model2,
        stream=np.ascontiguousarray(stream, dtype=np.uint16),
        state=final_state,
        num_nodes=props.nodes,
        num_arcs=props.arcs,
        compression_window=compression_window,
        min_interval_length=min_interval_length,
        blocks=None,
    )
    return CompressionResult(prelude, states, pointers,
                             model_report(model2, hist2), tables1)


def dump_tokens(adj: Adjacency, window: int, max_ref: int, min_interval: int,
                tables: estimators.EntropyTables):
    """Forward-order (value, component) token stream BvComp chooses under the
    given entropy estimator — ground truth for the device token decoder."""
    lib = native.get_lib()
    h = native.check_ptr(
        lib.wgt_bvcomp_tokens(
            adj.num_nodes,
            native.as_ptr(adj.offsets, ctypes.c_uint64),
            native.as_ptr(adj.succs, ctypes.c_uint32),
            window, max_ref, min_interval,
            native.as_ptr(tables.costs, ctypes.c_uint64),
            native.as_ptr(tables.lens, ctypes.c_uint64),
            native.as_ptr(tables.fidelity, ctypes.c_uint32),
            native.as_ptr(tables.radix, ctypes.c_uint32),
        )
    )
    try:
        k = int(lib.wgt_tok_count(h))
        values = np.empty(k, dtype=np.uint64)
        comps = np.empty(k, dtype=np.uint8)
        if k:
            lib.wgt_tok_get(h, native.as_ptr(values, ctypes.c_uint64),
                            native.as_ptr(comps, ctypes.c_uint8))
        return values, comps
    finally:
        lib.wgt_tok_free(h)


def compress_adjacency(adj: Adjacency, compression_window: int = 7,
                       max_ref_count: int = 3, min_interval_length: int = 2,
                       use_tpu_model_search: bool = False,
                       max_frame_log2: int = 12,
                       encode_blocks: int = 1,
                       spill_path: str | None = None,
                       spill_chunk_tokens: int = 1 << 22,
                       safe_break_interval: int = 0,
                       device=None) -> CompressionResult:
    """encode_blocks > 1 runs pass 3's rANS encode lane-parallel on the
    device (ops/encode_torch.py, kernel ops/encode_cuda.py): the stream
    splits into that many independent blocks at token-balanced node
    boundaries, recorded in the prelude's block table.
    use_tpu_model_search runs the model search of passes 1-2 on the
    device (ops/model_torch.py; the same model as the host search).
    encode_blocks=1 is the serial native encode (bit-identical to the
    reference pipeline); with spill_path set it runs out-of-core with
    O(spill_chunk_tokens) RAM. `device` is where the device stages run:
    CUDA unless given (device="cpu" runs their plain PyTorch versions);
    it is resolved only when a device stage runs.

    safe_break_interval > 0 forbids references at every k-th node, so no
    copy chain crosses those nodes — a format extension of this
    framework that keeps HIGH-COMPRESSION artifacts (-w 16, unbounded
    max_ref, chains thousands deep) lane-splittable for the parallel
    device decoder, at a size cost of ~n/k forced-no-ref nodes (measured
    +0.3% on cnr-2000 hc at k=1024)."""
    if safe_break_interval:
        native.get_lib().wgt_set_safe_break(safe_break_interval)
    try:
        return _compress_adjacency(
            adj, compression_window, max_ref_count, min_interval_length,
            use_tpu_model_search, max_frame_log2, encode_blocks,
            spill_path, spill_chunk_tokens, device)
    finally:
        if safe_break_interval:
            native.get_lib().wgt_set_safe_break(0)


def _build_models(adj, compression_window, max_ref_count,
                  min_interval_length, use_tpu_model_search,
                  max_frame_log2, device, seconds):
    """Passes 1-2: bootstrap + refined model (shared by every encode of
    the same graph/flags; reference random_access.rs:105-164). With
    use_tpu_model_search the model search runs on `device`. The stage
    times go into `seconds`."""
    if use_tpu_model_search:
        device = resolve_device(device)

        def search(hist):
            return build_model_torch(hist, max_frame_log2, device=device)
    else:
        def search(hist):
            return build_model(hist, max_frame_log2)

    # Pass 1: bootstrap model with the log2 estimator.
    t0 = time.perf_counter()
    hist1 = _run_histogram_pass(
        adj, compression_window, max_ref_count, min_interval_length,
        estimators.LOG2, estimators.empty_tables(),
    )
    t1 = time.perf_counter()
    model1 = search(hist1)
    t2 = time.perf_counter()
    log.info("pass 1 (log2 histograms + model) in %.2fs", t2 - t0)

    # Pass 2: refined model under the pass-1 entropy estimator.
    tables1 = estimators.entropy_tables(model1)
    hist2 = _run_histogram_pass(
        adj, compression_window, max_ref_count, min_interval_length,
        estimators.ENTROPY, tables1,
    )
    t3 = time.perf_counter()
    model2 = search(hist2)
    t4 = time.perf_counter()
    log.info("pass 2 (entropy histograms + model) in %.2fs", t4 - t2)
    seconds.update(histograms=(t1 - t0) + (t3 - t2),
                   model_search=(t2 - t1) + (t4 - t3))
    return model2, tables1, hist2


def _encode_with_models(adj, model2, tables1, hist2, compression_window,
                        max_ref_count, min_interval_length, encode_blocks,
                        spill_path, spill_chunk_tokens, device, seconds):
    """Pass 3: encode with the pass-2 model; selection still driven by
    the pass-1 estimator, exactly like the reference
    (random_access.rs:166-196). encode_blocks > 1 encodes on `device`.
    The stage times go into `seconds`."""
    t2 = time.perf_counter()
    blocks = None
    if encode_blocks > 1:
        device = resolve_device(device)
        vals, comps = dump_tokens(adj, compression_window, max_ref_count,
                                  min_interval_length, tables1)
        seconds["tokens"] = time.perf_counter() - t2
        stream, states, pointers, final_state, blocks = lane_encode_tokens(
            model2, vals, comps, num_blocks=encode_blocks, device=device,
            seconds=seconds)
    else:
        stream, states, pointers, final_state = _run_encode_pass(
            adj, compression_window, max_ref_count, min_interval_length,
            tables1, model2, spill_path=spill_path,
            spill_chunk_tokens=spill_chunk_tokens,
        )
    seconds["encode"] = time.perf_counter() - t2
    log.info("pass 3 (encode) in %.2fs", seconds["encode"])

    prelude = Prelude(
        model=model2,
        stream=np.ascontiguousarray(stream, dtype=np.uint16),
        state=final_state,
        num_nodes=adj.num_nodes,
        num_arcs=adj.num_arcs,
        compression_window=compression_window,
        min_interval_length=min_interval_length,
        blocks=blocks,
    )
    return CompressionResult(prelude, states, pointers,
                             model_report(model2, hist2), tables1, seconds)


def _compress_adjacency(adj, compression_window, max_ref_count,
                        min_interval_length, use_tpu_model_search,
                        max_frame_log2, encode_blocks, spill_path,
                        spill_chunk_tokens, device) -> CompressionResult:
    seconds = {}
    model2, tables1, hist2 = _build_models(
        adj, compression_window, max_ref_count, min_interval_length,
        use_tpu_model_search, max_frame_log2, device, seconds)
    return _encode_with_models(
        adj, model2, tables1, hist2, compression_window, max_ref_count,
        min_interval_length, encode_blocks, spill_path,
        spill_chunk_tokens, device, seconds)


def store_layouts(basename: str, outputs, compression_window: int = 7,
                  max_ref_count: int = 3, min_interval_length: int = 2,
                  max_frame_log2: int = 12,
                  safe_break_interval: int = 0, device=None):
    """Compresses one graph into SEVERAL stream layouts (e.g. the serial
    single-stream file and a block-parallel file) while running the
    model passes 1-2 only ONCE — the layouts differ only in pass 3.
    `outputs` is a list of (new_basename, encode_blocks); returns the
    CompressionResult per output, artifacts identical to per-layout
    store() calls (the passes are deterministic). Block layouts encode on
    `device` (see compress_adjacency)."""
    adj, _props = load_bvgraph(basename)
    if safe_break_interval:
        native.get_lib().wgt_set_safe_break(safe_break_interval)
    try:
        model2, tables1, hist2 = _build_models(
            adj, compression_window, max_ref_count, min_interval_length,
            False, max_frame_log2, None, {})
        results = []
        for new_basename, encode_blocks in outputs:
            res = _encode_with_models(
                adj, model2, tables1, hist2, compression_window,
                max_ref_count, min_interval_length, encode_blocks,
                None, 1 << 22, device, {})
            res.prelude.save(new_basename)
            save_states(new_basename, res.states)
            save_pointers(new_basename, res.pointers)
            results.append(res)
        return results
    finally:
        if safe_break_interval:
            native.get_lib().wgt_set_safe_break(0)


def store(basename: str, new_basename: str, compression_window: int = 7,
          max_ref_count: int = 3, min_interval_length: int = 2,
          use_tpu_model_search: bool = False,
          max_frame_log2: int = 12,
          encode_blocks: int = 1,
          phase_step: int = 1,
          spill_path: str | None = None,
          spill_chunk_tokens: int = 1 << 22,
          streaming: bool = False,
          safe_break_interval: int = 0,
          device=None) -> CompressionResult:
    """Recompresses the BVGraph at `basename` into `new_basename.{ans,pointers,states}`
    (reference: ANSBvGraph::store, random_access.rs:91-222).

    phase_step > 1 samples the phase artifacts: `.states`/`.pointers`
    keep an entry only for every phase_step-th node, shrinking them ~k x
    at the cost of decoding up to k-1 extra lists per random-access
    query (the storage/speed dial BVGraph's own offset steps use; the
    reference stores every node's phase and its authors flag the 2.4-3.4x
    phase overhead as an open problem, reference README.md:176-179).

    spill_path runs pass 3 out-of-core: the token buffer spills to disk
    in varint chunks and pass-3 RAM stays O(spill_chunk_tokens), the
    reference's default RevBuffer behavior (src/bvgraph/writers/
    bvgraph_encoder.rs:159-174, src/utils/rev.rs). Bit-identical output;
    serial encode only (encode_blocks must be 1).

    encode_blocks > 1 and use_tpu_model_search run on `device` (CUDA
    unless given; see compress_adjacency)."""
    if spill_path is not None and encode_blocks > 1:
        raise ValueError("spill_path requires the serial encoder "
                         "(encode_blocks=1)")
    if streaming:
        if encode_blocks > 1 or use_tpu_model_search:
            raise ValueError("streaming store supports the serial native "
                             "pipeline (encode_blocks=1, host model search)")
        if safe_break_interval:
            native.get_lib().wgt_set_safe_break(safe_break_interval)
        try:
            result = compress_bvgraph_streaming(
                basename, compression_window, max_ref_count,
                min_interval_length, max_frame_log2=max_frame_log2,
                spill_path=spill_path,
                spill_chunk_tokens=spill_chunk_tokens)
        finally:
            if safe_break_interval:
                native.get_lib().wgt_set_safe_break(0)
    else:
        adj, _props = load_bvgraph(basename)
        result = compress_adjacency(
            adj, compression_window, max_ref_count, min_interval_length,
            use_tpu_model_search=use_tpu_model_search,
            max_frame_log2=max_frame_log2,
            encode_blocks=encode_blocks,
            spill_path=spill_path,
            spill_chunk_tokens=spill_chunk_tokens,
            safe_break_interval=safe_break_interval,
            device=device,
        )
    prelude, states, pointers = result.prelude, result.states, result.pointers
    if phase_step > 1:
        prelude = dataclasses.replace(prelude, phase_step=phase_step)
        # phases are stored in reverse node order; sample nodes 0, k, ...
        n = prelude.num_nodes
        keep_nodes = np.arange(0, n, phase_step)
        rev_idx = (n - 1 - keep_nodes)[::-1]
        states = np.ascontiguousarray(states[rev_idx])
        pointers = np.ascontiguousarray(pointers[rev_idx])
    prelude.save(new_basename)
    save_states(new_basename, states)
    save_pointers(new_basename, pointers)
    return result
