"""Scale-out on one host: the lanes of a decode split over a list of
devices (the PyTorch form of webgraph_ans_tpu/parallel/sharded.py, whose
jax.sharding.Mesh becomes a list of torch.devices).

Node-range blocks are independent entry points (the phase table), so the
lanes of a decode split into contiguous groups, one a device entry. Each
distinct device holds one copy of the decoder LUT and stream (the
replicated tables), runs the kernel on its groups (launches are
asynchronous, so the cards overlap), and the outputs are concatenated in
lane order on devices[0]. The model histogram splits its symbol stream
the same way and sums the per-device histograms on devices[0].

A device may appear more than once in `devices`: every entry is a shard
with its own launch, so [cuda:0] * 4 runs the split, the per-shard
launches and the gather on one card, and ["cpu"] * 4 on the host (the
plain versions of the kernels).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.decode_cuda import decode_blocks
from ..ops.decode_torch import (DecoderTables, fetch_block_tokens,
                                seed_rings)
from ..ops.emit_cuda import decode_emit
from ..ops.graph_decode import TorchGraphDecoder


def _norm(device) -> torch.device:
    """A device with its index: "cuda" names the current CUDA device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_devices(n: int | None = None, device=None) -> list:
    """The devices of a sharded decode: the CUDA devices (the first n of
    them), or n entries of `device` when one is named (["cpu"] * n on the
    host, [cuda:0] * n for n shards on one card)."""
    if device is not None:
        return [_norm(device)] * (n or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "shard over the host")
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise ValueError(f"{n} CUDA devices asked for, {count} present; "
                         "name a device to run several shards on it")
    return [torch.device("cuda", i) for i in range(count if n is None
                                                    else n)]


def replicate_tables(tables: DecoderTables, devices) -> dict:
    """One copy of the decoder LUT and stream for each distinct device
    (no copy for the device the tables already lie on)."""
    return {d: DecoderTables(tables.lut.to(d), tables.stream.to(d),
                             tables.params)
            for d in dict.fromkeys(map(_norm, devices))}


def _on(device: torch.device):
    """Makes `device` the current CUDA device around a kernel launch."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _bounds(total: int, sizes) -> np.ndarray:
    """Group boundaries: equal contiguous groups when sizes is an int (the
    group count), else the given group sizes in order."""
    if isinstance(sizes, int):
        return (np.arange(sizes + 1) * total) // sizes
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    if bounds[-1] != total:
        raise ValueError(f"group sizes {list(sizes)} do not add up to "
                         f"{total} lanes")
    return bounds


def _per_group(devices, total: int, fn, sizes=None) -> list:
    """fn(device, slice) for each group of contiguous lanes, one group a
    device entry (equal groups, or `sizes` lanes each); groups without a
    lane are skipped. Returns the results in lane order."""
    devices = [_norm(d) for d in devices]
    b = _bounds(total, len(devices) if sizes is None else sizes)
    out = []
    for g, dev in enumerate(devices):
        if b[g + 1] > b[g]:
            with _on(dev):
                out.append(fn(dev, slice(int(b[g]), int(b[g + 1]))))
    return out


def _cat(parts, dim: int, device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts], dim)


def _owner_sizes(idx: torch.Tensor, total: int, ndev: int) -> list:
    """Lanes of the ascending lane index idx that each of ndev equal
    groups owns: their relaunch stays on their own device."""
    b = torch.as_tensor(_bounds(total, ndev), device=idx.device)
    return torch.bucketize(idx, b[1:], right=True).bincount(
        minlength=ndev).tolist()


def sharded_decode_blocks(devices, tables_by_device: dict, states, ptrs,
                          starts, ends, ring, window: int,
                          min_interval: int, cap: int, sizes=None,
                          emit_aux: bool = False):
    """decode_blocks with the lanes split into contiguous groups, one a
    device entry (`sizes` lanes each, equal groups by default), each
    launched on its device with that device's tables. Returns (out,
    counts, ok) concatenated in lane order on devices[0]."""
    lanes = (states, ptrs, starts, ends, ring)

    def run(dev, sl):
        return decode_blocks(tables_by_device[dev],
                             *(a[sl].to(dev) for a in lanes), window,
                             min_interval, cap, emit_aux=emit_aux)

    parts = _per_group(devices, states.shape[0], run, sizes)
    d0 = _norm(devices[0])
    return tuple(_cat([p[k] for p in parts], -1, d0) for k in range(3))


def sharded_seed_rings(devices, tables_by_device: dict, seed_states,
                       seed_ptrs, starts, window: int):
    """seed_rings with the lanes split as in sharded_decode_blocks; the
    rings [L, window+1] concatenated in lane order on devices[0]."""
    lanes = (seed_states, seed_ptrs, starts)

    def run(dev, sl):
        return seed_rings(tables_by_device[dev],
                          *(a[sl].to(dev) for a in lanes), window)

    return _cat(_per_group(devices, starts.shape[0], run), 0,
                _norm(devices[0]))


def sharded_histogram(devices, symbols, components,
                      num_bins: int) -> torch.Tensor:
    """Per-component histogram [9, num_bins] int64 of a (symbol,
    component) stream split into contiguous groups, one a device entry: a
    local scatter_add_ on each device, then their sum on devices[0].
    Symbols above num_bins-1 count in the top bin (callers histogram
    folded symbols, which are bounded)."""
    symbols = torch.as_tensor(symbols)
    components = torch.as_tensor(components)

    def run(dev, sl):
        sym = symbols[sl].to(dev).long().clamp(0, num_bins - 1)
        flat = components[sl].to(dev).long() * num_bins + sym
        local = torch.zeros(9 * num_bins, dtype=torch.int64, device=dev)
        return local.scatter_add_(0, flat, torch.ones_like(flat))

    d0 = _norm(devices[0])
    parts = _per_group(devices, symbols.shape[0], run)
    total = torch.zeros(9 * num_bins, dtype=torch.int64, device=d0)
    for p in parts:
        total += p.to(d0)
    return total.view(9, num_bins)


def sharded_emit_adjacency(devices, dec: TorchGraphDecoder,
                           num_lanes: int = 2048):
    """The merged-emit path with the lanes of the decoder's plan split
    over `devices`: each device runs decode_emit on its contiguous group
    of lanes (its columns of the register file and its entry pointers,
    with its own copy of the tables), and the outputs are concatenated
    back into the single-device lane layout on devices[0], which must be
    the decoder's device. Everything else is
    TorchGraphDecoder.decode_to_adjacency_device's, through its launch
    hook: the plan and its refinement, the cap loop (lanes that did not
    finish run again at twice the cap, here on their own device, bounded
    by step_bound), the post-pass, and the steady state once the plan is
    verified (run eagerly, not as a CUDA graph).

    Returns (succs2d, starts_flat, degs), bit for bit what
    decode_to_adjacency_device returns on the same plan. Where that call
    falls back to the sort path this raises instead: EmitPlanUnsupported
    for a window past 16 or a plan the kernel cannot serve, and the
    post-pass's RuntimeError as it comes."""
    devices = [_norm(d) for d in devices]
    d0 = devices[0]
    if d0 != _norm(dec.device):
        raise ValueError(f"devices[0] is {d0}, the decoder's device "
                         f"{dec.device}: the post-pass runs on the latter")
    tables = replicate_tables(dec.tables, devices)

    def launch(regs, ptrs, cap, T, idx=None, mark_deg=False):
        sizes = None
        if idx is not None:
            sizes = _owner_sizes(idx, ptrs.shape[0], len(devices))
            regs, ptrs = regs[:, idx], ptrs[idx]

        def run(dev, sl):
            return decode_emit(tables[dev], regs[:, sl].contiguous().to(dev),
                               ptrs[sl].to(dev), dec.window,
                               dec.min_interval, cap, T=T, mark_deg=mark_deg)

        parts = _per_group(devices, ptrs.shape[0], run, sizes)
        return tuple(_cat([p[k] for p in parts], -1, d0)
                     for k in range(len(parts[0])))

    return dec.decode_to_adjacency_device(num_lanes, launch=launch)


class ShardedGraphDecoder:
    """TorchGraphDecoder with the lanes of its token decode spread over
    a list of devices (one group of lanes an entry), with one copy of the
    tables and stream on each distinct device."""

    def __init__(self, graph, devices=None):
        self.devices = [_norm(d) for d in (devices or make_devices())]
        self.single = TorchGraphDecoder(graph, device=self.devices[0])
        self.tables = replicate_tables(self.single.tables, self.devices)

    def _seed(self, states, ptrs, starts, window: int):
        return sharded_seed_rings(self.devices, self.tables, states, ptrs,
                                  starts, window)

    def _launch(self, lanes, cap: int, idx=None, emit_aux: bool = False):
        """TorchGraphDecoder.decode_raw's launch over the devices: lanes
        idx (of a regrowth) stay in the groups that own them."""
        sizes = None
        if idx is not None:
            sizes = _owner_sizes(idx, lanes[0].shape[0], len(self.devices))
            lanes = [a[idx] for a in lanes]
        return sharded_decode_blocks(
            self.devices, self.tables, *lanes, self.single.window,
            self.single.min_interval, cap, sizes, emit_aux=emit_aux)

    def decode_raw(self, lanes_per_device: int = 32,
                   cap: int | None = None):
        """The sharded token decode of the whole graph: (out, counts, cap)
        of decode_blocks's layout, the lanes in order on devices[0]. The
        lane count is padded with empty lanes to a multiple of the device
        count (encode-block starts can add lanes). The cap loop is
        TorchGraphDecoder.decode_raw's, with lanes that did not finish
        run again on their own device."""
        ndev = len(self.devices)
        return self.single.decode_raw(lanes_per_device * ndev, cap,
                                      pad_to=ndev, seed=self._seed,
                                      launch=self._launch)

    def decode_tokens(self, lanes_per_device: int = 32,
                      cap: int | None = None):
        """Every (component, value) token of the graph in forward node
        order (host arrays: values u32, comps u8), the decode's lanes
        spread over the devices."""
        return fetch_block_tokens(*self.decode_raw(lanes_per_device, cap))
