"""Analytic size of the reference's `.ans` artifact for a given model +
stream — the golden fixture for size parity.

With max_frame_log2=16 this framework's model search reproduces the
reference's model exactly and the serial encoder is bit-identical
(tests/test_model_builder.py, tests/test_torch_encode.py), so the
reference pipeline run on the same graph would serialize exactly this
model and stream. Its `.ans` is an ε-serde file of

    Prelude { tables: Vec<ANSComponentModel4Encoder>, stream: Vec<u16>,
              state: u32, number_of_nodes: usize,
              compression_window: usize, min_interval_length: usize,
              number_of_arcs: u64 }              (reference: src/ans/mod.rs:31-54)

where each component model is

    ANSComponentModel4Encoder { table: Vec<EncoderModelEntry>,
        frame_size/radix/fidelity: usize, folding_threshold/offset: u64 }
    EncoderModelEntry { upperbound: u32, cumul_freq: u16, freq: u16 }
                         (reference: src/ans/models/component_model4encoder.rs:14-57)

This function counts the DATA PAYLOAD only (no ε-serde magic/version/
type-hash header, no alignment padding), i.e. a strict LOWER bound on
the real reference file size — asserting `ours <= reference_ans_payload`
is therefore a conservative parity proof.
"""

from __future__ import annotations

from .model import ANSModel

USIZE = 8  # ε-serde is used on 64-bit targets (reference benchmarks)


def reference_ans_payload_bytes(model: ANSModel, stream_len: int) -> int:
    """Lower bound (payload-only) for the reference `.ans` holding this
    model and a `stream_len`-word stream."""
    total = 0
    # tables: Vec<ANSComponentModel4Encoder>
    total += USIZE  # vec length
    for c in model.components:
        total += USIZE              # table vec length
        total += 8 * len(c.freqs)   # EncoderModelEntry = u32 + u16 + u16
        total += 3 * USIZE          # frame_size, radix, fidelity
        total += 2 * 8              # folding_threshold, folding_offset
    # stream: Vec<u16>
    total += USIZE + 2 * stream_len
    # state: u32, number_of_nodes/compression_window/min_interval: usize,
    # number_of_arcs: u64
    total += 4 + 3 * USIZE + 8
    return total
