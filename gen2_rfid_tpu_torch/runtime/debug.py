"""Per-stage debug taps (reference: file sinks on every block +
plot_signal.m, ``apps/reader.py:68-72,98-118``, ``misc/code/plot_signal.m``).

PyTorch counterpart of ``gen2_rfid_tpu/runtime/debug.py``.
``decode_capture_debug`` runs the pipeline stage by stage with the port's
stage functions and returns every intermediate array as numpy on the host,
with the JAX function's tap names and dtypes; ``save_taps`` dumps them as
.npy (the numpy analogue of the reference's raw-I/Q file sinks).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.filters import magnitude, matched_filter_decimate, moving_sum, window_mean
from ..dsp.gate import gate_detect
from .inventory import decode_events, matched_taps, replay_inventory, resolve_device


def decode_capture_debug(iq, cfg: ReaderConfig, device=None) -> Dict[str, np.ndarray]:
    """Decode with per-stage taps: source, matched filter, gate, decoder
    (debug.py:23-59), on CUDA unless ``device`` says otherwise.

    Mirrors the reference's tap points: ``file_sink_source`` (raw),
    ``file_sink_matched_filter`` (post-FIR), ``file_sink_gate`` (DC-corrected
    windows), ``file_sink_decoder`` (per-frame decode inputs).  The gate is
    the pipeline's: native mode flags y itself (the gate-stack kernel on
    CUDA), compat mode reads the |y| and average tapped here."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.array(iq, np.complex64)).to(dev)
    y = matched_filter_decimate(x, matched_taps(cfg), cfg.decim)
    amp = magnitude(y.real, y.imag)
    avg = window_mean(moving_sum(amp, cfg.win_length), cfg.win_length)
    if cfg.mode == "compat":
        events = gate_detect(y, cfg, amp=amp, avg=avg)
    else:
        events = gate_detect(y, cfg)
    dec = decode_events(y, events, cfg)
    stats = replay_inventory(dec, cfg)

    def host(t):
        return t.cpu().numpy()

    valid = host(events.valid)
    dvalid = host(dec.valid)
    avg_h = host(avg)
    return {
        "source": host(x),
        "matched_filter": host(y),
        "amplitude": host(amp),
        "moving_avg": avg_h,
        "threshold": avg_h * cfg.thresh_fraction,
        "gate_events": host(events.index)[valid],
        "gate_dc": host(events.dc)[valid],
        "gate_noise_var": host(events.noise_var)[valid],
        "rn16_bits": host(dec.rn16_bits)[dvalid],
        "epc_bits": host(dec.epc_bits)[dvalid],
        "epc_pass": host(dec.epc_pass)[dvalid],
        "slot_state": host(dec.slot_state)[dvalid],
        "stats_n_queries": host(stats.n_queries),
        "stats_n_epc_correct": host(stats.n_epc_correct),
        "stats_tag_reads": host(stats.tag_reads),
    }


def save_taps(taps: Dict[str, np.ndarray], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in taps.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
