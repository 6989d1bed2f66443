"""Multi-channel (antenna-diversity) capture decode: the MRC pipeline.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/diversity.py``.  C
time-aligned RX channels of the same air interface decode coherently
(dsp/mrc.py): the gate triggers on the channel-summed envelope, windows are
gathered and DC-corrected per channel, and every detection statistic
combines the channels.  Every event is decoded as both windows, as compat
mode does.

On the capture's device: one ``gate_front`` launch a channel (its y build)
gives y; the envelope sqrt(Σ_c |y_c|^2) and its windowed average feed
``gate_detect`` (native mode: ``native_flags_from_amp``, not the gate-stack
kernel, whose amplitude is one y's |y|).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import ReaderConfig
from ..dsp import mrc
from ..dsp.filters import moving_sum, run_sum, window_mean
from ..dsp.gate import _event_window_stats, gate_detect
from ..kernels.gate_front import gate_front_y_for_cfg
from .frames import gather_aligned_windows_multi
from .inventory import (DecodedEvents, _tag_ids, check_epc_crc_batch, classify_commands,
                        classify_slots, replay_inventory, resolve_device, to_planar)
from .stats import InventoryStats

_F32 = torch.float32


def decode_capture_mrc_planar(iq2c, cfg: ReaderConfig, device=None
                              ) -> Tuple[InventoryStats, DecodedEvents, torch.Tensor]:
    """iq2c: (C, 2, N) float32 planar ADC captures, one per RX channel,
    time-aligned (diversity.py:35-113).  Runs on CUDA unless ``device``
    says otherwise.

    Returns (stats, events, h_chan), h_chan (E, C, 2) float32: each event's
    channel estimate per antenna, which ``runtime/ranging.py::aoa_from_mrc``
    turns into an angle of arrival.  DecodedEvents.h_est is channel 0's."""
    if cfg.miller_m != 1:
        raise ValueError("the MRC decode is FM0 only (miller_m == 1)")
    dev = resolve_device(device)
    x = torch.as_tensor(iq2c, dtype=_F32).to(dev)
    c = x.shape[0]
    y2 = [gate_front_y_for_cfg(x[k].contiguous(), cfg) for k in range(c)]
    ys = torch.stack([torch.complex(v[0], v[1]) for v in y2])      # (C, n)
    n = ys.shape[1]

    # Gate on the channel-summed power envelope, its sum and root rounded
    # as filters.magnitude rounds (commands are TX leak, seen on every
    # channel; replies add non-coherently).
    p = y2[0][0] * y2[0][0] + y2[0][1] * y2[0][1]
    for v in y2[1:]:
        p = p + (v[0] * v[0] + v[1] * v[1])
    amp = torch.sqrt(p.to(torch.float64)).to(_F32)
    msum = moving_sum(amp, cfg.win_length) if cfg.mode == "compat" else run_sum(amp, cfg.win_length)
    avg = window_mean(msum, cfg.win_length)
    events = gate_detect(ys[0], cfg, amp=amp, avg=avg)
    cmd = classify_commands(events.n_pulses, cfg)
    ev_c = torch.clamp(events.index, max=n - 1)
    dcs, nvs = _event_window_stats(ys, ev_c, cfg.dc_length)          # (C, E) each

    w = cfg.epc_window
    e = events.index.shape[0]
    chans = torch.arange(c, device=dev).repeat_interleave(e)
    frames = (gather_aligned_windows_multi(ys, events.index.repeat(c), chans, w)
              - dcs.reshape(-1)[:, None]).reshape(c, e, -1).transpose(0, 1)   # (E, C, W+g)
    magn2 = (frames.real ** 2 + frames.imag ** 2).to(_F32)

    index, h = mrc.tag_sync_mrc(frames, cfg)                          # (E,), (E, C)
    rn16_bits, margin = mrc.rn16_detect_mrc(frames, index, h, cfg)
    epc_bits, t_half = mrc.epc_detect_mrc(frames, magn2, index, h, cfg)
    energy = mrc.chan_sum(magn2[:, :, : cfg.rn16_window]).mean(dim=1)
    h2 = mrc.chan_sum(h.real ** 2 + h.imag ** 2)
    nv_sum = mrc.chan_sum(nvs.transpose(0, 1))
    dec = DecodedEvents(
        index=events.index,
        valid=events.valid,
        rn16_fits=events.valid & (events.index + cfg.rn16_window <= n),
        epc_fits=events.valid & (events.index + w <= n),
        rn16_bits=rn16_bits,
        epc_bits=epc_bits,
        epc_pass=check_epc_crc_batch(epc_bits),
        tag_id=_tag_ids(epc_bits),
        t_half=t_half,
        h_est=torch.stack([h[:, 0].real, h[:, 0].imag], dim=-1),
        slot_state=classify_slots(energy, margin, nv_sum, h2),
        rn16_energy=energy,
        rn16_margin=margin,
        cmd_type=cmd,
    )
    h_chan = torch.stack([h.real, h.imag], dim=-1)                    # (E, C, 2)
    return replay_inventory(dec, cfg), dec, h_chan


def decode_capture_mrc_full(iq_channels, cfg: ReaderConfig, device=None
                            ) -> Tuple[InventoryStats, DecodedEvents, torch.Tensor]:
    """``decode_capture_mrc_planar`` of a sequence of complex (N,) host
    captures, one per RX channel: (stats, events, h_chan)."""
    return decode_capture_mrc_planar(torch.stack([to_planar(x) for x in iq_channels]), cfg,
                                     device)


def decode_capture_mrc(iq_channels, cfg: ReaderConfig, device=None
                       ) -> Tuple[InventoryStats, DecodedEvents]:
    """(stats, events) of ``decode_capture_mrc_full``."""
    return decode_capture_mrc_full(iq_channels, cfg, device)[:2]
