"""Per-slot window decode for the live loop.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/live_decode.py``.
``_window_decoder`` is the lru-cached decode program (one per (config,
mode, device)): the fused front end (kernels/gate_front.py), the gate on
the gate-stack kernel's flags (kernels/gate_stack.py), the newest command
event's window, and the mode's sync and detection, all on the device, with
every output packed into one float32 vector that reaches the host in one
copy.  ``SlotDecodeMixin`` carries the RX context tail between exchanges,
pads blocks to a few stable shapes and classifies slots with the batch
thresholds.  See runtime/live.py for the loop that drives it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.filters import magnitude


@dataclasses.dataclass
class _RnResult:
    bits: np.ndarray
    energy: float
    margin: float
    h2: float
    noise_var: float
    # SIC mode (mode="sic"): the residual's second decoded RN16 + quality.
    bits2: Optional[np.ndarray] = None
    margin2: float = 0.0
    cancel_ratio: float = 0.0


def _power(frames: torch.Tensor) -> torch.Tensor:
    """|frames|^2 from |.| correctly rounded, as the port takes it (the JAX
    package squares ``jnp.abs``)."""
    return magnitude(frames.real, frames.imag) ** 2


def _pack(*parts) -> torch.Tensor:
    """One float32 vector of scalars and bit rows: bits and flags are 0/1 and
    every float is float32, so each value survives exactly."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


@functools.lru_cache(maxsize=None)
def _window_decoder(cfg: ReaderConfig, mode: str, device: torch.device):
    """The per-slot window decode (live_decode.py:35-144): a function of a
    planar (2, L) float32 block on ``device`` that returns one packed
    float32 vector (see ``SlotDecodeMixin._decode_window`` for its layout).

    mode: "rn16" | "epc" | "sic" (the RN16 window through
    dsp/collision.py::rn16_sic_batch, whose pass 1 is the plain decode) |
    "epc_sic" (the EPC window through ``epc_sic_batch``: both frames of two
    tags that drew the same RN16, each judged by its CRC-16) | "acc:<n>"
    (an n-bit access-command reply; its CRC is checked on the host).

    The block goes through the capture decode's front end
    (dsp/gate.py::front_end): native mode gates on the gate-stack kernel's
    flags of the y build's y, compat on the full build's |y| and windowed
    average, so each decode launches ``gate_front`` once and, in native
    mode, ``gate_stack`` once.  The window starts at the newest valid
    event, clamped into the block as ``lax.dynamic_slice`` clamps; every
    detector takes a batch of one."""
    from ..dsp import fm0, miller, sync
    from ..dsp.collision import epc_sic_batch, rn16_sic_batch
    from ..dsp.gate import front_end, gate_detect
    from .inventory import _validate_epc_soft

    ev_cfg = dataclasses.replace(cfg, max_events=8)
    want_epc = mode in ("epc", "epc_sic")
    acc_bits = int(mode.split(":")[1]) if mode.startswith("acc:") else 0
    if acc_bits:
        w = cfg.reply_window(acc_bits)
    else:
        w = cfg.epc_window if want_epc else cfg.rn16_window
    offsets = torch.arange(w, device=device)

    def run(block2: torch.Tensor) -> torch.Tensor:
        y, flags, amp, avg = front_end(block2, cfg)
        ev = gate_detect(y, ev_cfg, flags, amp, avg)
        # Newest command event (invalid slots hold index n, so mask first).
        ny = y.shape[0]
        idx_arr = torch.where(ev.valid, ev.index, -1)
        pos = torch.argmax(idx_arr)
        idx = torch.clamp(idx_arr[pos], min=0)
        fits = ev.valid.any() & (idx + w <= ny)
        start = torch.clamp(torch.clamp(idx, max=ny - w), min=0)
        frames = (y[start + offsets] - ev.dc[pos])[None]
        if acc_bits:
            if cfg.miller_m == 1:
                di, h = sync.tag_sync(frames, cfg)
                bits = fm0.payload_detect(frames, di, h, cfg, acc_bits)
            else:
                di, h, eps = miller.miller_sync_full(frames, cfg)
                bits = miller.miller_detect(frames, di, h, cfg, acc_bits, eps0=eps)[0]
            return _pack(fits, bits)
        if mode == "epc_sic":
            r = epc_sic_batch(frames, cfg, n_tags=2)
            return _pack(fits, r.bits[0, 0], r.crc_ok[0, 0], r.bits[0, 1], r.crc_ok[0, 1])
        if mode == "sic":
            r = rn16_sic_batch(frames, cfg)
            energy = _power(frames[0, : cfg.rn16_window]).mean()
            # Post-MF-scale channel power (the classifier's normalization).
            h1sq = r.h1_sync.real ** 2 + r.h1_sync.imag ** 2
            return _pack(fits, r.bits1, r.margin1, energy, h1sq, ev.noise_var[pos],
                         r.bits2, r.margin2, r.cancel_ratio)
        if cfg.miller_m == 1:
            di, h = sync.tag_sync(frames, cfg)
            if want_epc:
                bits, _, rel = fm0.epc_detect_soft(frames, _power(frames), di, h, cfg)
            else:
                bits, margin = fm0.rn16_detect_soft(frames, di, h, cfg)
        else:
            di, h, eps = miller.miller_sync_full(frames, cfg)
            if want_epc:
                bits, _, rel = miller.miller_epc_soft(frames, di, h, cfg, eps0=eps)
            else:
                bits, margin = miller.miller_rn16_soft(frames, di, h, cfg, eps0=eps)
        if want_epc:
            # Mode-aware validation (+ CRC-guided soft recovery when
            # cfg.epc_softfix is set, which alone reads rel); h rides out
            # planar: the per-read phase observable.
            okv, _, bitsv = _validate_epc_soft(bits, rel, cfg)
            return _pack(fits, bitsv[0], okv[0], h.real, h.imag)
        energy = _power(frames[0, : cfg.rn16_window]).mean()
        h2 = h.real ** 2 + h.imag ** 2
        return _pack(fits, bits, margin, energy, h2, ev.noise_var[pos])

    return run


class SlotDecodeMixin:
    """Carried-context per-slot decoding: the live loop's bridge to the
    batch DSP primitives (host side of `_window_decoder`).  The class that
    mixes it in sets ``self.device``."""

    # ADC samples per live block-shape bucket: PIE command waveforms vary
    # with the bit values (data-1 is 2x data-0, reader_impl.cc:55-56), so
    # un-bucketed blocks take a fresh shape almost every ACK.  Zero-padding
    # up to the bucket keeps the handful of shapes stable (trailing zeros
    # sit after the reply window and decode as silence).
    BLOCK_BUCKET = 512

    def _reset_ctx(self) -> None:
        """Zero (not empty) context keeps block shapes stable across
        power-down resets."""
        self._ctx = np.zeros(self._ctx_len, np.complex64)

    def _decode_window(self, rx: np.ndarray, mode: str):
        block = np.concatenate([self._ctx, rx])
        self._ctx = block[-self._ctx_len:]
        pad = -len(block) % self.BLOCK_BUCKET
        padded = np.concatenate([block, np.zeros(pad, block.dtype)])
        self._block_shapes.add((len(padded), mode))
        block2 = np.stack([padded.real, padded.imag]).astype(np.float32)
        x2 = torch.from_numpy(block2).to(self.device)
        # The decode's one device-to-host copy.
        out = _window_decoder(self.cfg, mode, self.device)(x2).cpu().numpy()
        if not out[0]:
            return None
        if mode.startswith("acc:"):
            return out[1:].astype(np.int32)
        if mode == "epc":
            # fits, bits (nb), ok, h re, h im
            nb = len(out) - 4
            return (out[1: 1 + nb].astype(np.int32), bool(out[1 + nb]),
                    complex(float(out[2 + nb]), float(out[3 + nb])))
        if mode == "epc_sic":
            # fits, bits (nb), ok, bits2 (nb), ok2
            nb = (len(out) - 3) // 2
            return (out[1: 1 + nb].astype(np.int32), bool(out[1 + nb]),
                    out[2 + nb: 2 + 2 * nb].astype(np.int32), bool(out[2 + 2 * nb]))
        # fits, bits (16), margin, energy, h2, noise_var[, bits2 (16), margin2, cancel]
        r = _RnResult(
            bits=out[1:17].astype(np.int32),
            margin=float(out[17]),
            energy=float(out[18]),
            h2=float(out[19]),
            noise_var=float(out[20]),
        )
        if mode == "sic":
            r.bits2 = out[21:37].astype(np.int32)
            r.margin2 = float(out[37])
            r.cancel_ratio = float(out[38])
        return r

    def _classify(self, rn: Optional[_RnResult]) -> int:
        """Live slot state via the batch classifier's thresholds
        (runtime.inventory.classify_slots) on 0-d float32 CPU tensors, so
        every threshold compares in float32 as the JAX package's does."""
        from .inventory import SLOT_EMPTY, classify_slots

        if rn is None:
            return SLOT_EMPTY

        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        return int(classify_slots(f32(rn.energy), f32(rn.margin), f32(rn.noise_var),
                                  f32(rn.h2)))
