"""Collision recovery by successive interference cancellation (SIC).

PyTorch counterpart of ``gen2_rfid_tpu/dsp/collision.py``.  A window that
holds two (or more) superposed tag replies is separated pass by pass:

1. decode the dominant reply with the standard coherent slicer (FM0 or
   Miller, dispatched as the batch decode does);
2. re-synthesize its matched-filtered waveform from its chip train (closed
   form: FM0's level recursion is a cumulative XOR, Miller's phase a pair of
   cumulative sums) over a bank of timing hypotheses (``N_SHIFTS`` integer
   decim-sample shifts x ``decim`` ADC phases), least-squares fit the
   complex amplitude of the best hypothesis and subtract it;
3. decode the residual.

``rn16_sic`` does this once on an RN16 window.  ``rn16_sic_n`` and
``epc_sic`` re-fit the complex amplitudes of every template found so far
jointly against the original window after each pass (a (k+1)^2 Gram
system); ``epc_sic`` decodes 128-bit EPC frames, each judged by its CRC-16.

Every function takes a batch of windows (E, W) complex64, the JAX package's
``vmap`` axis; ``rn16_sic``, ``rn16_sic_n`` and ``epc_sic`` are the E = 1
case.  The template bank (chips x hypotheses x window samples) is the JAX
package's numpy table; a frame's bank is its 0/1 chips times that table, a
float32 matmul of small integers, exact at any precision.  The hypothesis
projections and the Gram system's right-hand sides are float32 contractions
of signal values, which TF32 would change: these functions raise on CUDA
while ``torch.backends.cuda.matmul.allow_tf32`` is set, and the entry point
``runtime/recovery.py::recover_epc_collisions`` clears it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import TAG_PREAMBLE_BITS_PATTERN, ReaderConfig
from ..runtime.inventory import check_epc_crc_batch
from . import fm0, miller, sync

N_SHIFTS = 7          # integer decim-sample alignment hypotheses
_I32 = torch.int32
_F32 = torch.float32


class SicResult(NamedTuple):
    """``rn16_sic`` per window (a leading (E,) axis from the batch)."""

    bits1: torch.Tensor         # (16,) int32 dominant tag's RN16
    bits2: torch.Tensor         # (16,) int32 the residual's RN16
    h1: torch.Tensor            # () complex64 LS amplitude of tag 1 (per chip)
    h1_sync: torch.Tensor       # () complex64 pass-1 preamble estimate
    h2: torch.Tensor            # () complex64 preamble estimate of tag 2
    margin1: torch.Tensor       # () float32 slicer margin of pass 1
    margin2: torch.Tensor       # () float32 slicer margin of pass 2
    cancel_ratio: torch.Tensor  # () float32 energy removed / window energy


class EpcSicResult(NamedTuple):
    """``epc_sic`` per window (a leading (E,) axis from the batch)."""

    bits: torch.Tensor     # (n_tags, 128) int32 recovered frames, detection order
    crc_ok: torch.Tensor   # (n_tags,) bool CRC-16 verdict per frame
    h_sync: torch.Tensor   # (n_tags,) complex64 preamble channel estimates
    cancel: torch.Tensor   # (n_tags,) float32 cumulative energy removed


def _check_tf32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("SIC needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _rows(bits: torch.Tensor) -> torch.Tensor:
    return bits[None] if bits.dim() == 1 else bits


def fm0_chip_train(bits: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    """Preamble (after the TRext pilot tone) + FM0 half-bit chips (0/1) of
    each row's payload + dummy 1 (collision.py:67-88): first chip of bit i
    is the XOR of the bits before it, the second the complement of the XOR
    up to it.  (E, n) or (n,) -> (E, n_chips) or (n_chips,) int32."""
    b = _rows(bits).to(_I32)
    e = b.shape[0]
    b = torch.cat([b, b.new_ones((e, 1))], dim=1)
    cx = torch.cumsum(b, 1, dtype=_I32) % 2
    first = torch.cat([cx.new_zeros((e, 1)), cx[:, :-1]], dim=1)
    data = torch.stack([first, 1 - cx], dim=-1).reshape(e, -1)
    pre = np.asarray(TAG_PREAMBLE_BITS_PATTERN, np.int32)
    if cfg.trext:
        pre = np.concatenate([np.tile([1, 0], cfg.pilot_tone_bits).astype(np.int32), pre])
    out = torch.cat([torch.as_tensor(pre, device=b.device).expand(e, -1), data], dim=1)
    return out if bits.dim() == 2 else out[0]


def miller_chip_train(bits: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    """Preamble + Miller-M chips (0/1) of each row's payload + dummy 1
    (collision.py:91-116): bit i's baseband phase flips with every data 1
    before it and every 0 that follows a 0, times the M-cycle subcarrier,
    with the second half of every data 1 inverted."""
    m = cfg.miller_m
    b = _rows(bits).to(_I32)
    e = b.shape[0]
    n_spin = 16 if cfg.trext else 4
    pre = torch.as_tensor(np.array([0] * n_spin + [0, 1, 0, 1, 1, 1], np.int32),
                          device=b.device).expand(e, -1)
    seq = torch.cat([pre, b, b.new_ones((e, 1))], dim=1)
    prev = torch.cat([seq.new_ones((e, 1)), seq[:, :-1]], dim=1)
    inv = ((seq == 0) & (prev == 0)).to(_I32)
    ones_before = torch.cat([seq.new_zeros((e, 1)),
                             torch.cumsum(seq, 1, dtype=_I32)[:, :-1]], dim=1)
    flips = (torch.cumsum(inv, 1, dtype=_I32) + ones_before) % 2
    phase = 1 - 2 * flips                                        # (E, n_bits) +-1
    sub = torch.as_tensor(np.tile([1, -1], m).astype(np.int32), device=b.device)
    half2 = torch.arange(2 * m, device=b.device) >= m
    halfflip = torch.where((seq == 1)[:, :, None] & half2, -1, 1).to(_I32)
    out = ((phase[:, :, None] * sub * halfflip).reshape(e, -1) + 1) // 2
    return out if bits.dim() == 2 else out[0]


def chip_train(bits: torch.Tensor, cfg: ReaderConfig) -> torch.Tensor:
    return (fm0_chip_train(bits, cfg) if cfg.miller_m == 1
            else miller_chip_train(bits, cfg))


@functools.lru_cache(maxsize=8)
def _template_bank(cfg: ReaderConfig, n_bits: int = 16):
    """(n_chips, C*L) float32 basis (collision.py:124-176): column c*L+k is
    the matched-filtered response at window sample k of a unit chip under
    timing hypothesis c = (shift s, ADC phase phi).  Chip hb covers ADC
    [round(phi + s*decim + hb*chip_adc), round(.. + (hb+1)*chip_adc)) of the
    slice, as ``sim.tag.superpose_reply`` rounds its edges, and window
    sample k integrates ADC (k*decim - (t-1) .. k*decim].  Returns (basis,
    C, L, shift0): the slice starts shift0 = -(round(taps/decim) + 3)
    samples before the reply start the sync implies."""
    decim = cfg.decim
    m = cfg.miller_m
    t = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / m)      # MF taps
    chip_adc = cfg.tag_bit_us / (2 * m) * cfg.adc_rate / 1e6
    if m == 1:
        n_chips = 2 * cfg.tag_preamble_bits + 2 * (n_bits + 1)
        if cfg.trext:
            n_chips += 2 * cfg.pilot_tone_bits
    else:
        n_spin = 16 if cfg.trext else 4
        n_chips = (n_spin + 6 + n_bits + 1) * 2 * m
    shift0 = -(max(int(round(t / decim)), 1) + 3)
    a_hyp_max = (N_SHIFTS - 1) * decim + (decim - 1)
    a_max = a_hyp_max + int(round(n_chips * chip_adc)) + 1
    l_win = (a_max + t - 1) // decim + 2
    c_hyp = N_SHIFTS * decim
    p = np.zeros((n_chips, c_hyp, l_win), dtype=np.float32)
    k_idx = np.arange(n_chips + 1, dtype=np.float64)
    for s in range(N_SHIFTS):
        for phi in range(decim):
            edges = np.round(phi + s * decim + k_idx * chip_adc).astype(np.int64)
            for hb in range(n_chips):
                a0, a1 = int(edges[hb]), int(edges[hb + 1])
                for k in range(max(a0 // decim, 0), min((a1 + t - 1) // decim + 1, l_win - 1) + 1):
                    lo = k * decim - (t - 1)
                    ov = min(k * decim + 1, a1) - max(lo, a0)
                    if ov > 0:
                        p[hb, s * decim + phi, k] = ov
    return p.reshape(n_chips, c_hyp * l_win), c_hyp, l_win, shift0


@functools.lru_cache(maxsize=8)
def _bank_device(cfg: ReaderConfig, n_bits: int, device: torch.device):
    """The template basis on a device, kept for the next call (51.5 MB for
    ReaderConfig's EPC frames)."""
    p, c_hyp, l_win, shift0 = _template_bank(cfg, n_bits)
    return torch.as_tensor(p, device=device), c_hyp, l_win, shift0


def _fm0_b0(cfg: ReaderConfig) -> int:
    """Samples from the FM0 reply start to the sync's data index: preamble,
    the half-bit shift and the TRext pilot tone (collision.py:195-204)."""
    b0 = sync.data_shift(cfg)
    if cfg.trext:
        b0 += int(round(cfg.pilot_tone_bits * cfg.n_samples_tag_bit))
    return b0


def _sync_rn16(frames: torch.Tensor, cfg: ReaderConfig):
    """(data index, h, bits, margin, b0) of each window's dominant RN16
    (collision.py:179-192); b0 is the preamble span before the index."""
    if cfg.miller_m == 1:
        idx, h = sync.tag_sync(frames, cfg)
        bits, margin = fm0.rn16_detect_soft(frames, idx, h, cfg)
        return idx, h, bits, margin, _fm0_b0(cfg)
    idx, h, eps = miller.miller_sync_full(frames, cfg)
    bits, margin = miller.miller_rn16_soft(frames, idx, h, cfg, eps0=eps)
    return idx, h, bits, margin, miller.preamble_len_samples(cfg)


def _sync_epc(frames: torch.Tensor, cfg: ReaderConfig):
    """(data index, h, bits (E, 128), b0) of each window's dominant EPC frame
    (collision.py:270-288): FM0's period grid, or Miller's cascade."""
    if cfg.miller_m == 1:
        idx, h = sync.tag_sync(frames, cfg)
        m2 = (frames.real ** 2 + frames.imag ** 2).to(_F32)
        bits, _, _ = fm0.epc_detect_soft(frames, m2, idx, h, cfg)
        return idx, h, bits, _fm0_b0(cfg)
    idx, h, eps = miller.miller_sync_full(frames, cfg)
    bits, _ = miller.miller_epc(frames, idx, h, cfg, eps0=eps)
    return idx, h, bits, miller.preamble_len_samples(cfg)


def _best_template(frames: torch.Tensor, bits: torch.Tensor, idx: torch.Tensor, b0: int,
                   n_bits: int, cfg: ReaderConfig):
    """The LS-best hypothesis of each window's template bank
    (collision.py:217-236, 308-317): its window positions (E, L), samples
    xw (E, L) complex, template (E, L) and amplitude (E,) complex."""
    _check_tf32(frames.device)
    basis, c_hyp, l_win, shift0 = _bank_device(cfg, n_bits, frames.device)
    e, w = frames.shape
    if w < l_win:
        raise ValueError(f"SIC: windows of {w} samples, the template bank spans {l_win}")
    bank = torch.matmul(chip_train(bits, cfg).to(_F32), basis).reshape(e, c_hyp, l_win)
    # The slice's start, clamped into the window as dynamic_slice clamps it.
    start = torch.clamp(idx.to(torch.int64) - b0 + shift0, 0, w - l_win)
    pos = start[:, None] + torch.arange(l_win, device=frames.device)
    xw = frames.gather(1, pos)
    pr = torch.matmul(bank, xw.real[:, :, None])[:, :, 0]         # (E, C)
    pi = torch.matmul(bank, xw.imag[:, :, None])[:, :, 0]
    tt = torch.clamp((bank * bank).sum(dim=2), min=1e-20)
    best = torch.argmax((pr ** 2 + pi ** 2) / tt, dim=1)[:, None]  # explained energy
    tpl = bank.gather(1, best[:, :, None].expand(e, 1, l_win))[:, 0]
    ttb = tt.gather(1, best)[:, 0]
    alpha = torch.complex(pr.gather(1, best)[:, 0] / ttb, pi.gather(1, best)[:, 0] / ttb)
    return pos, xw, tpl, alpha


def rn16_sic_batch(frames: torch.Tensor, cfg: ReaderConfig) -> SicResult:
    """Recover two superposed RN16 replies from each DC-corrected window
    (collision.py:207-267): pass 1 decodes the dominant tag, its LS-fitted
    template is subtracted, pass 2 decodes the residual.  frames (E, W)."""
    idx1, h1c, bits1, margin1, b0 = _sync_rn16(frames, cfg)
    pos, xw, tpl, alpha = _best_template(frames, bits1, idx1, b0, 16, cfg)
    res = torch.complex(xw.real - alpha.real[:, None] * tpl, xw.imag - alpha.imag[:, None] * tpl)
    r = frames.scatter(1, pos, res)
    e_before = (xw.real ** 2 + xw.imag ** 2).sum(dim=1)
    e_after = (res.real ** 2 + res.imag ** 2).sum(dim=1)
    cancel_ratio = 1.0 - e_after / torch.clamp(e_before, min=1e-20)
    _, h2c, bits2, margin2, _ = _sync_rn16(r, cfg)
    return SicResult(bits1=bits1, bits2=bits2, h1=alpha, h1_sync=h1c, h2=h2c,
                     margin1=margin1, margin2=margin2, cancel_ratio=cancel_ratio)


def _detect_template(frames: torch.Tensor, cfg: ReaderConfig, kind: str):
    """(bits, margin, h_sync, template in window coordinates (E, W) float32)
    of each window's dominant reply (collision.py:291-320); kind "rn16" or
    "epc" (margin 0: the CRC judges EPC frames)."""
    if kind == "epc":
        n_bits = cfg.epc_data_bits
        idx, h, bits, b0 = _sync_epc(frames, cfg)
        margin = torch.zeros(frames.shape[0], dtype=_F32, device=frames.device)
    else:
        n_bits = 16
        idx, h, bits, margin, b0 = _sync_rn16(frames, cfg)
    pos, _, tpl, _ = _best_template(frames, bits, idx, b0, n_bits, cfg)
    tpl_full = torch.zeros(frames.shape, dtype=_F32, device=frames.device).scatter(1, pos, tpl)
    return bits, margin, h, tpl_full


def _joint_sic(frames: torch.Tensor, cfg: ReaderConfig, n_tags: int, kind: str):
    """Passes of detection with a joint amplitude re-fit (collision.py:
    339-361, 393-411): after pass k every template so far is re-fitted by
    least squares against the original window, (k+1)^2 Gram system and
    all, and the residual is the window less their sum.  Returns the
    per-pass (bits, h_sync, margin, cancel) stacked on axis 1."""
    xr0, xi0 = frames.real, frames.imag
    e0 = torch.clamp((xr0 ** 2 + xi0 ** 2).sum(dim=1), min=1e-20)
    bits_all, h_all, margin_all, cancel_all, templates = [], [], [], [], []
    r = frames
    for k in range(n_tags):
        bits, margin, h_sync, tpl = _detect_template(r, cfg, kind)
        templates.append(tpl)
        t = torch.stack(templates, dim=1)                           # (E, k+1, W)
        g = torch.matmul(t, t.transpose(1, 2)) + 1e-12 * torch.eye(k + 1, device=t.device)
        # solve_ex: no host sync, and a singular system (two identical
        # templates, a window of zeros) gives non-finite amplitudes as
        # jnp.linalg.solve does, without raising.
        a_re = torch.linalg.solve_ex(g, torch.matmul(t, xr0[:, :, None]))[0]
        a_im = torch.linalg.solve_ex(g, torch.matmul(t, xi0[:, :, None]))[0]
        rr = xr0 - torch.matmul(a_re.transpose(1, 2), t)[:, 0]
        ri = xi0 - torch.matmul(a_im.transpose(1, 2), t)[:, 0]
        r = torch.complex(rr, ri)
        bits_all.append(bits)
        h_all.append(h_sync)
        margin_all.append(margin)
        cancel_all.append(1.0 - (rr ** 2 + ri ** 2).sum(dim=1) / e0)
    return tuple(torch.stack(v, dim=1) for v in (bits_all, h_all, margin_all, cancel_all))


def rn16_sic_n_batch(frames: torch.Tensor, cfg: ReaderConfig, n_tags: int = 3):
    """N-way RN16 separation with the joint re-fit (collision.py:323-361).
    Returns (bits (E, n_tags, 16), h_sync (E, n_tags), margin (E, n_tags),
    cancel (E, n_tags)) in detection order; callers judge each pass by its
    margin and cancel increments."""
    return _joint_sic(frames, cfg, n_tags, "rn16")


def epc_sic_batch(frames: torch.Tensor, cfg: ReaderConfig, n_tags: int = 2) -> EpcSicResult:
    """Recover superposed EPC frames from each ACK window (collision.py:
    371-418): tags that drew the same RN16 both answer the ACK.  Pass 1 on
    the original window is the plain EPC decode; every pass's frame is
    judged by its CRC-16."""
    bits, h_sync, _, cancel = _joint_sic(frames, cfg, n_tags, "epc")
    e, k, nb = bits.shape
    crc_ok = check_epc_crc_batch(bits.reshape(e * k, nb)).reshape(e, k)
    return EpcSicResult(bits=bits, crc_ok=crc_ok, h_sync=h_sync, cancel=cancel)


def _one(result):
    return type(result)(*(v[0] for v in result))


def rn16_sic(frame: torch.Tensor, cfg: ReaderConfig) -> SicResult:
    """``rn16_sic_batch`` of one (W,) window."""
    return _one(rn16_sic_batch(frame[None], cfg))


def rn16_sic_n(frame: torch.Tensor, cfg: ReaderConfig, n_tags: int = 3):
    """``rn16_sic_n_batch`` of one (W,) window."""
    return tuple(v[0] for v in rn16_sic_n_batch(frame[None], cfg, n_tags))


def epc_sic(frame: torch.Tensor, cfg: ReaderConfig, n_tags: int = 2) -> EpcSicResult:
    """``epc_sic_batch`` of one (W,) window."""
    return _one(epc_sic_batch(frame[None], cfg, n_tags))
