"""SIC collision-recovery envelope, on the port.

    python -m gen2_rfid_tpu_torch.tools.sic_sweep [--device cpu] [--ratios 0.1 ...]
        [--trials N] [--epc]

Twin of ``tools/sic_sweep.py``.  ``main`` sweeps RN16 pairs: the rate at
which ``dsp/collision.py::rn16_sic`` recovers both tags' RN16s over
amplitude ratio |h2|/|h1| (5) x T1 offset (3) x the weaker tag's SNR (2),
12 trials a cell.  With ``--epc`` it runs ``epc_sweep``: the rate at which
``epc_sic`` returns both same-RN16 EPC frames with passing CRCs over
ratio (4) x T1 offset (2) x noise (2), 8 trials a cell.  ``--ratios`` and
``--trials`` narrow the grid.  Prints the JAX tool's markdown tables.

Each window is the JAX tool's: the replies superposed on a unit carrier
(``sim/tag.py::superpose_reply``), AWGN, the 25-tap boxcar matched filter
with decimation (the port's ``dsp/filters.py::matched_filter_decimate``
on the device), then the DC mean over y[300:348] and the slice at the reply
in numpy.  The port's filter sums its taps in another order than XLA's
convolution (the windows differ by up to 1.1e-5 of about 2.6), so a trial
on the edge of a verdict could differ from the JAX tool's.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.collision import epc_sic, rn16_sic
from ..dsp.filters import boxcar_taps, matched_filter_decimate
from ..runtime.inventory import resolve_device
from ..sim.tag import Tag, fm0_chips, superpose_reply
from .sweep import add_device_flag, sweep_device, wall_time

CFG = ReaderConfig()
SP_US = CFG.adc_rate / 1e6
RATIOS = (1.0, 0.7, 0.4, 0.2, 0.1)
DT1S = (0.0, 2.5, 5.0)          # us of T1 offset between the two tags
SNRS = (30.0, 15.0)
N_TRIALS = 12
BS1 = 0.08 + 0.03j
EPC_RATIOS = (1.0, 0.7, 0.4, 0.15)
EPC_DTS = (0.0, 2.5)
EPC_NOISES = (0.004, 0.02)
EPC_TRIALS = 8


def _awgn(x: np.ndarray, noise: float, rng) -> np.ndarray:
    return x + (rng.normal(0, noise / 2 ** 0.5, x.size)
                + 1j * rng.normal(0, noise / 2 ** 0.5, x.size)).astype(np.complex64)


def matched_window(x: np.ndarray, n_window: int, device=None) -> torch.Tensor:
    """The decode window of an ADC-rate capture (tools/sic_sweep.py:38-42):
    the matched filter on the device, the DC mean and the slice in numpy."""
    dev = resolve_device(device)
    y = matched_filter_decimate(torch.from_numpy(x).to(dev), boxcar_taps(25),
                                CFG.decim).cpu().numpy()
    dc = y[300:348].mean()
    start = 400 + int(round(252.5 * SP_US)) // 5 - 4
    return torch.from_numpy(y[start:start + n_window + 8] - dc).to(dev)


def rn16_capture(tags, noise: float, rng) -> np.ndarray:
    """Two RN16 replies on a unit carrier, with AWGN (tools/sic_sweep.py:27-37)."""
    n = int(round((CFG.t1_us + CFG.t2_us + CFG.rn16_us) * SP_US)) + 4000
    seg = np.full(n, 1.0, dtype=np.complex64)
    for bits, bs, t1 in tags:
        superpose_reply(seg, fm0_chips(bits), t1, bs, CFG.tag_bit_us / 2,
                        SP_US, CFG.adc_rate)
    x = np.concatenate([np.full(2000, 1.0, np.complex64), seg])
    return _awgn(x, noise, rng) if noise else x


def sigma_for(bs_abs: float, snr_db: float) -> float:
    """Post-MF half-symbol SNR of the WEAKER tag (sim/snr.py definition)."""
    return bs_abs * np.sqrt(25 / (10 ** (snr_db / 10.0)))


def rn16_draw(ratio: float, dt1: float, snr: float, trial: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ADC-rate capture, tag 1's RN16, tag 2's RN16) of one trial, drawn as
    the JAX tool draws it."""
    rng = np.random.default_rng(1000 * trial + 7)
    b1 = rng.integers(0, 2, 16)
    b2 = rng.integers(0, 2, 16)
    ph = rng.uniform(0, 2 * np.pi)
    bs2 = abs(BS1) * ratio * np.exp(1j * ph)
    noise = sigma_for(abs(bs2), snr)
    x = rn16_capture([(b1, BS1, 252.5), (b2, bs2, 252.5 + dt1)], noise, rng)
    return x, b1, b2


def rn16_trial(ratio: float, dt1: float, snr: float, trial: int, *, device=None) -> bool:
    """Did ``rn16_sic`` recover both RN16s of the trial's window?"""
    x, b1, b2 = rn16_draw(ratio, dt1, snr, trial)
    r = rn16_sic(matched_window(x, CFG.rn16_window, device), CFG)
    return (np.array_equal(r.bits1.cpu().numpy(), b1)
            and np.array_equal(r.bits2.cpu().numpy(), b2))


def rn16_sweep(ratios=RATIOS, n_trials: int = N_TRIALS, *, device=None) -> None:
    print("| ratio |h2|/|h1| | ΔT1 (µs) | weak-tag SNR (dB) | pair rate |")
    print("|---|---|---|---|")
    for ratio in ratios:
        for dt1 in DT1S:
            for snr in SNRS:
                ok = sum(rn16_trial(ratio, dt1, snr, t, device=device)
                         for t in range(n_trials))
                print(f"| {ratio} | {dt1} | {snr} | {ok}/{n_trials} |", flush=True)


def epc_capture(tags, noise: float, rng) -> np.ndarray:
    """Two EPC replies on a unit carrier, with AWGN (tools/sic_sweep.py:98-108)."""
    n = int(round((3 * CFG.t1_us + CFG.t2_us + CFG.epc_us) * SP_US)) + 4000
    seg = np.full(n, 1.0, dtype=np.complex64)
    for tag, t1 in tags:
        superpose_reply(seg, fm0_chips(tag.epc_frame_bits()), t1,
                        tag.backscatter, CFG.tag_bit_us / 2, SP_US, CFG.adc_rate)
    x = np.concatenate([np.full(2000, 1.0, np.complex64), seg])
    return _awgn(x, noise, rng)


def epc_draw(ratio: float, dt: float, noise: float, s: int) -> Tuple[np.ndarray, Tag, Tag]:
    """(ADC-rate capture, tag 1, tag 2) of one EPC trial, as the JAX tool
    draws it."""
    rng = np.random.default_rng(1000 + s)
    b1 = 0.085 * np.exp(1j * rng.uniform(0, 6.28))
    b2 = (0.085 * ratio) * np.exp(1j * rng.uniform(0, 6.28))
    t1 = Tag(epc96=rng.integers(0, 2, 96), backscatter=b1)
    t2 = Tag(epc96=rng.integers(0, 2, 96), backscatter=b2)
    return epc_capture([(t1, 252.5), (t2, 252.5 + dt)], noise, rng), t1, t2


def epc_trial(ratio: float, dt: float, noise: float, s: int, *, device=None) -> bool:
    """Did ``epc_sic`` return both tags' frames of the trial's window with
    passing CRCs?"""
    x, t1, t2 = epc_draw(ratio, dt, noise, s)
    r = epc_sic(matched_window(x, CFG.epc_window, device), CFG)
    got = {tuple(int(v) for v in fr)
           for fr, o in zip(r.bits.cpu().numpy(), r.crc_ok.cpu().numpy()) if o}
    want = {tuple(int(v) for v in t1.epc_frame_bits()),
            tuple(int(v) for v in t2.epc_frame_bits())}
    return want <= got


def epc_sweep(ratios=EPC_RATIOS, trials: int = EPC_TRIALS, *, device=None) -> None:
    """EPC-window SIC envelope: both-frames-CRC-pass rate over amplitude
    ratio x T1 offset x noise (random 96-bit EPC payloads; same-RN16
    collision scenario)."""
    print("| |h2|/|h1| | " + " | ".join(
        f"dT1 {dt} us, noise {nz}" for nz in EPC_NOISES for dt in EPC_DTS) + " |")
    print("|---|" + "---|" * (len(EPC_DTS) * len(EPC_NOISES)))
    for ratio in ratios:
        row = [f"| {ratio} "]
        for nz in EPC_NOISES:
            for dt in EPC_DTS:
                ok = sum(epc_trial(ratio, dt, nz, s, device=device) for s in range(trials))
                row.append(f"| {ok}/{trials} ")
        print("".join(row) + "|", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--epc", action="store_true",
                   help="run the EPC-window sweep (the JAX tool's epc_sweep)")
    p.add_argument("--ratios", nargs="+", type=float, default=None,
                   help="amplitude ratios |h2|/|h1| (default: the JAX tool's)")
    p.add_argument("--trials", type=int, default=None,
                   help=f"trials a cell (default {N_TRIALS}, or {EPC_TRIALS} with --epc)")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    if args.epc:
        with wall_time("sic_sweep --epc", dev):
            epc_sweep(args.ratios or EPC_RATIOS, args.trials or EPC_TRIALS, device=dev)
    else:
        with wall_time("sic_sweep", dev):
            rn16_sweep(args.ratios or RATIOS, args.trials or N_TRIALS, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
