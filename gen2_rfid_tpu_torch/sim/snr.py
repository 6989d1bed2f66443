"""SNR sweep: decode success rate vs noise (BASELINE.md verification).

PyTorch counterpart of ``gen2_rfid_tpu/sim/snr.py``: the same module but
for ``snr_sweep``'s decode, which is the port's ``decode_capture`` on the
device its ``device`` argument names (CUDA by default).

The reference publishes no BER curves; its implicit bound is "the golden
capture decodes" (README.md:43-53).  This utility quantifies the decoder's
operating region on synthetic traces: for each SNR it synthesizes
inventory rounds with AWGN and measures the EPC decode rate, where SNR is
defined per post-matched-filter half-symbol:

    SNR = |h_bs|^2 * n_taps / sigma^2      (coherent boxcar gain)

Coherent FM0 detection theory predicts a waterfall around a few dB; the
regression test pins "high SNR decodes everything / negative SNR decodes
nothing" plus monotonicity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


from ..config import ReaderConfig
from .tag import Tag
from .trace import synthesize_inventory


@dataclasses.dataclass
class SnrPoint:
    snr_db: float
    noise_sigma: float
    epc_rate: float          # decoded EPCs / expected EPCs
    n_expected: int


def sigma_for_snr(cfg: ReaderConfig, backscatter: complex, snr_db: float) -> float:
    n_taps = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)
    return float(abs(backscatter) * math.sqrt(n_taps / (10 ** (snr_db / 10.0))))


def snr_sweep(
    cfg: ReaderConfig,
    snr_db: Sequence[float],
    n_rounds: int = 10,
    seed: int = 0,
    backscatter: complex = 0.08 + 0.03j,
    cfo_hz: float = 0.0,
    device=None,
) -> List[SnrPoint]:
    """EPC decode rate at each SNR, decoded on CUDA unless ``device`` says
    otherwise."""
    from ..runtime.inventory import decode_capture

    out = []
    for k, s in enumerate(snr_db):
        sigma = sigma_for_snr(cfg, backscatter, s)
        tag = Tag.with_id(27, seed=7, backscatter=backscatter, cfo_hz=cfo_hz)
        tr = synthesize_inventory(
            cfg, [tag], n_rounds=n_rounds, noise=sigma, seed=seed + 1000 * k
        )
        stats, _ = decode_capture(tr.iq, cfg, device=device)
        out.append(
            SnrPoint(
                snr_db=float(s),
                noise_sigma=sigma,
                epc_rate=float(int(stats.n_epc_correct)) / max(tr.expected_epc_pass, 1),
                n_expected=tr.expected_epc_pass,
            )
        )
    return out


def theory_waterfall_db(epc_bits: int = 128) -> float:
    """Predicted FER=0.5 SNR (dB, per post-MF half-symbol) for coherent
    single-sample differential FM0 detection.

    Per-bit statistic: real((s1 - s2) conj(h)) with unit-energy half-symbol
    samples s = +-h + CN(0, sigma_s^2); a decision flips when the projected
    noise exceeds the signal, Pb ~ Q(sqrt(gamma)) with gamma = |h|^2 /
    sigma_s^2 (single-sample detection of the half-amplitude OOK chips
    costs the factor 4 of ideal antipodal signaling).  The 50% frame point
    solves 1 - (1 - Pb)^n = 0.5.
    """
    from scipy.stats import norm  # scipy is available via jax deps

    pb = 1.0 - 0.5 ** (1.0 / epc_bits)
    gamma = norm.isf(pb) ** 2
    return 10.0 * math.log10(gamma)


def waterfall_db(
    cfg: ReaderConfig,
    lo_db: float = -2.0,
    hi_db: float = 18.0,
    tol_db: float = 0.5,
    n_rounds: int = 16,
    seed: int = 0,
    cfo_hz: float = 0.0,
) -> float:
    """SNR (dB) where the EPC decode rate crosses 0.5, by bisection.

    All probes reuse one trace structure (same seed -> same length -> one
    jit compile); only the AWGN level changes.
    """
    def rate(s):
        return snr_sweep(cfg, [s], n_rounds=n_rounds, seed=seed,
                         cfo_hz=cfo_hz)[0].epc_rate

    assert rate(hi_db) > 0.5 and rate(lo_db) < 0.5, "bracket the waterfall"
    while hi_db - lo_db > tol_db:
        mid = 0.5 * (lo_db + hi_db)
        if rate(mid) >= 0.5:
            hi_db = mid
        else:
            lo_db = mid
    return 0.5 * (lo_db + hi_db)


def theory_miller_waterfall_db(m: int, epc_bits: int = 128) -> float:
    """Predicted FER=0.5 SNR (dB, per post-MF half-chip) for Miller-M.

    Per half-bit the detector correlates M chip samples against the
    subcarrier (dsp/miller.py::miller_detect): OOK chips alternate 0/h so
    the correlation mean is M|h|/2 with noise variance M sigma_s^2, i.e.
    statistic SNR M*gamma/4; a bit errs when either half-bit correlation
    flips sign: Pb ~ 2 Q(sqrt(M*gamma/2)).  Solving 1-(1-Pb)^n = 0.5 gives
    gamma* ~ 11.9 - 10 log10(M) dB - a ~3 dB gain per doubling of M, with
    Miller-2 sitting at FM0's level (both integrate the same energy per
    decision).
    """
    from scipy.stats import norm

    pb = 1.0 - 0.5 ** (1.0 / epc_bits)
    x = norm.isf(pb / 2.0)
    gamma = 2.0 * x * x / m
    return 10.0 * math.log10(gamma)
