"""PDOA ranging and Doppler accuracy envelopes, on the port.

    python -m gen2_rfid_tpu_torch.tools.ranging_sweep [--device cpu]
        [--sweeps hops noise velocity multipath] [--hops 2 3 ...]
        [--rounds 5 ...] [--trials N]

Twin of ``tools/ranging_sweep.py``:

  * range accuracy vs number of FCC hop channels (fixed span) and vs noise;
  * velocity accuracy vs capture length;
  * two-path multipath: the bias and the fit residual that flags it.

Each capture decodes on the device; ``runtime/ranging.py`` (a verbatim
numpy module) reads one host copy of each decode (``carry.py::host_decoded``).
The flags narrow the grid (``--trials`` replaces each sweep's own count).
Prints the JAX tool's lines.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..carry import host_decoded
from ..config import ReaderConfig
from ..runtime.inventory import decode_capture
from ..runtime.ranging import (
    FCC_HOP_FREQS_HZ,
    estimate_velocity,
    range_from_captures,
    tag_phase_series,
)
from ..sim.tag import Tag
from ..sim.trace import synthesize_inventory
from .sweep import add_device_flag, sweep_device, wall_time

HOPS = (2, 3, 5, 10)
NOISES = (0.004, 0.02, 0.04, 0.06)
ROUNDS = (5, 10, 20, 40)
PATHS = ((0.0, 0.0), (0.2, 1.5), (0.5, 1.5), (0.5, 4.0))
SWEEPS = ("hops", "noise", "velocity", "multipath")


def hop_captures(freqs, d, noise=0.004, n_rounds=3, v=0.0, seed0=100, *, device=None):
    """[(carrier Hz, tag phase series)] of one capture a carrier."""
    dec_cfg = ReaderConfig()
    out = []
    for k, f in enumerate(freqs):
        cfg = ReaderConfig(freq_hz=f)
        tr = synthesize_inventory(
            cfg, [Tag.with_id(27, seed=7, distance_m=d, velocity_mps=v)],
            n_rounds=n_rounds, noise=noise, seed=seed0 + k)
        _, dec = decode_capture(tr.iq, dec_cfg, device=device)
        out.append((f, tag_phase_series(host_decoded(dec), dec_cfg)))
    return out


def sweep_hops(hops=HOPS, trials: int = 5, *, device=None) -> None:
    print("# range accuracy vs hop count (d=3.7 m, SNR nominal)")
    for n_hops in hops:
        step = max(len(FCC_HOP_FREQS_HZ) // n_hops, 1)
        freqs = FCC_HOP_FREQS_HZ[::step][:n_hops]
        errs = []
        for trial in range(trials):
            per = hop_captures(freqs, 3.7, seed0=200 + 50 * trial, device=device)
            est = range_from_captures(per)[27]
            errs.append(abs(est["range_m"] - 3.7))
        print(f"hops={n_hops:2d} span={freqs[-1]-freqs[0]:9.2e} Hz "
              f"median|err|={np.median(errs)*100:.2f} cm "
              f"max={np.max(errs)*100:.2f} cm", flush=True)


def sweep_noise(trials: int = 5, *, device=None) -> None:
    print("# range accuracy vs noise (5 hops, d=3.7 m; backscatter |b|=0.085)")
    freqs = FCC_HOP_FREQS_HZ[::12]
    for noise in NOISES:
        errs = []
        for trial in range(trials):
            per = hop_captures(freqs, 3.7, noise=noise,
                               seed0=400 + 50 * trial, device=device)
            if 27 not in {t for _, s in per for t in s}:
                errs.append(np.inf)
                continue
            est = range_from_captures(per).get(27)
            errs.append(abs(est["range_m"] - 3.7) if est else np.inf)
        print(f"noise={noise:.3f} median|err|={np.median(errs)*100:.2f} cm", flush=True)


def velocity_error(n_rounds: int, trial: int, *, device=None) -> float:
    """|estimated - 1.5| m/s of a tag at 2 m moving at 1.5 m/s."""
    cfg = ReaderConfig()
    tr = synthesize_inventory(
        cfg, [Tag.with_id(27, seed=7, distance_m=2.0, velocity_mps=1.5)],
        n_rounds=n_rounds, seed=700 + trial)
    _, dec = decode_capture(tr.iq, cfg, device=device)
    s = tag_phase_series(host_decoded(dec), cfg)[27]
    est = estimate_velocity(s["time_s"], s["phase_rad"], cfg.freq_hz)
    return abs(est["velocity_mps"] - 1.5)


def sweep_velocity(rounds=ROUNDS, trials: int = 3, *, device=None) -> None:
    print("# velocity accuracy vs capture length (v=1.5 m/s, d=2 m)")
    for n_rounds in rounds:
        errs = [velocity_error(n_rounds, trial, device=device) for trial in range(trials)]
        dur = n_rounds * 15e-3
        print(f"rounds={n_rounds:2d} (~{dur*1e3:.0f} ms) "
              f"median|err|={np.median(errs)*100:.2f} cm/s", flush=True)


def multipath_demo(*, device=None) -> None:
    """Two-path channel: the direct path at d plus a reflection at d+dx.
    The per-carrier phase is no longer linear in f; the PDOA fit biases
    toward a power-weighted mix and the residual flags it."""
    print("# two-path multipath (direct d=3.7 m + reflection, rel amp a)")
    freqs = FCC_HOP_FREQS_HZ[::6]
    c = 299_792_458.0
    for a, dx in PATHS:
        per = []
        dec_cfg = ReaderConfig()
        for k, f in enumerate(freqs):
            cfg = ReaderConfig(freq_hz=f)
            # Composite backscatter coefficient: direct + delayed path.
            b0 = 0.08 + 0.03j
            comp = b0 * (np.exp(-4j * np.pi * f * 3.7 / c)
                         + a * np.exp(-4j * np.pi * f * (3.7 + dx) / c))
            tag = Tag.with_id(27, seed=7, backscatter=comp)
            tr = synthesize_inventory(cfg, [tag], n_rounds=3,
                                      seed=900 + k)
            _, dec = decode_capture(tr.iq, dec_cfg, device=device)
            per.append((f, tag_phase_series(host_decoded(dec), dec_cfg)))
        est = range_from_captures(per)[27]
        print(f"a={a:.1f} dx={dx:.1f} m -> range {est['range_m']:.2f} m "
              f"(bias {est['range_m']-3.7:+.2f}), resid "
              f"{est['resid_rad']:.3f} rad", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_flag(p)
    p.add_argument("--sweeps", nargs="+", choices=SWEEPS, default=list(SWEEPS))
    p.add_argument("--hops", nargs="+", type=int, default=list(HOPS))
    p.add_argument("--rounds", nargs="+", type=int, default=list(ROUNDS))
    p.add_argument("--trials", type=int, default=None,
                   help="trials a point (default: 5 for hops and noise, 3 for velocity)")
    args = p.parse_args(argv)
    dev = sweep_device(args.device)
    t = {} if args.trials is None else {"trials": args.trials}
    with wall_time("ranging_sweep", dev):
        if "hops" in args.sweeps:
            sweep_hops(args.hops, device=dev, **t)
        if "noise" in args.sweeps:
            sweep_noise(device=dev, **t)
        if "velocity" in args.sweeps:
            sweep_velocity(args.rounds, device=dev, **t)
        if "multipath" in args.sweeps:
            multipath_demo(device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
