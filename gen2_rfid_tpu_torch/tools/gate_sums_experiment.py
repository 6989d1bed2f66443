"""Gate windowed-sum formulations and the kernel execution probe, on the card.

    python -m gen2_rfid_tpu_torch.tools.gate_sums_experiment

Port of ``tools/tpu_gate_sums_experiment.py`` (``main``, ``rises_probe``,
``rises_blocked_probe``), at its sizes: the bench decode's post-decimation
length n = 9,700,000 // 5 of |N(1, 0.1)| amplitudes (seed 0) for the sums,
rises at p = 0.002 and resets at p = 0.001 (seed 1) for the pulse counts.

Three formulations of the windowed sums over W = 100, 98 and 4:

A. dyadic doubling (``dsp/filters.py::run_sum``), one call per window;
B. one multi-channel overlap-save convolution, every window an output
   channel of a single stride-1 ``torch.nn.functional.conv1d`` (cuDNN, TF32
   off).  This is a variant under test, not a port of a kernel;
C. the blocked cumsum (``dsp/filters.py::moving_sum``), one call per window.

It prints the largest |conv - dyadic| per window, then the pulse-count scans:
the segmented doubling ``_rises_since_reset`` against overlap blocks with one
cumsum and one cummax (equal when a reset falls in every span, which it
forces).  Each time is the median of CUDA-event timings
(``utils/timing.py::cuda_ms``).  Last, the probe kernel (kernels/probe.py)
runs on an (8, 128) tile and must equal its plain version bit for bit: the
tool prints ``probe: EXECUTES OK``, and exits non-zero if the probe gives a
wrong result or does not build or launch.  It needs a CUDA device.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch

from ..dsp.filters import _overlap_blocks, moving_sum, run_sum
from ..dsp.gate import _rises_since_reset
from ..kernels.probe import probe, probe_plain
from ..utils.timing import cuda_ms

N = 9_700_000 // 5
WINS = (100, 98, 4)
SPAN = 1664          # the native gate's pulse-count lookback at the defaults


def amplitudes(n: int = N) -> np.ndarray:
    return np.abs(np.random.default_rng(0).normal(1.0, 0.1, n)).astype(np.float32)


def rises_and_resets(n: int = N):
    rng = np.random.default_rng(1)
    return rng.random(n) < 0.002, rng.random(n) < 0.001


def conv_sums(amp: torch.Tensor, wins=WINS, block: int = 8192) -> torch.Tensor:
    """All windowed sums of one input by a single multi-channel overlap-save
    convolution: out[c][i] = sum(amp[i-wins[c]+1 .. i])."""
    n = amp.shape[0]
    t = max(wins)
    ext = _overlap_blocks(amp.to(torch.float32), block, t - 1)   # (nb, t-1+block)
    taps = torch.zeros((len(wins), 1, t), dtype=torch.float32, device=amp.device)
    for c, w in enumerate(wins):
        taps[c, 0, t - w:] = 1.0     # the last w samples of each t-span: causal
    out = torch.nn.functional.conv1d(ext[:, None, :], taps)       # (nb, C, block)
    return out.permute(1, 0, 2).reshape(len(wins), -1)[:, :n]


def rises_blocked(rise: torch.Tensor, reset: torch.Tensor, span: int = SPAN,
                  block: int = 8192) -> torch.Tensor:
    """Rises since the last reset by overlap blocks of halo ``span``, one
    int32 cumsum and one cummax per block: exact when every span holds a
    reset (the protocol's guarantee)."""
    er = _overlap_blocks(rise.to(torch.int32), block, span)
    es = _overlap_blocks(reset, block, span)
    c = torch.cumsum(er, dim=1, dtype=torch.int32)
    cm = torch.cummax(torch.where(es, c, -1), dim=1).values
    out = c - torch.clamp(cm, min=0)
    return out[:, span:].reshape(-1)[: rise.shape[0]]


def _every_97th(vs) -> torch.Tensor:
    return sum(v[::97].sum() for v in vs)


def run(reps: int = 20, log=print) -> dict:
    """Every phase on the current CUDA device; returns the timings (ms), the
    errors and the checks.  The caller turns cuDNN's TF32 off first (as
    ``main`` does): with it on, the convolution's sums are not float32."""
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("set torch.backends.cudnn.allow_tf32 = False before run()")
    dev = torch.device("cuda")
    out = {}
    amp = torch.from_numpy(amplitudes()).to(dev)

    s = conv_sums(amp)
    for c, w in enumerate(WINS):
        err = float((s[c] - run_sum(amp, w)).abs().max())
        out[f"err_win{w}"] = err
        log(f"win{w}: max|conv - dyadic| = {err}")
    for name, fn in (
            ("dyadic run_sum x3", lambda: _every_97th(run_sum(amp, w) for w in WINS)),
            ("multi-channel conv", lambda: _every_97th(conv_sums(amp))),
            ("blocked cumsum x3", lambda: _every_97th(moving_sum(amp, w) for w in WINS))):
        out[name] = cuda_ms(fn, reps)
        log(f"{name}: {out[name]:.4f} ms/iter")

    rise_h, reset_h = rises_and_resets()
    rise, reset = torch.from_numpy(rise_h).to(dev), torch.from_numpy(reset_h).to(dev)
    out["_rises_since_reset"] = cuda_ms(
        lambda: _rises_since_reset(rise, reset, SPAN)[::97].sum(), reps)
    log(f"_rises_since_reset: {out['_rises_since_reset']:.4f} ms/iter")
    reset_h[:: SPAN // 2] = True
    reset = torch.from_numpy(reset_h).to(dev)
    same = bool(torch.equal(rises_blocked(rise, reset), _rises_since_reset(rise, reset, SPAN)))
    out["blocked == dyadic"] = same
    log(f"blocked == dyadic: {same}")
    for name, fn in (("dyadic _rises_since_reset", lambda: _rises_since_reset(rise, reset, SPAN)),
                     ("blocked cumsum+cummax", lambda: rises_blocked(rise, reset))):
        out[name] = cuda_ms(lambda: fn()[::97].sum(), reps)
        log(f"{name}: {out[name]:.4f} ms/iter")

    x = amp[: 8 * 128].reshape(8, 128)
    try:
        got = probe(x)
        torch.cuda.synchronize()
        ok = bool(torch.equal(got, probe_plain(x)))
        log(f"probe: {'EXECUTES OK' if ok else 'WRONG RESULT'}")
    except Exception as err:  # noqa: BLE001 - reported, then the tool fails
        log(traceback.format_exc())
        log(f"probe: FAILED ({type(err).__name__}: {err})")
        ok = False
    out["probe ok"] = ok
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gate_sums_experiment: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    out = run(log=lambda *a: print(*a, flush=True))
    return 0 if out["probe ok"] and out["blocked == dyadic"] else 1


if __name__ == "__main__":
    sys.exit(main())
