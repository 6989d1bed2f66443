"""What the envelope sweeps share: the device flag and its policy, the wall
time each prints, and the comparison of two printed tables.

The sweeps are the twins of the root ``tools/`` scripts of the same names
(``snr_curves``, ``softfix_false_accept``, ``sic_sweep``,
``classifier_sweep``, ``miller_robustness_sweep``, ``impair_sweep``,
``ranging_sweep``): the same grids, seeds, rounds and trial counts, and the
same table on standard output, from the port's entry points.  Each runs
on CUDA unless ``--device cpu`` is given, and raises without CUDA; none
falls back to the CPU.  Each prints its wall time on standard error, so
that standard output is the table alone.

``ROWS`` is one row of each twin's grid and ``run_twin`` runs a twin's
``main`` to its printed lines; ``chip_smoke.py``, the card test and the CPU
tests run the twins through them, each narrowing the rows as it needs.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import re
import sys
import time
from typing import Dict, List, Sequence, Tuple

import torch


# One row of each twin's grid, by label: (twin, arguments, units of the last
# printed digit a decimal may differ by between two devices: ranging's ranges
# only; every other number is a count or a ratio of counts).  The softfix
# campaign has no grid: its rows are its frames.
ROWS = {
    "snr": ("snr_curves", ["--modes", "fm0_blf40"], 0),
    "sic": ("sic_sweep", ["--ratios", "0.1"], 0),
    "sic_epc": ("sic_sweep", ["--epc", "--ratios", "0.15"], 0),
    "classifier": ("classifier_sweep", ["--noises", "0.064"], 0),
    "miller": ("miller_robustness_sweep", [], 0),
    "impair": ("impair_sweep", ["--quant-bits", "6", "--iq-index", "3", "--phase-walk",
                                "6e-3", "--interferer-dbc", "-15"], 0),
    "ranging": ("ranging_sweep", ["--sweeps", "hops", "--hops", "2", "3"], 1),
}


def rows(narrow: Dict[str, List[str]] = None) -> List[Tuple[str, str, List[str], int]]:
    """``ROWS`` as (label, twin, arguments, digits), with ``narrow[label]``'s
    arguments after a row's own (a later flag overrides an earlier one)."""
    narrow = narrow or {}
    return [(label, twin, argv + narrow.get(label, []), digits)
            for label, (twin, argv, digits) in ROWS.items()]


def run_twin(twin: str, argv: Sequence[str], device: str) -> Tuple[List[str], float]:
    """A twin's printed lines and wall seconds for
    ``main(argv + ["--device", device])``; raises if it exits non-zero."""
    main = importlib.import_module(f"{__package__}.{twin}").main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv) + ["--device", device])
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{twin} {' '.join(argv)} exited {rc}")
    return buf.getvalue().splitlines(), seconds


def add_device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="device the sweep runs on: cuda (default), or cpu when asked")


def sweep_device(name: str) -> torch.device:
    """The device a sweep's ``main`` runs on.  An entry point, it turns
    TF32 off for matmuls and cuDNN (the CRC and SIC contractions need full
    float32); it raises when CUDA is asked for and there is none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@contextlib.contextmanager
def wall_time(label: str, device: torch.device):
    """Print the block's wall time (synchronized) on standard error."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[{label}] wall {time.perf_counter() - t0:.3f} s on {where}",
          file=sys.stderr, flush=True)


_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
_DECIMAL = re.compile(r"[-+]?\d*\.(\d+)")


def _unit(token: str):
    """One unit of a plain decimal's last digit; None for anything else."""
    m = _DECIMAL.fullmatch(token)
    return 10.0 ** -len(m.group(1)) if m else None


def table_diff(got: Sequence[str], want: Sequence[str], last_digits: int = 0) -> List[str]:
    """The lines where two printed tables differ.  Text must be equal; a
    plain decimal (``12.34``) may differ from its counterpart by up to
    ``last_digits`` units of its last printed digit (0: equal text).
    Integers, exponents and ratios such as ``3/12`` are always equal."""
    bad = [] if len(got) == len(want) else [f"{len(got)} lines against {len(want)}"]
    for g, w in zip(got, want):
        gn, wn = _NUMBER.findall(g), _NUMBER.findall(w)
        same = g == w or (last_digits > 0 and len(gn) == len(wn)
                          and _NUMBER.sub("#", g) == _NUMBER.sub("#", w)
                          and all(_close(a, b, last_digits) for a, b in zip(gn, wn)))
        if not same:
            bad.append(f"got {g!r}, want {w!r}")
    return bad


def _close(a: str, b: str, last_digits: int) -> bool:
    if a == b:
        return True
    unit = _unit(a)
    return (unit is not None and unit == _unit(b)
            and abs(float(a) - float(b)) <= last_digits * unit * (1 + 1e-9))
