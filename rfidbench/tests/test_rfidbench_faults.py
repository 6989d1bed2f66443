"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath: each fault a cell can have turns ``correct`` false.
(Every cell runs on one card, so no exchange between cards can be left
out.)  A sound run stays correct."""

from __future__ import annotations

import pytest
import torch

from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar
from rfidbench.cells import reader_fields
from rfidbench.run import run


def port(cell):
    cfg = ReaderConfig(**reader_fields(cell))
    return lambda x2: decode_capture_planar(x2, cfg, device="cpu")


def half_left_out(decode):
    """Half of the capture left out: only its first half is decoded."""
    return lambda x2: decode(x2[:, : x2.shape[1] // 2].contiguous())


def state_unchanged(decode):
    """Every call returns the first call's outputs."""
    first = []

    def broken(x2):
        if not first:
            first.append(decode(x2))
        return first[0]
    return broken


def bit_altered(decode):
    """One decoded EPC bit flipped where the decode produces it."""
    def broken(x2):
        stats, dec = decode(x2)
        row = int(torch.nonzero(dec.epc_pass)[0])
        bits = dec.epc_bits.clone()
        bits[row, 40] ^= 1
        return stats, dec._replace(epc_bits=bits)
    return broken


def count_altered(decode):
    """The report's EPC count off by one."""
    def broken(x2):
        stats, dec = decode(x2)
        return stats._replace(n_epc_correct=stats.n_epc_correct + 1), dec
    return broken


def float_perturbed(decode):
    """A float field off by one bfloat16 step (2^-8), as a lower-precision
    stage would leave it."""
    def broken(x2):
        stats, dec = decode(x2)
        return stats, dec._replace(rn16_margin=dec.rn16_margin * (1 + 2 ** -8))
    return broken


FAULTS = {"half_left_out": half_left_out, "state_unchanged": state_unchanged,
          "bit_altered": bit_altered, "count_altered": count_altered,
          "float_perturbed": float_perturbed}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_cell, fault):
    result = run(tiny_cell, 2 ** 31 + 5, 0.3, False, torch.device("cpu"),
                 decode=FAULTS[fault](port(tiny_cell)))
    assert result is not None and not result["correct"], result["checks"]


def test_sound_run_is_correct(tiny_cell):
    result = run(tiny_cell, 7, 0.3, False, torch.device("cpu"))
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["checks"]["truth_rows"]["value"] == 0


def test_control_readings(tiny_cell):
    """``rfidbench.control``'s two readings: the program's decode passes
    every check, the bfloat16 control fails the float gap."""
    from rfidbench import judge
    from rfidbench.control import readings

    ((seed, prog, ctl),) = readings(tiny_cell, [2 ** 31 + 9], torch.device("cpu"))
    assert judge.passed(prog) and 0 < prog["float_gap"]["value"] < prog["float_gap"]["limit"]
    assert not judge.passed(ctl) and ctl["float_gap"]["value"] > 10 * ctl["float_gap"]["limit"]
