"""Compat mode and the exact gate at the geometries the native path runs,
held to the JAX package on the CPU; shared by the
``test_torch_geometry_modes*`` files.

The seven geometries of ``chip_smoke.py``'s phase 16b (bench_configs.py's
Miller and BLF cases, FM0 at 8 and 16 Msps), each on its smallest capture
that shows the behaviour: 3 rounds of tag 27 seed 7 at simulator seed 2,
with a 32-row event table.  Compat keeps the reference's reply windows,
which miss every reply at BLF 640 and 160 kHz, in both packages
(ROADMAP.md section 3, item 11): there it reads no EPC.
"""

import dataclasses
import functools

import jax

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.runtime import inventory as inv
from torch_compare import assert_same_decoded, assert_same_stats, port_cfg

GEOMETRIES = {
    "miller4": RefConfig(miller_m=4, decim=1, max_events=32),
    "miller2": RefConfig(miller_m=2, decim=2, max_events=32),
    "miller8_trext": RefConfig(miller_m=8, trext=1, adc_rate=8e6, decim=2, max_events=32),
    "blf640": RefConfig(blf_hz=640e3, adc_rate=8e6, decim=2, max_events=32),
    "blf160": RefConfig.for_link(blf_hz=160e3, tari_us=24.0, dr=1, adc_rate=2e6, decim=1,
                                 max_events=32),
    "fm0_8msps": RefConfig(adc_rate=8e6, decim=1, max_events=32),
    "fm0_16msps": RefConfig(adc_rate=16e6, decim=1, max_events=32),
}
ROUNDS = 3
# The three decodes: label -> (mode, exact_gate).
DECODES = {"compat": ("compat", False), "exact_native": ("native", True),
           "exact_compat": ("compat", True)}
# Compat's reply windows miss every reply at these BLFs.
NO_COMPAT_EPC = ("blf640", "blf160")

ref_decode = jax.jit(ref_inv.decode_capture_planar, static_argnames=("cfg", "exact_gate"))


def ref_config(name, label):
    """The JAX package's configuration of a geometry's decode."""
    return dataclasses.replace(GEOMETRIES[name], mode=DECODES[label][0])


def want_epcs(name, label):
    return 0 if name in NO_COMPAT_EPC and DECODES[label][0] == "compat" else ROUNDS


@functools.lru_cache(maxsize=None)
def capture(name):
    """The geometry's 3-round trace (synthesized under its native config)."""
    return synthesize_inventory(GEOMETRIES[name], [RefTag.with_id(27, seed=7)],
                                n_rounds=ROUNDS, seed=2)


def port_decode(name, label):
    """The port's CPU decode of the geometry's capture: (stats, decoded)."""
    ref_cfg = ref_config(name, label)
    return inv.decode_capture(capture(name).iq, port_cfg(ref_cfg),
                              exact_gate=DECODES[label][1], device="cpu")


def assert_decode_equals_jax(name, label, **compare):
    """The port's decode against the JAX package's: every stats field and
    integer decode field equal, floats within ``torch_compare``'s
    tolerances (``compare``: its ``assert_same_decoded`` options); tag 27's
    EPCs as ``want_epcs`` says.  An exact-gate decode's stats also equal the
    port's default gate's in the same mode.  Returns the port's stats."""
    ref_cfg = ref_config(name, label)
    exact = DECODES[label][1]
    stats, dec = port_decode(name, label)
    ref_stats, ref_dec = ref_decode(ref_inv.to_planar(capture(name).iq), ref_cfg, exact)
    assert_same_stats(stats, ref_stats)
    assert_same_decoded(dec, ref_dec, **compare)
    want = want_epcs(name, label)
    assert int(stats.n_epc_correct) == int(stats.tag_reads[27]) == want
    if exact:
        default, _ = inv.decode_capture(capture(name).iq, port_cfg(ref_cfg), device="cpu")
        assert_same_stats(stats, default)
    return stats
