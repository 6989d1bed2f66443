"""The FM0 cases of the configuration matrix (``tools/bench_configs.py``'s
twin) and the flagship (``tools/bench.py``'s), narrowed, against the JAX
package on the CPU.

Each case's capture, built by the twin at 3 rounds tiled twice, equals the
JAX script's (``make_decode_case`` at the same size) bit for bit, and the
twin's case body decodes it to the JAX decode's InventoryStats in every
field, each EPC the capture holds.  ``test_torch_bench_miller.py`` holds
the Miller cases (their JAX compiles take longer).
"""

import numpy as np
import pytest

from bench_compare import CPU, ROUNDS, TILES, bit_equal, check_case_decode, jax_decode
from gen2_rfid_tpu_torch.tools.bench import FLAGSHIP, narrowed, role_split
from gen2_rfid_tpu_torch.tools.bench_configs import CASES
from torch_compare import assert_same_stats, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["blf640", "blf160", "longcap"])
def test_fm0_case_decode_matches_jax(monkeypatch, name):
    check_case_decode(monkeypatch, name)


def test_multitag_q4_decode_matches_jax_and_splits_its_roles(monkeypatch):
    """Five tags at fixed Q = 4 (collisions and empty slots): the role split
    that ``role_split`` reports is the JAX package's ``command_roles`` of its
    own decode, and neither role table overflows."""
    from gen2_rfid_tpu.runtime.inventory import command_roles

    dec, ref_dec = check_case_decode(monkeypatch, "multitag_q4")
    roles = role_split(dec, CASES["multitag_q4"].cfg)
    ref_q, ref_a = command_roles(ref_dec.cmd_type, ref_dec.valid)
    assert (roles["query_rows"], roles["ack_rows"]) == (int(ref_q.sum()), int(ref_a.sum()))
    assert roles["valid_rows"] == int(ref_dec.valid.sum())
    assert roles["valid_rows"] == roles["query_rows"] + roles["ack_rows"]
    assert roles["cap"] == 1536 and roles["cap_q"] == 1536 // 2 + 1 + 16
    assert roles["ack_rows"] > 0 and not roles["fallback"]


def test_flagship_decode_matches_jax():
    """bench.py's workload at 3 rounds tiled twice: the root script's
    synthesis (the JAX package's ``synthesize_inventory`` and ``to_planar``)
    bit for bit, and its decode's stats."""
    from gen2_rfid_tpu.config import ReaderConfig as RefConfig
    from gen2_rfid_tpu.runtime.inventory import to_planar
    from gen2_rfid_tpu.sim.tag import Tag as RefTag
    from gen2_rfid_tpu.sim.trace import synthesize_inventory

    cfg = RefConfig(max_events=1536)
    tr = synthesize_inventory(cfg, [RefTag.with_id(27, seed=7)], n_rounds=ROUNDS, seed=2)
    iq2 = np.asarray(to_planar(np.concatenate([tr.iq] * TILES)))
    w = narrowed(FLAGSHIP, ROUNDS, TILES).workload(CPU)
    assert bit_equal(w.x2.numpy(), iq2)
    stats, _ = w.decode(w.x2)
    assert_same_stats(stats, jax_decode(iq2, cfg)[0])
    assert int(stats.n_epc_correct) == w.epcs[0] == tr.expected_epc_pass * TILES
