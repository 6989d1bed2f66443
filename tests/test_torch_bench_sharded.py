"""The sharded workloads of the bench twins against the JAX package on the
CPU: ``wideband8`` (``tools/bench_configs.py``) and the scaling harness
(``tools/bench_scaling.py``), narrowed.

* ``wideband8`` at 2 rounds, one tile: the twin's body (the port's
  ``channelize_planar``, then ``make_sharded_decoder`` on a one-position
  mesh, 160 events a channel) gives the per-channel EPC counts and
  ``tag_reads`` of the JAX package's ``channelize_planar`` +
  ``make_sharded_decoder`` on the same capture.
* Scaling at 3 rounds tiled 4 times, padded to a multiple of 4 x decim: the
  twin's decoders at n_time 1 and 4 on CPU positions give the JAX package's
  ``make_sharded_decoder`` InventoryStats, in every field, on its first 1
  and 4 forced CPU devices.
"""

import numpy as np
import pytest
import torch

from bench_compare import CPU, jax_cfg, jax_sharded
from gen2_rfid_tpu_torch.tools.bench import narrowed
from gen2_rfid_tpu_torch.tools.bench_configs import CASES
from gen2_rfid_tpu_torch.tools.bench_scaling import scaling_case, workloads
from torch_compare import assert_same_stats, one_torch_thread  # noqa: F401


def test_wideband8_decode_matches_jax():
    case = narrowed(CASES["wideband8"], 2, 1)
    w = case.workload(CPU)
    stats, _ = w.decode(w.x2)
    ref, _ = jax_sharded(w.x2.numpy(), jax_cfg(case.cfg), 1,
                         case.events_per_shard, n_chan=case.n_chan)
    got = stats.n_epc_correct.tolist()
    assert got == np.asarray(ref.n_epc_correct).tolist() == list(w.epcs)
    np.testing.assert_array_equal(stats.tag_reads.numpy(), np.asarray(ref.tag_reads))
    for k, (tag, _, _) in zip(case.chans, case.inventories):
        assert got[k] > 0 and int(stats.tag_reads[k, tag]) == got[k]


@pytest.mark.parametrize("n_time", [1, 4])
def test_scaling_decode_matches_jax(n_time):
    case = scaling_case(4, rounds=3)
    assert case.tiles == 4
    w = workloads(case, [CPU] * 4)[n_time]
    assert w.x2.shape[-1] % (4 * case.cfg.decim) == 0
    stats, _ = w.decode(w.x2)
    ref, _ = jax_sharded(w.x2.numpy(), jax_cfg(case.cfg), n_time,
                         case.cfg.max_events // n_time)
    assert_same_stats(stats, ref)
    assert int(stats.n_epc_correct[0]) == w.epcs[0] > 0
    assert isinstance(w.x2, torch.Tensor) and w.x2.shape[0] == 1
