"""The port's multi-process decode on the CPU: shard/distributed.py,
shard/distributed_worker.py, shard/launch.py and tools/run_distributed.py.

Separate interpreters joined in a gloo process group on localhost, each
reading its own time shards of the capture file, give the JAX package's
single-process record (tests/test_distributed.py:27-44); the in-process
file decode equals the port's single decode in every stats field.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime.inventory import decode_capture as ref_decode_capture
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.io.tracefile import write_trace
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture
from gen2_rfid_tpu_torch.shard import distributed
from gen2_rfid_tpu_torch.shard.launch import run_local
from gen2_rfid_tpu_torch.tools import run_distributed
from torch_compare import port_cfg
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = RefConfig(max_events=256)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    tr = synthesize_inventory(CFG, [RefTag.with_id(27, seed=7)], n_rounds=6, seed=5)
    path = str(tmp_path_factory.mktemp("dist") / "cap.bin")
    write_trace(path, tr.iq)
    stats, _ = ref_decode_capture(jnp.asarray(tr.iq), CFG)
    expected = {
        "n_queries": int(stats.n_queries),
        "n_epc_correct": int(stats.n_epc_correct),
        "round": int(stats.cur_inventory_round),
        "unique_tags": 1,
        "tag_reads": {str(t): int(np.asarray(stats.tag_reads)[t])
                      for t in np.nonzero(np.asarray(stats.tag_reads))[0]},
    }
    assert expected["n_epc_correct"] == tr.expected_epc_pass
    return path, tr.iq, expected


@pytest.mark.parametrize("num_processes,shards", [(2, 2), (4, 1)])
def test_multiprocess_matches_jax_single(capture, num_processes, shards):
    path, _, expected = capture
    rec = run_local(path, num_processes, shards, "cpu", events_per_shard=64,
                    max_events=CFG.max_events, timeout=300.0)
    assert rec["num_processes"] == num_processes
    assert rec["n_devices"] == num_processes * shards
    assert {k: rec[k] for k in expected} == expected


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_file_decode_equals_single(capture, shards):
    """One process: the file cut to a multiple of shards * decim; the tail
    past the last shard holds no event, so the stats equal the single
    decode's in every field (the joined table at least max_events rows, so
    unique_tags_round is as long as the single decode's)."""
    path, iq, _ = capture
    distributed.init_distributed()            # one process: a no-op
    cfg = port_cfg(CFG)
    stats, dec = distributed.decode_file_distributed(
        path, cfg, events_per_shard=256, device="cpu", shards_per_process=shards)
    single, _ = decode_capture(iq, cfg, device="cpu")
    for f in single._fields:
        assert torch.equal(getattr(stats, f)[0], getattr(single, f)), f
    assert dec.index.shape == (1, 256 * shards)
    host = distributed.stats_to_host(stats)
    assert isinstance(host.tag_reads, np.ndarray) and host.tag_reads[0, 27] == 6


def test_pack_round_trips_every_field(capture):
    path, _, _ = capture
    _, dec = distributed.decode_file_distributed(path, port_cfg(CFG), events_per_shard=64,
                                                 device="cpu", shards_per_process=2)
    back = distributed._unpack(distributed._pack(dec), dec)
    for a, b in zip(back, dec):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["missing file", "no cuda"])
def test_worker_failure_raises(capture, tmp_path, case):
    """A worker that fails (a missing file; the default CUDA device where
    there is none) makes run_local raise, and ends every worker."""
    if case == "missing file":
        args = (str(tmp_path / "missing.bin"), 2, 1, "cpu")
    else:
        if torch.cuda.is_available():
            pytest.skip("needs a host without CUDA")
        args = (capture[0], 2, 1, "cuda")
    with pytest.raises(RuntimeError, match="exited"):
        run_local(*args, timeout=300.0)


def test_run_distributed_cli(capture, capsys):
    path, _, expected = capture
    rc = run_distributed.main([path, "--num-processes", "2", "--shards-per-process", "1",
                               "--device", "cpu", "--expect-json",
                               json.dumps({"n_epc_correct": expected["n_epc_correct"]})])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tag_reads"] == \
        expected["tag_reads"]


def test_worker_needs_cuda_unless_told(capture, monkeypatch):
    """The file decode runs on CUDA unless the caller names a device: without
    CUDA it raises, never decodes on the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.decode_file_distributed(capture[0], port_cfg(CFG))
