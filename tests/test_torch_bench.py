"""The bench twins (``gen2_rfid_tpu_torch/tools/{bench,bench_configs,
bench_scaling}.py``) against the root ``bench*.py`` scripts: their specs,
their ``main``s on the CPU, a wrong count and the refusal without CUDA.

* Specs: each of the eight cases' configuration (every ReaderConfig field),
  tags (EPC, PC, seed, backscatter), rounds, seed and tiles equal the JAX
  script's, recorded from its ``make_decode_case`` call (no capture is
  synthesized).  ``wideband8``'s full-size capture and expected count equal
  the JAX case's bit for bit, its decoder's configuration and table size
  too.  The flagship's and the scaling harness's synthesis arguments, tiles,
  padding and decoders equal the root scripts', each run with a stand-in
  synthesis and stopped before it decodes.
* Mains: each prints one JSON line per case with the JAX line's keys and the
  added ones, ``"device": "cpu"`` and no launches; a count off by one exits
  1 with ``FATAL``; without CUDA and without ``--device cpu``, each exits
  non-zero with a message.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from bench_compare import (
    ADDED_KEYS, CPU, JAX_KEYS, NO_LAUNCHES, REPO, SCALING_KEYS, assert_same_cfg,
    assert_same_tags, bit_equal, check_line, jax_case, root_script, run_main)
from gen2_rfid_tpu_torch.runtime.inventory import to_planar
from gen2_rfid_tpu_torch.tools import bench, bench_configs, bench_scaling
from gen2_rfid_tpu_torch.tools.bench import FLAGSHIP, make_tags
from gen2_rfid_tpu_torch.tools.bench_configs import CASES, DecodeCase
from sweep_compare import keep_tf32_flags  # noqa: F401
from torch_compare import one_torch_thread  # noqa: F401

SINGLE = [name for name, case in CASES.items() if isinstance(case, DecodeCase)]


# ---- specs ------------------------------------------------------------------------

def test_cases_are_the_jax_scripts_in_order():
    assert list(CASES) == list(root_script("bench_configs").CASES)
    assert len(SINGLE) == 7 and "wideband8" not in SINGLE


@pytest.mark.parametrize("name", SINGLE)
def test_case_spec_matches_jax(monkeypatch, name):
    want = jax_case(monkeypatch, name)
    case = CASES[name]
    assert_same_cfg(case.cfg, want.cfg)
    assert_same_tags(make_tags(case.tags), want.tags)
    assert (case.n_rounds, case.seed, case.tiles) == (want.n_rounds, want.seed, want.tiles)


def test_wideband8_capture_and_count_match_jax(monkeypatch):
    """The full-size 16 Msps capture bit for bit, its expected count, and
    the decoder's configuration, table size and one-position mesh."""
    import gen2_rfid_tpu.shard.decode_sharded as ref_sharded

    made = {}

    def record(cfg, mesh, events_per_shard):
        made.update(cfg=cfg, mesh=dict(mesh.shape), eps=events_per_shard)
        return None

    monkeypatch.setattr(ref_sharded, "make_sharded_decoder", record)
    iq2, _, expected = root_script("bench_configs").case_wideband8()
    case = CASES["wideband8"]
    wide, occupied = case.capture()
    assert bit_equal(to_planar(wide).numpy(), iq2)
    assert sum(n for _, n in occupied.values()) == expected == 108
    assert occupied == {1: (27, 54), 6: (99, 54)}
    assert_same_cfg(case.cfg, made["cfg"])
    assert (case.events_per_shard, made["mesh"]) == (160, {"time": 1, "chan": 1})
    assert case.n_chan == 8


class _Stop(Exception):
    pass


class FakeSynth:
    """A stand-in ``synthesize_inventory``: records its arguments and
    returns a ``K``-sample trace of one expected EPC."""

    K = 7

    def __init__(self):
        self.calls = []

    def __call__(self, cfg, tags, **kw):
        self.calls.append((cfg, tags, kw))
        return types.SimpleNamespace(iq=np.arange(self.K, dtype=np.complex64),
                                     expected_epc_pass=1)

    def same_as(self, other):
        assert len(self.calls) == len(other.calls) == 1
        (cfg, tags, kw), (ref_cfg, ref_tags, ref_kw) = self.calls[0], other.calls[0]
        assert_same_cfg(cfg, ref_cfg)
        assert_same_tags(tags, ref_tags)
        assert kw == ref_kw


def test_flagship_spec_matches_jax(monkeypatch):
    import gen2_rfid_tpu.runtime.inventory as ref_inventory
    import gen2_rfid_tpu.sim.trace as ref_trace

    ref_synth, synth, planar = FakeSynth(), FakeSynth(), []

    def stop(iq):
        planar.append(np.asarray(iq).size)
        raise _Stop

    monkeypatch.setattr(ref_trace, "synthesize_inventory", ref_synth)
    monkeypatch.setattr(ref_inventory, "to_planar", stop)
    with pytest.raises(_Stop):
        root_script("bench").main()
    monkeypatch.setattr(bench, "synthesize_inventory", synth)
    w = FLAGSHIP.workload(CPU)
    synth.same_as(ref_synth)
    assert synth.calls[0][2] == {"n_rounds": 80, "seed": 2}
    assert w.x2.shape == (2, planar[0]) and planar[0] == FakeSynth.K * 8
    assert w.epcs == (8,)


def test_scaling_spec_matches_jax(monkeypatch, capsys):
    """bench_scaling.py on the 8 forced CPU devices: n_time 1 and 8, the
    tiles, the padding to 8 x decim and each decoder's table, against the
    twin's ``workloads`` at 8 positions."""
    import gen2_rfid_tpu.shard.decode_sharded as ref_sharded
    import gen2_rfid_tpu.sim.trace as ref_trace

    jbs = root_script("bench_scaling")
    ref_synth, synth, decoders, measured = FakeSynth(), FakeSynth(), [], []

    def make(cfg, mesh, events_per_shard):
        decoders.append((mesh.shape["time"], events_per_shard))
        return None

    def measure(run, iq2, expected):
        measured.append((tuple(iq2.shape), expected))
        return 1.0

    monkeypatch.setattr(ref_trace, "synthesize_inventory", ref_synth)
    monkeypatch.setattr(ref_sharded, "make_sharded_decoder", make)
    monkeypatch.setattr(jbs, "_measure", measure)
    jbs.main()
    assert json.loads(capsys.readouterr().out)["n_devices"] == 8
    monkeypatch.setattr(bench, "synthesize_inventory", synth)
    ws = bench_scaling.workloads(bench_scaling.scaling_case(8), [CPU] * 8)
    synth.same_as(ref_synth)
    assert decoders == [(k, w.decode.events_per_shard) for k, w in ws.items()] == [
        (1, 2048), (8, 256)]
    assert [w.decode.n_time for w in ws.values()] == [1, 8]
    assert measured == [(tuple(w.x2.shape), w.epcs[0]) for w in ws.values()] == [
        ((1, 2, 80), 8)] * 2


# ---- mains ------------------------------------------------------------------------

def test_bench_main_on_cpu(capsys):
    rc, lines, _ = run_main(bench, ["--rounds", "2", "--tiles", "1", "--decodes", "2"], capsys)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    check_line(line, JAX_KEYS | ADDED_KEYS | {"roles"})
    assert line["metric"] == "iq_decode_throughput" and line["unit"] == "Msamples/s/chip"
    assert line["launches"] == NO_LAUNCHES and line["epcs"] == 2
    assert line["band"][0] <= line["value"] <= line["band"][1]
    assert line["vs_baseline"] == pytest.approx(line["value"] * 1e6 / 2e6)
    assert line["roles"]["query_rows"] == line["roles"]["ack_rows"] == 2


def test_bench_configs_main_runs_every_case_in_order(monkeypatch, capsys):
    """Without ``--configs``, one line per case in the JAX script's order
    (``test_torch_bench_mains.py`` runs each case's line on the CPU)."""
    ran = []
    monkeypatch.setattr(bench_configs, "bench_case",
                        lambda name, *a: ran.append((name, a)) or {"metric": name})
    rc, lines, _ = run_main(bench_configs, ["--rounds", "2", "--decodes", "3"], capsys)
    assert rc == 0 and [line["metric"] for line in lines] == list(CASES)
    assert ran == [(name, (3, CPU, 2, None)) for name in CASES]
    with pytest.raises(SystemExit):
        bench_configs.main(["--configs", "nope", "--device", "cpu"])


@pytest.mark.parametrize("argv", [["--decodes", "0"], ["--rounds", "0"], ["--tiles", "-1"],
                                  ["--positions", "0"]])
def test_mains_refuse_counts_below_one(argv):
    module = bench_scaling if argv[0] == "--positions" else bench
    with pytest.raises(SystemExit):
        module.main(argv + ["--device", "cpu"])


def test_bench_scaling_main_on_cpu(capsys):
    rc, lines, _ = run_main(bench_scaling, ["--positions", "4", "--rounds", "2",
                                            "--decodes", "2"], capsys)
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    check_line(line, SCALING_KEYS | ADDED_KEYS | {"positions", "band"})
    assert (line["n_devices"], line["positions"]) == (1, 4)
    assert line["epcs"] == 8 and line["samples_per_iter"] % (4 * 5) == 0
    assert set(line["decode_ms"]) == set(line["launches"]) == {"1", "n"}
    assert line["value"] == pytest.approx(line["msps_n"] / (4 * line["msps_1"]))


@pytest.mark.parametrize("module,argv", [
    (bench, []), (bench_configs, ["--configs", "blf160"]), (bench_scaling, ["--positions", "2"]),
], ids=["bench", "bench_configs", "bench_scaling"])
def test_wrong_count_exits_1(monkeypatch, capsys, module, argv):
    """A decode that reads one EPC fewer than its capture holds: FATAL, exit 1,
    no line."""
    real = bench.synthesize_inventory

    def one_more(*a, **kw):
        tr = real(*a, **kw)
        tr.expected_epc_pass += 1
        return tr

    monkeypatch.setattr(bench, "synthesize_inventory", one_more)
    rc, lines, err = run_main(module, argv + ["--rounds", "2", "--tiles", "1",
                                              "--decodes", "1"], capsys)
    assert rc == 1 and lines == [] and "FATAL" in err and "mismatch" in err


@pytest.mark.parametrize("name", ["bench", "bench_configs", "bench_scaling"])
def test_refuses_without_cuda(name):
    """``python -m`` without a CUDA device and without ``--device cpu``: a
    non-zero exit naming the way out, and no line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", f"gen2_rfid_tpu_torch.tools.{name}"],
                         cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
