"""The port's span recorder (``gen2_rfid_tpu_torch/utils/profiling.py``) on
the CPU: the span tree of a golden decode, the off path, the profiler's
trace, the self-time arithmetic, the buffer's bound and sessions, the
benchmark's span readers (``rfidbench/metrics``) and the decode's outputs
with recording on and off.  The card's checks of the same spans are in
``tests/test_torch_cuda.py``.
"""

import json
import types

import pytest
import torch

from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp.gate import gate_detect
from gen2_rfid_tpu_torch.kernels import _build
from gen2_rfid_tpu_torch.runtime.inventory import decode_capture_planar, to_planar
from gen2_rfid_tpu_torch.sim.trace import golden_trace
from gen2_rfid_tpu_torch.utils import profiling
from rfidbench.cells import metric_reader
from rfidbench.trace import Op, Trace

CFG = ReaderConfig()
STAGES = ["gen2.front", "gen2.gate", "gen2.decode_events", "gen2.replay"]
# The host syncs of a native FM0 decode: one read, inside the replay, takes
# the role tables' overflow flag and the closed form's verdict together,
# once the whole decode is queued.  No host table is copied: the first
# decode on a device copies them (the pulse-count table; the preamble
# search's three tables; the RN16's half-bit offsets; the period search's
# probes and grid; the EPC's two bit-position tables; the PC-aware CRC's
# three products, its constant and two bit weights) and keeps them there,
# and ``golden_x2`` makes that decode.
READS, COPIES = 1, 0
SPAN_READERS = ["front_ms", "gate_ms", "decode_events_ms", "replay_ms",
                "host_syncs_per_decode", "host_wait_ms"]


@pytest.fixture(scope="module")
def golden_x2():
    x2 = to_planar(golden_trace(CFG).iq)
    decode(x2)
    return x2


def decode(x2):
    return decode_capture_planar(x2, CFG, device="cpu")


def recorded(x2, n=1):
    with profiling.recording():
        outs = [decode(x2) for _ in range(n)]
    return outs, profiling.spans()


def test_golden_decode_span_tree(golden_x2):
    (out,), rows = recorded(golden_x2)
    assert int(out[0].n_epc_correct) == 70
    roots = [r for r in rows if r["parent"] is None]
    assert [r["name"] for r in roots] == ["gen2.decode_capture"]
    root = roots[0]
    assert root["index"] == 0 and root["attrs"] == {"samples": golden_x2.shape[1]}
    stages = [r for r in rows if r["parent"] == root["index"]]
    assert [r["name"] for r in stages] == STAGES
    by_index = {r["index"]: r for r in rows}
    for r in rows:
        assert r["decode"] == root["decode"]
        if r is not root:
            assert r["parent"] in by_index and by_index[r["parent"]]["index"] < r["index"]
    syncs = [r for r in rows if r["name"] in (profiling.HOST_READ, profiling.HOST_COPY)]
    assert all(by_index[r["parent"]]["name"] in ("gen2.decode_events", "gen2.replay")
               for r in syncs)
    assert sum(r["name"] == profiling.HOST_READ for r in rows) == READS
    assert sum(r["name"] == profiling.HOST_COPY for r in rows) == COPIES
    assert len(rows) == 1 + len(STAGES) + READS + COPIES
    for r in rows:
        assert r["device_ms"] == r["host_ms"] >= r["self_ms"] >= 0


def test_off_records_nothing(golden_x2, monkeypatch):
    """Off, a decode enters no ``record_function``, makes no CUDA event,
    reads no allocator statistics and no clock in the recorder."""
    def refuse(*a, **k):
        raise AssertionError("called with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", refuse)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    with profiling.recording():
        pass
    before = len(profiling.spans())
    assert int(decode(golden_x2)[0].n_epc_correct) == 70
    with profiling.span("gen2.decode_capture", allocator=torch.device("cuda")) as s:
        assert s is profiling._OFF
    assert len(profiling.spans()) == before == 0


def test_profiler_turns_recording_on(golden_x2, tmp_path):
    """Under ``torch.profiler`` the spans are recorded without
    ``recording()``, and the Chrome trace holds each stage as an annotation
    around its own ``aten::`` operations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode(golden_x2)
    rows = profiling.spans()
    assert [r["name"] for r in rows if r["parent"] is None] == ["gen2.decode_capture"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"] in STAGES}
    assert sorted(notes) == sorted(STAGES)
    aten = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    spans = sorted(notes.values(), key=lambda e: e["ts"])
    for a, b in zip(spans, spans[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for e in spans:
        inside = [o for o in aten if e["ts"] <= o["ts"] and o["ts"] + o["dur"] <= e["ts"] + e["dur"]]
        assert inside, e["name"]


def test_self_time_on_a_hand_built_tree(monkeypatch):
    """root [0, 100] ms holds a [10, 30] (which holds c [15, 25]) and
    b [40, 70]: self times 50, 10, 10 and 30."""
    clock = iter(ms * 1_000_000 for ms in (0, 10, 15, 25, 30, 40, 70, 100))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(clock)))
    with profiling.recording():
        with profiling.span("root"):
            with profiling.span("a"):
                with profiling.span("c"):
                    pass
            with profiling.span("b"):
                pass
    got = {r["name"]: (r["host_ms"], r["self_host_ms"], r["self_ms"], r["children"])
           for r in profiling.spans()}
    assert got == {"root": (100, 50, 50, 2), "a": (20, 10, 10, 1), "c": (10, 10, 10, 0),
                   "b": (30, 30, 30, 0)}
    table = profiling.span_table()
    assert list(table) == ["root", "a", "c", "b"]
    assert table["root"]["calls"] == 1 and table["root"]["self_ms"] == 50
    assert profiling._union_ms([(0, 2), (1, 3), (5, 6), (9, 12)], 0, 10) == 5


def test_buffer_bound_and_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.recording():
        for _ in range(8):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 5 and profiling.dropped() == 3


def test_a_new_session_clears_the_last():
    with profiling.recording():
        for _ in range(3):
            with profiling.span("first"):
                pass
    assert [r["decode"] for r in profiling.spans()] == [0, 1, 2]
    with profiling.recording():
        with profiling.span("second"):
            pass
    rows = profiling.spans()
    assert [(r["name"], r["decode"]) for r in rows] == [("second", 0)]
    assert profiling.dropped() == 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("third"):
            pass
    assert [r["name"] for r in profiling.spans()] == ["third"]


def test_stages_without_a_root_get_their_own_decode(golden_x2):
    y = torch.complex(*torch.randn(2, 4096))
    with profiling.recording():
        gate_detect(y, CFG, amp=y.abs())
        gate_detect(y, CFG, amp=y.abs())
    gates = [r for r in profiling.spans() if r["name"] == "gen2.gate"]
    assert [(r["parent"], r["decode"]) for r in gates] == [(None, 0), (None, 1)]


def test_host_read_returns_what_the_read_returned():
    t = torch.tensor([1, 0, 1], dtype=torch.bool)
    for x in (t.sum(), t.all(), t.to(torch.float32).mean()):
        got, want = profiling.host_read(x), x.item()
        assert got == want and type(got) is type(want)
    assert (profiling.host_read(t) == t.numpy()).all()
    copied = profiling.to_device([1.5, 2.5], torch.device("cpu"), torch.float32)
    assert torch.equal(copied, torch.as_tensor([1.5, 2.5], dtype=torch.float32))


def test_outputs_bit_equal_with_recording_on_and_off(golden_x2):
    off = decode(golden_x2)
    (on,), _ = recorded(golden_x2)
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _trace(decodes, device_ops=True):
    ops = [Op("kernel", 0.0, 1.0)] if device_ops else []
    return Trace(device=ops, host=[], start=0.0, end=10.0, decodes=decodes)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_on_cpu_decodes(golden_x2, name):
    """Each reader reads a session of two CPU decodes (device ms there is
    the host's) over a stretch that ran device ops, and finds nothing in a
    stretch of another count, with no device ops, or in an empty session."""
    read = metric_reader(name)
    _, rows = recorded(golden_x2, 2)
    value = read(_trace(2))
    assert value is not None and value > 0
    if name == "host_syncs_per_decode":
        assert value == READS + COPIES
    if name.endswith("_ms") and name != "host_wait_ms":
        span = "gen2." + name[:-3]
        assert value == pytest.approx(sum(r["device_ms"] for r in rows if r["name"] == span) / 2)
    assert read(_trace(3)) is None and read(_trace(2, device_ops=False)) is None
    with profiling.recording():
        pass
    assert read(_trace(2)) is None


def test_device_mallocs_reader(monkeypatch):
    """The root's allocator reading: new segments between its entry and its
    exit (``segment.all.allocated``), over the stretch's decodes.  The
    statistics are scripted: the CPU has no caching allocator."""
    counts = iter([{"segment": {"all": {"allocated": 4}}, "num_alloc_retries": 0},
                   {"segment": {"all": {"allocated": 7}}, "num_alloc_retries": 1}])
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda dev: next(counts))
    with profiling.recording():
        with profiling.span("gen2.decode_capture", allocator=torch.device("cuda")):
            pass
    (root,) = profiling.spans()
    assert root["attrs"] == {"segment_allocs": 3, "alloc_retries": 1}
    read = metric_reader("device_mallocs_per_decode")
    assert read(_trace(1)) == 3 and read(_trace(2)) is None


def test_device_mallocs_reader_finds_nothing_on_the_cpu(golden_x2):
    recorded(golden_x2)
    assert metric_reader("device_mallocs_per_decode")(_trace(1)) is None


def test_kernel_build_s_reads_build_seconds(monkeypatch):
    read = metric_reader("kernel_build_s")
    monkeypatch.setattr(_build, "build_seconds", {"gate_front": 1.5, "gate_stack": 2.25})
    assert read(_trace(1)) == 3.75
    monkeypatch.setattr(_build, "build_seconds", {})
    assert read(_trace(1)) == 0.0 and read(_trace(1, device_ops=False)) is None


def test_reader_cli_writes_the_trace_and_the_table(tmp_path, capsys):
    from gen2_rfid_tpu_torch.apps import reader

    cap = tmp_path / "golden.bin"
    assert reader.main(["golden", str(cap)]) == 0
    out = tmp_path / "trace"
    assert reader.main(["--device", "cpu", "decode", str(cap), "--trace-dir", str(out)]) == 0
    err = capsys.readouterr().err
    for name in ["gen2.decode_capture"] + STAGES:
        assert f"\n{name} " in err
    trace_file = next(out.iterdir())
    names = {e.get("name") for e in json.loads(trace_file.read_text())["traceEvents"]}
    assert set(STAGES) <= names
