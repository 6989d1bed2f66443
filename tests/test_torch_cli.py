"""The port's CLI (``python -m gen2_rfid_tpu_torch.apps.reader``) against the
JAX package's, in process, on the same capture files.

Each command runs through the JAX CLI's ``main`` and the port's ``main``
with ``--device cpu``; their standard output must be equal line for line,
but for the wall-time lines ("| Decoded ... in X s (Y Msamples/s)", "|
Channelized+decoded ..."), which must keep their format.  ``--report``
files are equal record for record, ``simulate`` files byte for byte, and
the return codes are equal.  Without CUDA and without ``--device`` the
port's CLI decodes nothing and exits non-zero.

One kind of line may differ in its last digits: a tag's signal line
("| Tag 0x..: RSSI ... phase ... spread ..."), whose numbers come from the
decodes' float32 channel estimates, which agree to 1e-4 of their largest
magnitude (``torch_compare``), not bit for bit.  Its text must be equal and
each number within one step of its last printed digit, the phase spread
within 0.03 degrees: a tag read once has a spread of sqrt(-2 ln r) with r
the float32 length of one unit vector, 0 or one rounding below 1, which is
0.02 degrees (the JAX CLI prints "0.02", the port "-0.00" on the fixed-Q
capture here).  The reports' arithmetic itself is the JAX package's: on the
same decoded fields the reports are equal (tests/test_torch_reports.py).
"""

import json
import re

import numpy as np
import pytest
import torch

from gen2_rfid_tpu.apps.reader import main as ref_main
from gen2_rfid_tpu_torch.apps import reader
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.io.tracefile import write_trace
from gen2_rfid_tpu_torch.runtime.ranging import C_LIGHT
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from torch_compare import one_torch_thread, two_reader_wideband  # noqa: F401

WALL = re.compile(r"^\| (Decoded \d+ samples|Channelized\+decoded \d+ wideband samples) "
                  r"in \d+\.\d\d s \(\d+\.\d Msamples/s\)$")
# live's per-slot wall time: its slot count is kept.
LATENCY = re.compile(r"^\| Slot latency: \d+\.\d ms p50 / \d+\.\d ms p95 over (\d+) slots$")
HOPS_MHZ = (902.75, 915.25, 927.25)


def _masked(text):
    """Output lines with each wall-time line checked for its format and
    replaced by its words before the time."""
    out = []
    for line in text.splitlines():
        m = WALL.match(line)
        lat = LATENCY.match(line)
        out.append(f"<{m.group(1)}>" if m else f"<latency over {lat.group(1)} slots>"
                   if lat else line)
    return out


# A printed float, and how far a tag's signal line may move it.
NUMBER = re.compile(r"([+-]?\d+\.\d+)")
SPREAD_TOL_DEG = 0.03


def _same_lines(got, want):
    """Equal lines, but for a tag's signal line, whose text is equal and
    whose numbers agree to a step of their last printed digit."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if g == w:
            continue
        assert g.startswith("| Tag 0x") and " RSSI " in g, (g, w)
        gs, ws = NUMBER.split(g), NUMBER.split(w)
        assert gs[0::2] == ws[0::2], (g, w)
        for k in range(1, len(ws), 2):
            step = 10.0 ** -len(ws[k].split(".")[1])
            tol = SPREAD_TOL_DEG if ws[k - 1].endswith("(spread ") else step
            assert abs(float(gs[k]) - float(ws[k])) <= tol * 1.0001, (g, w)


def _both(capsys, argv):
    """(rc, stdout lines) of the JAX CLI and of the port's on ``argv``."""
    capsys.readouterr()
    rc_ref = ref_main(list(argv))
    ref_out = capsys.readouterr().out
    rc = reader.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    return (rc, _masked(out)), (rc_ref, _masked(ref_out))


def _same(capsys, argv):
    (rc, got), (rc_ref, want) = _both(capsys, argv)
    assert rc == rc_ref
    _same_lines(got, want)
    return got


def _sic_scene():
    """tests/test_collision.py's 4-round same-seed scene: tags 0x41 and 0x77
    answer every ACK together."""
    rng = np.random.default_rng(31)

    def mk(tid, bs):
        epc = rng.integers(0, 2, 96)
        for k in range(8):
            epc[88 + k] = (tid >> (7 - k)) & 1
        return Tag(epc96=epc, seed=5, backscatter=bs)

    tags = [mk(0x41, 0.09 + 0.02j), mk(0x77, 0.04 - 0.035j)]
    return synthesize_inventory(ReaderConfig(max_events=64), tags, n_rounds=4, seed=12).iq


def _mrc_scene(n_ant):
    """A lambda/4 line of ``n_ant`` antennas with tag 27 at a 25 degree
    bearing (tests/test_ranging.py's array, 4 rounds a channel): (antenna
    positions, captures cut to the shortest)."""
    cfg = ReaderConfig(max_events=64)
    pos = [k * C_LIGHT / cfg.freq_hz / 4 for k in range(n_ant)]
    s = np.sin(np.radians(25.0))
    chans = [synthesize_inventory(
        cfg, [Tag.with_id(27, seed=7, backscatter=0.08 * np.exp(
            1j * (0.4 + 2 * np.pi * cfg.freq_hz * x * s / C_LIGHT)))],
        n_rounds=4, seed=int(x * 1e4) + 5).iq for x in pos]
    n = min(c.size for c in chans)
    return pos, [c[:n] for c in chans]


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """Capture files, written once: two simulated single-tag captures (the
    second for the merge), a three-tag FIXED_Q=2 capture, the SIC scene, a
    two-antenna array, a two-reader wideband capture and three hop
    captures of one tag at 2.4 m."""
    d = tmp_path_factory.mktemp("cli")
    paths = {"a": d / "a.bin", "b": d / "b.bin", "q2": d / "q2.bin"}
    for key, argv in (("a", ["--rounds", "3", "--tags", "27", "--seed", "5"]),
                      ("b", ["--rounds", "4", "--tags", "9", "--seed", "5"]),
                      ("q2", ["--rounds", "3", "--tags", "5", "9", "27", "--q", "2",
                              "--seed", "7"])):
        assert reader.main(["simulate", str(paths[key]), *argv]) == 0
    for k, f in enumerate(HOPS_MHZ):
        paths[f"hop{k}"] = d / f"hop{k}.bin"
        assert reader.main(["simulate", str(paths[f"hop{k}"]), "--rounds", "3", "--tags", "27",
                            "--distance", "2.4", "--freq-mhz", str(f)]) == 0
    paths["sic"] = d / "sic.bin"
    write_trace(str(paths["sic"]), _sic_scene())
    pos, chans = _mrc_scene(2)
    for k, c in enumerate(chans):
        paths[f"ant{k}"] = d / f"ant{k}.bin"
        write_trace(str(paths[f"ant{k}"]), c)
    paths["wide"] = d / "wide.bin"
    write_trace(str(paths["wide"]), two_reader_wideband()[0])
    paths["pos"] = pos
    return {k: (v if k == "pos" else str(v)) for k, v in paths.items()}


DECODES = {
    "verbose": lambda c: ["decode", c["a"], "-v", "--max-events", "64"],
    "chunked": lambda c: ["decode", c["a"], "--chunked", "-v", "--max-events", "64"],
    "exact_gate": lambda c: ["decode", c["a"], "--exact-gate", "--max-events", "64"],
    "fixed_q": lambda c: ["decode", c["q2"], "--q", "2", "-v", "--max-events", "64"],
    "merged": lambda c: ["decode", c["a"], c["b"], "-v", "--max-events", "64"],
    "epc_sic": lambda c: ["decode", c["sic"], "--epc-sic", "--max-events", "64"],
    "mrc": lambda c: ["decode", c["ant0"], c["ant1"], "--mrc", "-v", "--max-events", "64",
                      "--antenna-pos", *map(str, c["pos"])],
    "wideband": lambda c: ["decode", c["wide"], "--wideband", "2", "--max-events", "64"],
}
# What each form must show besides equality, so that an empty run cannot pass.
EXPECT = {
    "verbose": ["| Correctly decoded EPC : 3", "| Tag ID : 1b  Num of reads : 3",
                "| Slots: 3 single / 0 empty / 0 collision"],
    "chunked": ["| Correctly decoded EPC : 3"],
    "exact_gate": ["| Correctly decoded EPC : 3"],
    "fixed_q": ["| Number of unique tags : 3"],
    "merged": ["| Correctly decoded EPC : 7", "| Tag ID : 9  Num of reads : 4"],
    "epc_sic": ["| EPC-window SIC: 4 extra EPCs recovered", "| Tag 0x77 (SIC residual): 4 reads"],
    "mrc": ["| Correctly decoded EPC : 4"],
    "wideband": ["=== channel 0 (+0.0 MHz) ===", "=== channel 1 (-2.0 MHz) ==="],
}


@pytest.mark.parametrize("form", sorted(DECODES))
def test_decode_matches_jax(capsys, caps, form):
    lines = _same(capsys, DECODES[form](caps))
    for want in EXPECT[form]:
        assert want in lines, (form, want)
    assert lines[-1].startswith("<")              # the wall-time line, in its format


def test_verbose_prints_the_per_tag_line(capsys, caps):
    lines = _same(capsys, DECODES["verbose"](caps))
    assert any(line.startswith("| Tag 0x1b: RSSI ") and "radial v" in line for line in lines)
    lines = _same(capsys, DECODES["mrc"](caps))
    bearing = [line for line in lines if line.startswith("| Tag 0x1b: bearing ")]
    assert len(bearing) == 1
    assert abs(float(bearing[0].split()[4]) - 25.0) < 1.0


def test_report_records_match_jax(capsys, caps, tmp_path):
    got_path, want_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    capsys.readouterr()
    assert ref_main(["decode", caps["a"], "--report", str(want_path), "--freq-mhz", "915"]) == 0
    want_out = _masked(capsys.readouterr().out)
    assert reader.main(["--device", "cpu", "decode", caps["a"], "--report", str(got_path),
                        "--freq-mhz", "915"]) == 0
    got_out = _masked(capsys.readouterr().out)
    assert [line.replace(str(got_path), "FILE") for line in got_out] == \
        [line.replace(str(want_path), "FILE") for line in want_out]
    got = [json.loads(line) for line in got_path.read_text().splitlines()]
    want = [json.loads(line) for line in want_path.read_text().splitlines()]
    assert got == want and len(got) == 3
    assert all(r["tag_id"] == 27 and r["channel_mhz"] == 915.0 for r in got)
    # '-' writes the records to stdout, as the JAX CLI does.
    lines = _same(capsys, ["decode", caps["a"], "--report", "-"])
    recs = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(recs) == 3 and all("channel_mhz" not in r for r in recs)


def test_range_matches_jax(capsys, caps):
    argv = ["range", caps["hop0"], caps["hop1"], caps["hop2"],
            "--freqs-mhz", *map(str, HOPS_MHZ), "--max-events", "64"]
    lines = _same(capsys, argv)
    assert len(lines) == 1 and lines[0].startswith("| Tag 0x1b: range ")
    assert abs(float(lines[0].split()[4]) - 2.4) < 0.01


def test_simulate_files_are_byte_identical(capsys, tmp_path):
    for argv in (["--rounds", "2", "--tags", "27", "9", "--q", "1", "--seed", "3"],
                 ["--rounds", "6", "--tags", "5", "--adaptive", "--q", "1"],
                 ["--rounds", "2", "--tags", "27", "--miller", "4", "--epc-words", "4",
                  "--distance", "1.5", "--velocity", "0.5", "--freq-mhz", "910",
                  "--corrupt", "1"]):
        a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
        capsys.readouterr()
        assert reader.main(["simulate", str(a), *argv]) == 0
        got = capsys.readouterr().out.replace(str(a), "OUT")
        assert ref_main(["simulate", str(b), *argv]) == 0
        want = capsys.readouterr().out.replace(str(b), "OUT")
        assert got == want
        assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0


def test_golden_file_and_tuple(capsys, tmp_path):
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    capsys.readouterr()
    assert reader.main(["golden", str(a)]) == 0
    got = capsys.readouterr().out.replace(str(a), "OUT")
    assert ref_main(["golden", str(b)]) == 0
    assert got == capsys.readouterr().out.replace(str(b), "OUT")
    assert a.read_bytes() == b.read_bytes()
    assert reader.main(["--device", "cpu", "decode", str(a)]) == 0
    lines = capsys.readouterr().out.splitlines()
    for want in ("| Number of queries/queryreps sent : 71", "| Current Inventory round : 72",
                 "| Correctly decoded EPC : 70", "| Number of unique tags : 1",
                 "| Tag ID : 1b  Num of reads : 70"):
        assert want in lines


@pytest.mark.parametrize("argv,rc", [(["txspec", "--tx-shape", "2.5"], 0), (["txspec"], 1)])
def test_txspec_matches_jax(capsys, argv, rc):
    (got_rc, got), want = _both(capsys, argv)
    assert (got_rc, got) == want and got_rc == rc
    assert got[-3].endswith("PASS" if rc == 0 else "FAIL")


def test_no_device_refuses(capsys, caps, monkeypatch):
    """Without CUDA and without --device the decode commands and live exit
    non-zero with resolve_device's message and print no report; the
    commands that decode nothing still run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    for argv in (["decode", caps["a"]], ["decode", caps["a"], "--chunked"],
                 ["range", caps["hop0"], "--freqs-mhz", "902.75"],
                 ["live", "--rounds", "1"]):
        assert reader.main(argv) != 0
        out, err = capsys.readouterr()
        assert out == "" and "no CUDA device" in err and "--device cpu" in err
    assert reader.main(["txspec", "--tx-shape", "2.5"]) == 0


def test_main_turns_tf32_off(capsys, caps, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert reader.main(["txspec", "--tx-shape", "2.5"]) == 0
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_parser_has_every_decode_flag_of_the_jax_cli():
    """Every subcommand's options are the JAX CLI's, live's too; the port
    adds only --device, and decode's --trace-dir (its profiler trace)."""
    from gen2_rfid_tpu.apps.reader import build_parser as ref_parser

    def options(p):
        sub = next(a for a in p._actions if a.dest == "cmd")
        top = {o for a in p._actions for o in a.option_strings}
        return top, {name: {o for a in sp._actions for o in a.option_strings}
                     for name, sp in sub.choices.items()}

    top, cmds = options(reader.build_parser())
    ref_top, ref_cmds = options(ref_parser())
    assert top == ref_top | {"--device"}
    assert set(cmds) == set(ref_cmds)
    for name, opts in cmds.items():
        added = {"--trace-dir"} if name == "decode" else set()
        assert opts == ref_cmds[name] | added, name


@pytest.mark.parametrize("argv,want", [
    (["live", "--rounds", "3", "--tags", "27", "9", "--sic"],
     ["| Correctly decoded EPC : 3", "| Collided slots recovered via SIC: 3"]),
    (["live", "--rounds", "8", "--tags", "16", "32", "48", "--q", "2", "--session-ab"],
     ["| Inventory target flips (A<->B): 3"]),
], ids=["sic", "session_ab"])
def test_live_matches_jax(capsys, argv, want):
    """The closed-loop inventory prints the JAX CLI's lines, its slot
    latency line but for the times: the SIC pair reads 3 EPCs and recovers
    3 collided slots, the session inventory flips its target 3 times."""
    got = _same(capsys, argv)
    assert set(want) <= set(got)
    assert any(line.startswith("<latency over ") for line in got)


def test_live_uhd_radio_fails_as_the_jax_cli_does(capsys):
    """Without the uhd package ``--radio uhd`` raises the radio adapter's
    error in both CLIs."""
    with pytest.raises(RuntimeError) as ref_err:
        ref_main(["live", "--radio", "uhd", "--rounds", "1"])
    with pytest.raises(RuntimeError) as err:
        reader.main(["--device", "cpu", "live", "--radio", "uhd", "--rounds", "1"])
    assert str(err.value) == str(ref_err.value) and "uhd" in str(err.value)
