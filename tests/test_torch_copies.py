"""The port's copies of the JAX package's pure-numpy modules match their originals.

The port imports nothing of ``gen2_rfid_tpu``, so it keeps its own copies of
the configuration, the CRC, the tag crypto suites, the simulator chain and
its RX impairments, the SigMF and raw trace readers and writers (with the
EPC tag-data standards its annotations name), the ranging estimators, the
command sniffer, the TX spectrum, the native engine's C++ source, the
fixtures' recipes, the live loop's simulated air interface and radio
adapter, and its access, RF-management and statistics mixins.  These tests hold
each copy to its original: the source text, every relative import (which
must resolve inside the port), every config field and derived property, the
simulator's captures and crypto answers, and the fixtures' bytes.
"""

import ast
import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import gen2_rfid_tpu.config as ref_config
import gen2_rfid_tpu.io.sigmf as ref_sigmf
import gen2_rfid_tpu.protocol.crc as ref_crc
import gen2_rfid_tpu.sim.tag as ref_tag
import gen2_rfid_tpu.sim.trace as ref_trace
import gen2_rfid_tpu_torch.config as port_config
import gen2_rfid_tpu_torch.protocol.crc as port_crc
import gen2_rfid_tpu_torch.sim.tag as port_tag
import gen2_rfid_tpu_torch.sim.trace as port_trace
from gen2_rfid_tpu_torch.carry import config_from_fields
from gen2_rfid_tpu_torch.io import sigmf as port_sigmf
from gen2_rfid_tpu_torch.tools import fixtures as port_fixtures

REPO = Path(__file__).resolve().parents[1]
COPIES = ["config.py", "protocol/crc.py", "protocol/crypto.py", "protocol/gen2.py",
          "protocol/tds.py", "tx/pie.py", "sim/tag.py", "sim/trace.py", "io/sigmf.py",
          "runtime/ranging.py", "io/tracefile.py", "runtime/sniffer.py", "tx/spectrum.py",
          "sim/impairments.py", "native/gen2_stream.cc", "sim/channel.py", "io/radio.py",
          "runtime/live_access.py", "runtime/live_rf.py", "runtime/live_stats.py"]
# The copies whose relative imports resolve: the C++ engine source has none.
PY_COPIES = [rel for rel in COPIES if rel.endswith(".py")]

CONFIGS = [
    dict(),
    dict(max_events=1536),
    dict(fixed_q=2),
    dict(mode="compat"),
    dict(miller_m=4, track_channel=True),
    dict(epc_grid_frac=0.04, epc_grid_steps=33),
    dict(adc_rate=4e6, decim=10, trext=1),
]
PROPERTIES = [
    name for name, v in vars(ref_config.ReaderConfig).items()
    if isinstance(v, property)
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_source_matches_original(rel):
    """Relative imports resolve inside each package, so the copies are
    verbatim: any edit to either side shows up here."""
    port = (REPO / "gen2_rfid_tpu_torch" / rel).read_text()
    ref = (REPO / "gen2_rfid_tpu" / rel).read_text()
    assert port == ref


def _relative_imports(rel):
    """(line, absolute module, imported names) of every ``from .`` / ``from
    ..`` import in a copied module, the lazy ones inside functions too,
    resolved against the port's package."""
    path = REPO / "gen2_rfid_tpu_torch" / rel
    package = ("gen2_rfid_tpu_torch." + rel[:-3].replace("/", ".")).rsplit(".", 1)[0]
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom) and node.level:
            name = importlib.util.resolve_name("." * node.level + (node.module or ""), package)
            yield node.lineno, name, [a.name for a in node.names]


@pytest.mark.parametrize("rel", PY_COPIES)
def test_copy_relative_imports_resolve_in_port(rel):
    """A verbatim copy can name a module the port lacks (the byte check
    above cannot see it): every relative import, lazy ones included, must
    find its module and names inside ``gen2_rfid_tpu_torch``."""
    for line, name, names in _relative_imports(rel):
        assert name.startswith("gen2_rfid_tpu_torch."), (rel, line, name)
        assert importlib.util.find_spec(name) is not None, f"{rel}:{line}: no module {name}"
        mod = importlib.import_module(name)
        for n in names:
            assert hasattr(mod, n) or importlib.util.find_spec(f"{name}.{n}") is not None, (
                f"{rel}:{line}: {name} has no {n}")


def test_copies_have_lazy_imports_to_check():
    """The scan sees the lazy crypto imports inside Tag's methods and the
    spectrum's lazy import of the sniffer."""
    found = {(name, tuple(names)) for _, name, names in _relative_imports("sim/tag.py")}
    assert ("gen2_rfid_tpu_torch.protocol", ("crypto",)) in found
    assert any(n == "gen2_rfid_tpu_torch.protocol.crypto" for n, _ in found)
    found = {(name, tuple(names)) for _, name, names in _relative_imports("tx/spectrum.py")}
    assert ("gen2_rfid_tpu_torch.runtime.sniffer", ("sniff_commands",)) in found


def test_tag_crypto_answers_match():
    """TAM1 (AES-128 and PRESENT-80), TAM2 and KeyUpdate on the port's Tag
    return what the reference's returns for the same keys and inputs."""
    import gen2_rfid_tpu.protocol.crypto as ref_crypto

    keys = {0: bytes(range(16)), 1: bytes(range(10, 20)), 2: bytes(range(5, 21))}
    rng = np.random.default_rng(3)
    c96 = rng.integers(0, 2, 96)
    c48 = rng.integers(0, 2, 48)
    enc = rng.integers(0, 2, 128)
    answers = []
    for tag_mod in (ref_tag, port_tag):
        tag = tag_mod.Tag.with_id(27, seed=7, aes_keys=dict(keys))
        got = [tag.tam1_answer(ref_crypto.CSI_AES128, 0, c96),
               tag.tam1_answer(ref_crypto.CSI_PRESENT80, 1, c48),
               tag.tam1_answer(ref_crypto.CSI_AES128, 1, c96),           # wrong suite: None
               tag.tam2_answer(ref_crypto.CSI_AES128, 2, c96, (0, 1), 0, 1),
               tag.install_key(ref_crypto.CSI_AES128, 2, enc),
               tag.aes_keys[2],
               tag.tam1_answer(ref_crypto.CSI_AES128, 2, c96)]
        answers.append(got)
    ref, port = answers
    assert ref[0].size == 128 and ref[1] is not None and ref[2] is None
    assert ref[3] is not None and ref[4] is True and ref[5] != keys[2]
    for a, b in zip(ref, port):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(kw) or "default")
def test_config_fields_and_properties_match(kw):
    ref = ref_config.ReaderConfig(**kw)
    port = port_config.ReaderConfig(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert len(PROPERTIES) >= 30
    for name in PROPERTIES:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.reply_window(32) == ref.reply_window(32)
    assert config_from_fields(dataclasses.asdict(ref)) == port


def test_config_for_link_matches():
    for blf, tari, dr in [(40e3, 24.0, 0), (80e3, 25.0, 0), (640e3, 6.25, 1)]:
        ref = ref_config.ReaderConfig.for_link(blf, tari_us=tari, dr=dr)
        port = port_config.ReaderConfig.for_link(blf, tari_us=tari, dr=dr)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_samples_tag_bit == ref.n_samples_tag_bit


@pytest.mark.parametrize("n_bits", [16, 32, 96, 112, 128, 480])
def test_crc16_affine_matches(n_bits):
    m_p, c_p = port_crc.crc16_affine(n_bits)
    m_r, c_r = ref_crc.crc16_affine(n_bits)
    np.testing.assert_array_equal(m_p, m_r)
    np.testing.assert_array_equal(c_p, c_r)
    rng = np.random.default_rng(n_bits)
    data = rng.integers(0, 2, n_bits)
    np.testing.assert_array_equal(port_crc.crc16_bits(data),
                                  ref_crc.crc16_bits(data))


def _same_trace(port_tr, ref_tr):
    assert port_tr.iq.dtype == ref_tr.iq.dtype
    assert port_tr.iq.tobytes() == ref_tr.iq.tobytes()
    assert port_tr.expected_epc_pass == ref_tr.expected_epc_pass
    assert port_tr.expected_tag_reads == ref_tr.expected_tag_reads


def test_golden_trace_bytes_match():
    _same_trace(port_trace.golden_trace(port_config.ReaderConfig()),
                ref_trace.golden_trace(ref_config.ReaderConfig()))


def test_bench_scene_bytes_match():
    """bench.py's scene: 80 rounds of tag 0x1b, seed 2, max_events=1536."""
    kw = dict(n_rounds=80, seed=2)
    port = port_trace.synthesize_inventory(
        port_config.ReaderConfig(max_events=1536), [port_tag.Tag.with_id(27, seed=7)], **kw)
    ref = ref_trace.synthesize_inventory(
        ref_config.ReaderConfig(max_events=1536), [ref_tag.Tag.with_id(27, seed=7)], **kw)
    _same_trace(port, ref)
    assert port.expected_epc_pass == 80


def test_multitag_q2_scene_bytes_match():
    """tests/test_golden.py's FIXED_Q=2 scene: 3 tags, 6 rounds, seed 5."""
    def scene(cfg_mod, tag_mod, trace_mod):
        tags = [tag_mod.Tag.with_id(i + 1, seed=i, backscatter=0.08 + 0.02j)
                for i in range(3)]
        return trace_mod.synthesize_inventory(
            cfg_mod.ReaderConfig(fixed_q=2), tags, n_rounds=6, seed=5)

    _same_trace(scene(port_config, port_tag, port_trace),
                scene(ref_config, ref_tag, ref_trace))


def _make_fixtures():
    """tools/make_fixtures.py, loaded as tests/test_fixture.py loads it."""
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", REPO / "tools" / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_specs_match():
    """The port's recipes are tools/make_fixtures.py's, field for field."""
    ref = _make_fixtures().fixture_specs()
    port = port_fixtures.fixture_specs()
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert dataclasses.asdict(port[name]["cfg"]) == dataclasses.asdict(ref[name]["cfg"])
        assert port[name]["synth"] == ref[name]["synth"]
        assert len(port[name]["tags"]) == len(ref[name]["tags"])
        for a, b in zip(port[name]["tags"], ref[name]["tags"]):
            fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
            assert sorted(fa) == sorted(fb)
            for k in fa:
                np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(port_fixtures.fixture_specs()))
def test_port_regenerates_fixture_bytes(tmp_path, name):
    """The port's simulator and SigMF writer regenerate each committed
    fixture byte for byte, and its reader loads what the original loads."""
    cfg, tr = port_fixtures.synthesize(name)
    base = str(tmp_path / name)
    port_sigmf.save_sigmf(base, tr.iq, cfg, description=f"gen2_rfid_tpu pinned fixture {name}",
                          datatype="ci16_le")
    fixture = REPO / "tests" / "fixtures" / name
    for suffix in (".sigmf-data", ".sigmf-meta"):
        assert Path(base + suffix).read_bytes() == Path(str(fixture) + suffix).read_bytes()
    iq, meta = port_sigmf.load_sigmf(str(fixture))
    ref_iq, ref_meta = ref_sigmf.load_sigmf(str(fixture))
    assert iq.tobytes() == ref_iq.tobytes() and meta == ref_meta
