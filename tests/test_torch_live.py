"""The port's closed-loop live reader against the JAX package's, on the CPU:
FM0 (Miller-4 in ``tests/test_torch_live_miller.py``).

The window decoder on every FM0 window decode of three JAX loops, in every
mode, and with ``epc_softfix``; whole loops of the named scenes
(``gen2_rfid_tpu_torch/tools/live_scenes.py``) and of three draws of
``tests/test_fuzz_live.py::_draw_scenario``; the reader's refusal without a
device; and ``runtime/live.py`` held to the JAX module line for line but
for the device.  ``tests/live_compare.py`` says what is compared and to
what tolerance.
"""

import dataclasses
import difflib
from pathlib import Path

import numpy as np
import pytest
import torch

import live_compare as lc
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.runtime.live import LiveReader
from gen2_rfid_tpu_torch.sim.channel import SimTagChannel
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.tools import live_scenes
from torch_compare import one_torch_thread, port_cfg  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# FM0's rn16 / epc (one_tag), sic / epc_sic (sic_pair) and access replies.
RECORDED = ("one_tag", "sic_pair", "access")


@pytest.fixture(scope="module")
def recorded():
    return lc.record(RECORDED)


@pytest.mark.parametrize("mode", lc.MODES)
def test_window_decoder_matches_jax(recorded, mode):
    lc.check_window_decoder(recorded[1], 1, mode)


def test_window_decoder_softfix_matches_jax(recorded):
    lc.check_softfix(recorded[1], 1, sigmas=(0.08, 0.1, 0.12))


LOOPS = ("one_tag", "tamper", "sic_pair", "session_ab3", "access", "auth", "nak",
         "power_down")


@pytest.mark.parametrize("name", LOOPS)
def test_live_loop_matches_jax(recorded, name):
    lc.check_loop(recorded[0], name)


def test_compat_live_loop_matches_jax():
    """A compat-mode reader: the gate reads the front end's |y| and average
    (the JAX package's computes its own)."""
    runs = []
    for ns, kw in ((lc.REF, {}), (live_scenes.port_namespace(), {"device": "cpu"})):
        cfg = ns.ReaderConfig(mode="compat")
        channel = ns.SimTagChannel(cfg, [ns.Tag.with_id(27, seed=7)], seed=1)
        runs.append(ns.LiveReader(cfg, **kw).run_inventory(channel, 3))
    lc.assert_same_stats(runs[1], runs[0])
    assert runs[1].n_epc_correct == 3


def test_live_scenes_hold_their_tests_counts(recorded):
    """The scenes are the JAX tests' scenes, with the counts those tests
    assert."""
    runs = recorded[0]
    st = runs["one_tag"][1]
    assert (st.n_queries, st.n_epc_correct, int(st.tag_reads[27]), st.n_no_rn16) == (5, 5, 5, 0)
    st = runs["sic_pair"][1]
    assert (st.n_epc_correct, st.n_epc_sic_second) == (6, 3)
    st = runs["access"][1]
    assert st.n_write_ok == 2 and st.n_read_ok == 2
    np.testing.assert_array_equal(st.read_words[0x2B], live_scenes.BEEF)


@pytest.mark.parametrize("seed", [4, 13, 14])
def test_fuzz_scenario_matches_jax(seed):
    """tests/test_fuzz_live.py's draws: 4 (LBT off a busy channel, the link
    ladder, A/B sessions), 13 (backlog Q, SecureComm read, SIC, A/B
    sessions), 14 (adaptive Q, hopping, Select, SIC), each run by both
    packages from the same draw, its configurations and tags rebuilt as the
    port's."""
    from test_fuzz_live import _draw_scenario

    def run(ns, convert_cfg, convert_tag, **kw):
        cfg, tags, opts, ch_kw, _, _, n_rounds, rng = _draw_scenario(seed)
        if "link_profiles" in opts:
            opts["link_profiles"] = [convert_cfg(c) for c in opts["link_profiles"]]
        ch = ns.SimTagChannel(convert_cfg(cfg), [convert_tag(t) for t in tags],
                              seed=int(rng.integers(1 << 16)), **ch_kw)
        return ns.LiveReader(convert_cfg(cfg), **opts, **kw).run_inventory(ch, n_rounds)

    def port_tag(t):
        return Tag(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})

    want = run(lc.REF, lambda c: c, lambda t: t)
    got = run(live_scenes.port_namespace(), port_cfg, port_tag, device="cpu")
    lc.assert_same_stats(got, want)


def test_live_block_shapes_bucketed():
    """tests/test_live.py::test_live_block_shapes_bucketed for the port: the
    512-sample bucket keeps the shape set at a handful."""
    cfg = ReaderConfig()
    rd = LiveReader(cfg, device="cpu")
    st = rd.run_inventory(SimTagChannel(cfg, [Tag.with_id(27, seed=7)], seed=1), 12)
    assert st.n_epc_correct == 12
    assert len(rd._block_shapes) <= 4, sorted(rd._block_shapes)


def test_live_reader_needs_a_device(monkeypatch):
    """Without CUDA and without ``device`` the reader refuses at
    construction; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveReader(ReaderConfig())
    assert LiveReader(ReaderConfig(), device="cpu", sic=True).device == lc.CPU


# The port's live.py is the JAX module but for these lines: the device
# argument and its resolution, the TF32 refusal and their imports, and the
# logger's name.
ALLOWED_DIFF = [
    "+from ..dsp.collision import _check_tf32",
    "+from .inventory import resolve_device",
    '-_log = logging.getLogger("gen2_rfid_tpu.live")',
    '+_log = logging.getLogger("gen2_rfid_tpu_torch.live")',
    "+        device=None,",
    "+        # Every window decodes on ``device``, the CUDA card unless it says",
    "+        # otherwise; without one this raises (resolve_device).",
    "+        self.device = resolve_device(device)",
    "+        if sic:",
    "+            # SIC's contractions refuse TF32 on CUDA: refuse it up front.",
    "+            _check_tf32(self.device)",
]


def test_live_module_is_the_original_but_for_the_device():
    ref = (REPO / "gen2_rfid_tpu" / "runtime" / "live.py").read_text().splitlines()
    port = (REPO / "gen2_rfid_tpu_torch" / "runtime" / "live.py").read_text().splitlines()
    changed = [line for line in difflib.unified_diff(ref, port, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert changed == ALLOWED_DIFF
