"""Comparisons of the port's live loop with the JAX package's, shared by
``tests/test_torch_live.py`` and ``tests/test_torch_live_miller.py``.

The window decoder: every window decode of a few JAX live loops is
recorded (the block and the mode, by wrapping the JAX
``SlotDecodeMixin._decode_window`` in the test), and each block goes
through the JAX ``_window_decoder(cfg, mode)`` and the port's
``_window_decoder(cfg, mode, cpu)``.  Their outputs, flattened in order,
must agree: the fits flag always, and where the window fits, every bit and
CRC verdict exactly and the floats within ``FLOAT_TOL`` (float32 order
noise: the port's front end sums the taps in order where XLA's conv does
not, and takes |.| correctly rounded where ``jnp.abs`` does not).

Whole loops: every integer field of ``LiveStats``, ``tag_reads``, the Q,
link and LBT traces, the read words and the error counts must be equal;
each read's phase and RSSI agree within ``PHASE_TOL`` / ``RSSI_TOL``, its
time and carrier exactly (the time is the channel's sample clock; a
channel without one gives wall times, which are not compared, nor are the
slot latencies).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import gen2_rfid_tpu.runtime.live_decode as ref_ld
from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime.live import LiveReader as RefLiveReader
from gen2_rfid_tpu.runtime.live import default_link_profiles as ref_profiles
from gen2_rfid_tpu.sim.channel import SimTagChannel as RefChannel
from gen2_rfid_tpu.sim.impairments import ImpairedChannel as RefImpaired
from gen2_rfid_tpu.sim.impairments import RxImpairments as RefImpairments
from gen2_rfid_tpu.sim.tag import Tag as RefTag
from gen2_rfid_tpu_torch.runtime import live_decode
from gen2_rfid_tpu_torch.tools import live_scenes
from torch_compare import port_cfg

REF = types.SimpleNamespace(
    ReaderConfig=RefConfig, Tag=RefTag, SimTagChannel=RefChannel, LiveReader=RefLiveReader,
    default_link_profiles=ref_profiles, ImpairedChannel=RefImpaired,
    RxImpairments=RefImpairments)
CPU = torch.device("cpu")
MODES = ("rn16", "epc", "sic", "epc_sic", "acc:32", "acc:n")
# Float outputs: tolerance and whether it is relative to the largest
# magnitude of the field over the compared windows.
FLOAT_TOL = {"margin": (1e-3, False), "margin2": (1e-3, False),
             "energy": (1e-4, True), "h2": (1e-4, True), "noise_var": (1e-4, True),
             "h": (1e-4, True), "cancel_ratio": (1e-4, False)}
PHASE_TOL = 1e-3       # radians
RSSI_TOL = 1e-3        # dB
# Scenes whose channel has no sample clock (an ImpairedChannel wraps the
# simulator): their reads' times are wall times.
WALL_CLOCK = {"ladder"}


def record(scenes):
    """({scene: (reader, LiveStats)} of the JAX runs, [(cfg, block2, mode)]
    of every window decode they made)."""
    rec = []
    orig = ref_ld.SlotDecodeMixin._decode_window

    def spy(self, rx, mode):
        block = np.concatenate([self._ctx, rx])
        padded = np.concatenate([block, np.zeros(-len(block) % self.BLOCK_BUCKET,
                                                 block.dtype)])
        rec.append((self.cfg, np.stack([padded.real, padded.imag]).astype(np.float32),
                    mode))
        return orig(self, rx, mode)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ld.SlotDecodeMixin, "_decode_window", spy)
        runs = {name: live_scenes.run_scene(name, REF) for name in scenes}
    return runs, rec


def _layout(mode, n_out):
    """(field, size) of a packed window-decode output (the JAX tuple's
    order, flattened)."""
    if mode.startswith("acc:"):
        return [("fits", 1), ("bits", n_out - 1)]
    if mode == "epc":
        return [("fits", 1), ("bits", n_out - 4), ("ok", 1), ("h", 2)]
    if mode == "epc_sic":
        nb = (n_out - 3) // 2
        return [("fits", 1), ("bits", nb), ("ok", 1), ("bits2", nb), ("ok2", 1)]
    lay = [("fits", 1), ("bits", 16), ("margin", 1), ("energy", 1), ("h2", 1),
           ("noise_var", 1)]
    if mode == "sic":
        lay += [("bits2", 16), ("margin2", 1), ("cancel_ratio", 1)]
    return lay


def split(mode, flat):
    out, k = {}, 0
    for name, size in _layout(mode, flat.shape[-1]):
        out[name] = flat[..., k: k + size]
        k += size
    return out


def decode_both(cfg, block2, mode):
    """(port packed vector, JAX outputs flattened the same way)."""
    want = ref_ld._window_decoder(cfg, mode)(block2)
    want = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in want])
    got = live_decode._window_decoder(port_cfg(cfg), mode, CPU)(torch.from_numpy(block2))
    return got.numpy(), want


def assert_same_windows(pairs, mode):
    got = split(mode, np.stack([g for g, _ in pairs]))
    want = split(mode, np.stack([w for _, w in pairs]))
    np.testing.assert_array_equal(got["fits"], want["fits"])
    fits = want["fits"][:, 0] == 1
    assert fits.any(), f"no fitting {mode} window to compare"
    for name, w in want.items():
        g, w = got[name][fits], w[fits]
        if name not in FLOAT_TOL:
            np.testing.assert_array_equal(g, w, err_msg=f"{mode} {name}")
            continue
        tol, relative = FLOAT_TOL[name]
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30) if relative else 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=f"{mode} {name}")


def records(rec, miller_m, mode):
    """The recorded decodes at Miller ``miller_m`` (1: FM0) in ``mode``;
    "acc:n" takes every access reply but the 32-bit handles."""
    def same(m):
        return m == mode or (mode == "acc:n" and m.startswith("acc:") and m != "acc:32")

    return [(c, b, m) for c, b, m in rec if c.miller_m == miller_m and same(m)]


def check_window_decoder(rec, miller_m, mode):
    """Every recorded block of the mode (acc:n: the Read and Write replies
    of every length) through both window decoders."""
    rows = records(rec, miller_m, mode)
    assert rows, f"no {mode} window recorded at M={miller_m}"
    for m in sorted({m for _, _, m in rows}):
        assert_same_windows([decode_both(c, b, m) for c, b, mm in rows if mm == m], m)


def check_softfix(rec, miller_m, sigmas):
    """EPC windows with noise of each ADC-rate sigma added, decoded with
    ``epc_softfix=8``: the frames CRC-guided recovery repairs and every
    verdict are the JAX package's, and the recovery repairs some frames the
    plain decode fails."""
    rows = records(rec, miller_m, "epc")[:6]
    assert rows
    rng = np.random.default_rng(17)
    pairs, n_fixed = [], 0
    for cfg, block2, _ in rows:
        soft = dataclasses.replace(cfg, epc_softfix=8)
        plain = live_decode._window_decoder(port_cfg(cfg), "epc", CPU)
        for sigma in sigmas:
            noisy = block2 + rng.normal(0, sigma, block2.shape).astype(np.float32)
            g, w = decode_both(soft, noisy, "epc")
            pairs.append((g, w))
            ok_plain = split("epc", plain(torch.from_numpy(noisy)).numpy())["ok"][0]
            n_fixed += int(split("epc", g)["ok"][0] == 1 and ok_plain == 0)
    assert_same_windows(pairs, "epc")
    assert n_fixed > 0, "the noise should fail frames that the recovery repairs"


def assert_same_stats(got, want, sample_clock=True):
    g, w = live_scenes.integer_fields(got), live_scenes.integer_fields(want)
    assert g == w, {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    for tid, reads in want.phase_reads.items():
        for a, b in zip(got.phase_reads[tid], reads):
            assert a[3] == b[3] and (a[0] == b[0] or not sample_clock), (tid, a, b)
            dphi = abs((a[1] - b[1] + np.pi) % (2 * np.pi) - np.pi)
            assert dphi <= PHASE_TOL and abs(a[2] - b[2]) <= RSSI_TOL, (tid, a, b)


def check_loop(runs, name):
    """The port's run of a scene on the CPU against the JAX run (recorded in
    ``runs`` or run here)."""
    want = runs[name][1] if name in runs else live_scenes.run_scene(name, REF)[1]
    reader, got = live_scenes.run_scene(name, device="cpu")
    assert reader.device == CPU
    assert_same_stats(got, want, sample_clock=name not in WALL_CLOCK)
