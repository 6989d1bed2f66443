"""Closed-loop live scenes, by name: the live loop's workloads.

Each scene builds a reader, a simulated air interface and a round count
from the tests of the live loop (named beside each), and ``run_scene``
runs it.  A scene takes a namespace of the classes it builds from
(``ReaderConfig``, ``Tag``, ``SimTagChannel``, ``LiveReader``,
``default_link_profiles``, ``ImpairedChannel``, ``RxImpairments``), the
port's by default, so that the same scene can be built from any package
with those classes and the two runs compared field for field.
``reader_kw`` reaches ``LiveReader``: the port's takes ``device``.
"""

from __future__ import annotations

import types

import numpy as np

KEY = bytes(range(16))
BEEF = np.array([int(b) for b in f"{0xBEEF:016b}"], dtype=np.int64)


def port_namespace() -> types.SimpleNamespace:
    from ..config import ReaderConfig
    from ..runtime.live import LiveReader, default_link_profiles
    from ..sim.channel import SimTagChannel
    from ..sim.impairments import ImpairedChannel, RxImpairments
    from ..sim.tag import Tag

    return types.SimpleNamespace(
        ReaderConfig=ReaderConfig, Tag=Tag, SimTagChannel=SimTagChannel,
        LiveReader=LiveReader, default_link_profiles=default_link_profiles,
        ImpairedChannel=ImpairedChannel, RxImpairments=RxImpairments)


class Tamper:
    """A channel whose ACKs carry one flipped RN16 bit: the tag must stay
    silent (tests/test_live.py:43-59)."""

    def __init__(self, inner):
        self.inner = inner

    def exchange(self, kind, bits, env, cw_us):
        if kind == "ack":
            bits = np.array(bits)
            bits[5] ^= 1
        return self.inner.exchange(kind, bits, env, cw_us)


def _same_seed_pair(ns):
    """The EPC-window SIC pair (rng 8): tags 0x31 and 0x57 of one seed, so
    they draw the same RN16 and answer every ACK together."""
    rng = np.random.default_rng(8)

    def mk(tid, bs):
        epc = rng.integers(0, 2, 96)
        for k in range(8):
            epc[88 + k] = (tid >> (7 - k)) & 1
        return ns.Tag(epc96=epc, seed=5, backscatter=bs)

    return [mk(0x31, 0.09 + 0.02j), mk(0x57, 0.035 - 0.04j)]


def _portal(ns, n_tags=24):
    """tests/test_population.py: tags 0x10.. with geometrically spread
    backscatter."""
    return [ns.Tag.with_id(0x10 + i, seed=i,
                           backscatter=0.08 * 0.93 ** i * np.exp(1.3j * i))
            for i in range(n_tags)]


def _scene(name, ns):
    """(cfg, reader kwargs, channel factory, rounds) of a named scene."""
    rc = ns.ReaderConfig
    ch = ns.SimTagChannel
    if name == "one_tag":            # tests/test_live.py:19
        cfg = rc()
        return cfg, {}, lambda: ch(cfg, [ns.Tag.with_id(27, seed=7)], seed=1), 5
    if name == "tamper":             # tests/test_live.py:43
        cfg = rc()
        return cfg, {}, lambda: Tamper(ch(cfg, [ns.Tag.with_id(9, seed=3)], seed=2)), 3
    if name == "sic_pair":           # EPC-window SIC: both tags every round, "6 3"
        cfg = rc()
        return cfg, {"sic": True}, lambda: ch(cfg, _same_seed_pair(ns), seed=1), 3
    if name == "session_ab3":        # tests/test_session.py:83, three tags
        cfg = rc()
        tags = [ns.Tag.with_id(10 + i, seed=60 + i,
                               backscatter=0.08 * 0.85 ** i * np.exp(1.3j * i))
                for i in range(3)]
        return (cfg, {"q_init": 2, "target_ab": True},
                lambda: ch(cfg, tags, seed=3, session_ab=True), 8)
    if name in ("access", "access_m4"):   # tests/test_access.py:87
        # access_m4: at Miller-4, its slots through the SIC windows.
        cfg = rc() if name == "access" else rc(miller_m=4, decim=1)
        kw = {"access_write": (3, BEEF, "user"), "access_read": (3, 1, "user"),
              "sic": name == "access_m4"}
        return cfg, kw, lambda: ch(cfg, [ns.Tag.with_id(0x2B, seed=7)], seed=1), 2
    if name == "auth":               # tests/test_auth.py:107
        cfg = rc()
        return (cfg, {"authenticate": (1, KEY)},
                lambda: ch(cfg, [ns.Tag.with_id(0x2B, seed=7, aes_keys={1: KEY})], seed=2), 2)
    if name == "nak":                # tests/test_live.py:128
        cfg = rc(fixed_q=0)
        tags = [ns.Tag.with_id(i + 1, seed=i, backscatter=0.08 * np.exp(1.1j * i))
                for i in range(3)]
        return cfg, {"nak_on_fail": True}, lambda: ch(cfg, tags, seed=6), 6
    if name == "power_down":         # tests/test_live.py:148
        cfg = rc()
        return (cfg, {"power_down_every": 2},
                lambda: ch(cfg, [ns.Tag.with_id(27, seed=7)], seed=9), 6)
    if name == "ladder":             # tests/test_link_adapt.py:56
        base = rc()
        ladder = ns.default_link_profiles(base)
        imp = ns.RxImpairments(interferer_dbc=-20.0, interferer_hz=40e3)
        return (ladder[0], {"link_profiles": ladder, "link_down_after": 1,
                            "link_up_after": 99},
                lambda: ns.ImpairedChannel(ch(base, [ns.Tag.with_id(27, seed=7)], seed=1),
                                           imp, base.adc_rate, seed=7), 8)
    if name == "portal24":           # tests/test_population.py
        cfg = rc()
        return (cfg, {"adaptive": True, "q_mode": "backlog", "q_init": 0, "sic": True,
                      "target_ab": True},
                lambda: ch(cfg, _portal(ns), seed=3, session_ab=True), 40)
    raise KeyError(f"no live scene {name!r}")


def build_scene(name: str, ns=None, **reader_kw):
    """(reader, channel, rounds) of a named scene, fresh."""
    ns = ns or port_namespace()
    cfg, kw, channel, n_rounds = _scene(name, ns)
    return ns.LiveReader(cfg, **kw, **reader_kw), channel(), n_rounds


def run_scene(name: str, ns=None, **reader_kw):
    """(reader, LiveStats) after running a named scene."""
    reader, channel, n_rounds = build_scene(name, ns, **reader_kw)
    return reader, reader.run_inventory(channel, n_rounds)


def integer_fields(st) -> dict:
    """The integer content of a LiveStats, what two runs of a scene must
    share: every int field, tag_reads, the Q, link and LBT traces, the read
    and secure-read words, the permalock status, the error counts, the SIC
    RN16 pairs and the count of phase reads a tag (the per-read phases and
    the latencies are floats)."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, (bool, int)) and not isinstance(v, float):
            out[f.name] = int(v)
    out["tag_reads"] = np.asarray(st.tag_reads).tolist()
    for name in ("q_trace", "link_trace", "lbt_trace"):
        out[name] = list(getattr(st, name))
    for name in ("read_words", "secure_read_words", "permalock_status"):
        out[name] = {int(k): np.asarray(v).tolist() for k, v in getattr(st, name).items()}
    out["error_counts"] = dict(st.error_counts)
    out["sic_rn16_pairs"] = [(np.asarray(a).tolist(), np.asarray(b).tolist())
                             for a, b in st.sic_rn16_pairs]
    out["phase_reads_n"] = {int(k): len(v) for k, v in st.phase_reads.items()}
    return out


class DecodeLog:
    """Watches a reader's window decodes: ``calls`` holds each decode's
    (cfg, mode, padded block length) in order, and ``blocks`` the first
    planar (2, L) float32 block of each (cfg, length) with its mode, as
    ``SlotDecodeMixin._decode_window`` pads it."""

    def __init__(self, reader):
        self.calls = []
        self.blocks = {}
        decode = reader._decode_window

        def watched(rx, mode):
            n = len(reader._ctx) + len(rx)
            n += -n % reader.BLOCK_BUCKET
            key = (reader.cfg, n)
            if key not in self.blocks:
                block = np.zeros(n, np.complex64)
                block[: len(reader._ctx) + len(rx)] = np.concatenate([reader._ctx, rx])
                self.blocks[key] = (mode, np.stack([block.real, block.imag]).astype(np.float32))
            self.calls.append((reader.cfg, mode, n))
            return decode(rx, mode)

        reader._decode_window = watched


class ExchangeTimer:
    """Host wall seconds a channel spends in ``exchange`` (the simulated
    air interface's synthesis), summed by exchange kind."""

    def __init__(self, channel):
        import time

        self.seconds = {}
        exchange = channel.exchange

        def timed(kind, *args):
            t0 = time.perf_counter()
            out = exchange(kind, *args)
            self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0
            return out

        channel.exchange = timed
