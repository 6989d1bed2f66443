"""CLI: offline decode, live inventory, trace simulation, TX spectrum, ranging.

PyTorch counterpart of ``gen2_rfid_tpu/apps/reader.py``, the batch-mode
equivalent of the reference application (``apps/reader.py``, whose
DEBUG=True path replays ``misc/data/file_source_test`` through the flowgraph
and prints the inventory report, ``apps/reader.py:101-131``).  Every line it
prints is the JAX CLI's on the same capture, but for the wall-time lines.

Every decode runs on the device that ``--device`` names, the CUDA card by
default; without one, and without ``--device cpu``, a decode command exits
non-zero and decodes nothing.  ``live`` runs the closed-loop reader
(runtime/live.py) on the same device.

Usage:
  python -m gen2_rfid_tpu_torch.apps.reader decode CAPTURE.bin [--chunked] [--q Q]
  python -m gen2_rfid_tpu_torch.apps.reader simulate OUT.bin [--rounds N] [--tags ...]
  python -m gen2_rfid_tpu_torch.apps.reader golden OUT.bin
  python -m gen2_rfid_tpu_torch.apps.reader live [--rounds N] [--tags ...] [--sic]
  python -m gen2_rfid_tpu_torch.apps.reader --device cpu decode CAPTURE.bin
"""

from __future__ import annotations

import argparse
import sys
import time


def _cfg_from_args(args) -> "ReaderConfig":
    from ..config import ReaderConfig

    over = {}
    if getattr(args, "q", None) is not None:
        over["fixed_q"] = args.q
    if getattr(args, "blf", None) is not None:
        over["blf_hz"] = args.blf * 1e3
    if getattr(args, "miller", None) is not None:
        over["miller_m"] = args.miller
    if getattr(args, "max_events", None) is not None:
        over["max_events"] = args.max_events
    if getattr(args, "epc_words", None) is not None:
        # Window sized for the longest EPC in the population (PC-driven
        # variable-length decode): PC16 + 16*W + CRC16 + dummy.
        over["epc_bits"] = 16 + 16 * args.epc_words + 16 + 1
    if getattr(args, "freq_mhz", None) is not None:
        over["freq_hz"] = args.freq_mhz * 1e6
    if getattr(args, "softfix", None):
        over["epc_softfix"] = args.softfix
    if getattr(args, "cancel_cw", None):
        over["cancel_cw"] = args.cancel_cw
    return ReaderConfig(**over)


def cmd_decode(args) -> int:
    import functools
    import logging

    import numpy as np

    from ..carry import host_decoded
    from ..io.tracefile import read_trace, trace_num_samples
    from ..runtime.inventory import decode_capture
    from ..runtime.stats import merge_stats, print_results
    from ..runtime.stream import StreamDecoder

    log = logging.getLogger("gen2_rfid_tpu_torch.apps")
    dev = args.dev
    cfg = _cfg_from_args(args)
    t0 = time.perf_counter()
    if getattr(args, "wideband", None):
        # Wideband capture: PFB-channelize into n per-reader streams at
        # cfg.adc_rate each, decode every channel independently.
        from ..dsp.channelizer import channel_frequency, decode_wideband

        n_chan = args.wideband
        total = 0
        for path in args.capture:
            iq = read_trace(path)
            total += iq.size
            results = decode_wideband(iq, n_chan, cfg, device=dev)
            in_rate = cfg.adc_rate * n_chan
            for k, (stats, _) in enumerate(results):
                if int(stats.n_events) == 0:
                    continue
                off = channel_frequency(k, n_chan, in_rate)
                print(f"=== channel {k} ({off / 1e6:+.1f} MHz) ===")
                print_results(stats)
        dt = time.perf_counter() - t0
        print(f"| Channelized+decoded {total} wideband samples in {dt:.2f} s "
              f"({total / dt / 1e6:.1f} Msamples/s)")
        return 0
    if getattr(args, "mrc", False):
        # Treat the captures as time-aligned RX channels of ONE air
        # interface (antenna diversity) instead of consecutive segments.
        from ..runtime.diversity import decode_capture_mrc_full

        chans = [read_trace(p_) for p_ in args.capture]
        n0 = chans[0].shape[0]
        if not all(c.shape[0] == n0 for c in chans):
            raise AssertionError("--mrc channels must be equal length (time-aligned)")
        stats, last_dec, h_chan = decode_capture_mrc_full(chans, cfg, device=dev)
        total = n0 * len(chans)
        dt = time.perf_counter() - t0
        print_results(stats)
        host_dec = host_decoded(last_dec) if args.verbose or args.antenna_pos else None
        if args.verbose:
            from ..runtime.stats import tag_signal_report

            for t, r in sorted(tag_signal_report(host_dec).items()):
                print(f"| Tag {t:#04x}: RSSI {r['rssi_dbfs']:+.1f} dBfs "
                      f"(ch0), phase {np.degrees(r['phase_rad']):+.1f} deg, "
                      f"{r['n_reads']} reads over {len(chans)} channels")
        if args.antenna_pos:
            from ..runtime.ranging import aoa_from_mrc

            if len(args.antenna_pos) != len(chans):
                raise AssertionError("--antenna-pos needs one position per --mrc channel")
            for t, a in sorted(aoa_from_mrc(host_dec, h_chan.cpu(),
                                            args.antenna_pos,
                                            cfg.freq_hz).items()):
                print(f"| Tag {t:#04x}: bearing {a['aoa_deg']:+.1f} deg "
                      f"(fit residual {a['resid_rad']:.3f} rad)")
        print(f"| Decoded {total} samples in {dt:.2f} s "
              f"({total / dt / 1e6:.1f} Msamples/s)")
        return 0
    per_capture = []
    total = 0
    for path in args.capture:
        n = trace_num_samples(path)
        log.info("decoding %s (%d samples)", path, n)
        if args.chunked:
            dec = StreamDecoder(cfg, device=dev)

            def chunks():
                pos = 0
                while pos < n:
                    c = min(dec.chunk_adc, n - pos)
                    yield read_trace(path, pos, c)
                    pos += c

            stats, done = dec.decode(chunks())
            total += done
        else:
            iq = read_trace(path)
            stats, last_dec = decode_capture(iq, cfg, exact_gate=args.exact_gate,
                                             device=dev)
            total += n
        per_capture.append(stats)
    # Multi-capture sessions aggregate with merge_stats: each capture's
    # replay restarts its round counter at 1, so the merged round count is
    # a + b - 1 (continuation semantics; reads/queries simply add).
    stats = functools.reduce(merge_stats, per_capture)
    dt = time.perf_counter() - t0
    print_results(stats)
    if args.epc_sic and not args.chunked:
        # Post-pass: EPC-window SIC over every EPC window surfaces second
        # tags from same-RN16 collisions (runtime/recovery.py).
        from ..runtime.recovery import extra_tag_reads, recover_epc_collisions

        rec = []
        for path in args.capture:
            iq = read_trace(path)
            _, dec_one = decode_capture(iq, cfg, exact_gate=args.exact_gate, device=dev)
            rec += recover_epc_collisions(iq, dec_one, cfg, device=dev)
        if rec:
            extra = extra_tag_reads(rec)
            print(f"| EPC-window SIC: {len(rec)} extra EPCs recovered")
            for tid, n in sorted(extra.items()):
                print(f"| Tag {tid:#x} (SIC residual): {n} reads")
    single = not args.chunked and len(args.capture) == 1
    host_dec = host_decoded(last_dec) if single and (args.report or args.verbose) else None
    if getattr(args, "report", None) and single:
        # Per-read JSON-lines tag report (the LLRP RO_ACCESS_REPORT
        # analogue; runtime/stats.py::tag_report_records).
        import json

        from ..runtime.stats import tag_report_records

        recs = tag_report_records(
            host_dec, cfg,
            freq_hz=(args.freq_mhz * 1e6) if args.freq_mhz else None)
        out = (sys.stdout if args.report == "-"
               else open(args.report, "w"))
        for r in recs:
            out.write(json.dumps(r) + "\n")
        if out is not sys.stdout:
            out.close()
            print(f"| Wrote {len(recs)} tag-report records to {args.report}")
    if args.verbose:
        cc = stats.cmd_counts.cpu().numpy()
        print(f"| Slots: {int(stats.n_slot_single)} single / "
              f"{int(stats.n_slot_empty)} empty / "
              f"{int(stats.n_slot_collision)} collision")
        print(f"| Commands: {cc[0]} Query, {cc[1]} QueryRep, {cc[2]} ACK, "
              f"{cc[3]} QueryAdjust, {cc[4]} NAK, {cc[5]} unknown")
        if single:
            from ..runtime.ranging import estimate_velocity, tag_phase_series
            from ..runtime.stats import tag_signal_report

            series = tag_phase_series(host_dec, cfg)
            for t, r in sorted(tag_signal_report(host_dec).items()):
                line = (f"| Tag {t:#04x}: RSSI {r['rssi_dbfs']:+.1f} dBfs, "
                        f"phase {np.degrees(r['phase_rad']):+.1f} deg "
                        f"(spread {np.degrees(r['phase_spread_rad']):.2f} deg, "
                        f"{r['n_reads']} reads)")
                s = series.get(t)
                if s is not None and s["time_s"].size >= 3:
                    v = estimate_velocity(s["time_s"], s["phase_rad"],
                                          cfg.freq_hz)
                    line += (f", radial v {v['velocity_mps']:+.2f} m/s "
                             f"@ {cfg.freq_hz / 1e6:.0f} MHz")
                print(line)
    print(f"| Decoded {total} samples in {dt:.2f} s "
          f"({total / dt / 1e6:.1f} Msamples/s)")
    return 0


def cmd_simulate(args) -> int:
    import numpy as np

    from ..io.tracefile import write_trace
    from ..sim.tag import Tag
    from ..sim.trace import synthesize_adaptive_inventory, synthesize_inventory

    cfg = _cfg_from_args(args)
    dists = args.distance or []
    tags = [
        Tag.with_id(t, seed=i, backscatter=0.08 * np.exp(1.1j * i),
                    n_words=args.epc_words or 6,
                    distance_m=dists[i] if i < len(dists) else None,
                    velocity_mps=args.velocity)
        for i, t in enumerate(args.tags)
    ]
    if args.adaptive:
        tr = synthesize_adaptive_inventory(
            cfg, tags, n_slots=args.rounds, q_init=args.q or 2, seed=args.seed
        )
    else:
        tr = synthesize_inventory(
            cfg, tags, n_rounds=args.rounds, seed=args.seed,
            corrupt_slots=args.corrupt or (),
        )
    write_trace(args.out, tr.iq)
    print(f"wrote {tr.iq.size} samples ({tr.iq.size * 8 / 1e6:.1f} MB) to "
          f"{args.out}; slots={tr.n_slots} expected_epc_pass={tr.expected_epc_pass}")
    return 0


def cmd_txspec(args) -> int:
    """Report TX channel powers, mask verdicts and RF-envelope figures
    (tx/spectrum.py) for the configured shaping."""
    from ..config import ReaderConfig
    from ..tx import spectrum as sp

    cfg = ReaderConfig(tx_shape_us=args.tx_shape, tx_mod=args.tx_mod)
    ok, powers = sp.mask_check(cfg, args.mask, dac=args.dac)
    em = sp.envelope_metrics(cfg)
    lim = sp.MASKS[args.mask]
    shape = (f"Gaussian sigma {args.tx_shape:g} us" if args.tx_shape
             else "rectangular (reference)")
    print(f"| TX: {args.tx_mod.upper()}-ASK, envelope {shape}, "
          f"DAC model {args.dac}")
    for k in sorted(powers):
        if k == 0:
            continue
        l = lim[min(k, 3)]
        verdict = "OK" if powers[k] <= l else "FAIL"
        print(f"| channel offset {k}: {powers[k]:7.1f} dBch "
              f"(limit {l:.0f})  {verdict}")
    print(f"| {args.mask}-interrogator mask: "
          f"{'PASS' if ok else 'FAIL'}")
    print(f"| envelope: depth {em['depth']*100:.1f}%  rise "
          f"{em['rise_us']:.1f} us  fall {em['fall_us']:.1f} us  "
          f"(limits: >=90%, <{0.33*em['tari_us']:.1f} us)")
    print(f"| sniffer demodulates shaped Query: "
          f"{sp.query_is_parseable(cfg)}")
    return 0 if ok else 1


def cmd_live(args) -> int:
    """Closed-loop live inventory (the reference's primary, non-DEBUG mode,
    apps/reader.py:82-96): --radio uhd drives real hardware through
    io.radio.UhdDriver; the default simulates the air interface."""
    import numpy as np

    from ..runtime.live import LiveReader
    from ..runtime.stats import InventoryStats, print_results

    cfg = _cfg_from_args(args)

    def _parse_auth(spec):
        """KEYID:KEYHEX -> (key_id, key).  32 hex chars = AES-128
        (ISO 29167-10), 20 = PRESENT-80 (ISO 29167-11); the key length
        selects the crypto suite end to end."""
        if spec is None:
            return None
        kid, keyhex = spec.split(":")
        key = bytes.fromhex(keyhex)
        if len(key) not in (16, 10):
            raise AssertionError("key must be 32 hex chars (AES-128) or 20 (PRESENT-80)")
        return int(kid, 0), key

    auth = _parse_auth(args.auth)
    challenge_auth = _parse_auth(args.challenge_auth)

    def _parse_secure(spec, is_read):
        """KEYID:KEYHEX:PTR:COUNT|HEX[:BANK] -> LiveReader tuple."""
        if spec is None:
            return None
        parts = spec.split(":")
        kid, key = _parse_auth(":".join(parts[:2]))
        ptr = int(parts[2], 0)
        if is_read:
            third = int(parts[3], 0)
        else:
            word = int(parts[3], 16)
            third = np.array([(word >> (15 - k)) & 1 for k in range(16)],
                             dtype=np.int64)
        bank = parts[4] if len(parts) > 4 else "user"
        return (kid, key, ptr, third, bank)

    secure_read = _parse_secure(args.secure_read, True)
    secure_write = _parse_secure(args.secure_write, False)
    auth_comm_write = _parse_secure(args.auth_comm_write, False)
    if args.radio == "uhd":
        from ..io.radio import RadioChannel, UhdDriver

        channel = RadioChannel(cfg, UhdDriver(cfg, freq=args.freq))
    else:
        from ..sim.channel import SimTagChannel
        from ..sim.tag import Tag

        # Simulated tags are provisioned with the reader's key (the CLI
        # demonstrates the success path; key-mismatch behavior is covered
        # in tests/test_auth.py).
        keys = {spec[0]: spec[1]
                for spec in (auth, challenge_auth, secure_read,
                             secure_write, auth_comm_write) if spec} or None
        # Distinct magnitudes and phases per tag (distinct ranges - also
        # what makes collided slots separable for --sic).
        dists = args.tag_distance or []
        tags = [
            Tag.with_id(t, seed=i, aes_keys=keys,
                        distance_m=dists[i] if i < len(dists) else None,
                        backscatter=0.08 * 0.75 ** i * np.exp(1.1j * i))
            for i, t in enumerate(args.tags)
        ]
        channel = SimTagChannel(cfg, tags, seed=args.seed,
                                session_ab=args.session_ab)
    select_mask = None
    if args.select_id is not None:
        # ID byte = EPC bits 88:96 -> EPC-bank bit address 0x20 + 88.
        mask = np.array([(args.select_id >> (7 - k)) & 1 for k in range(8)],
                        dtype=np.int64)
        select_mask = (mask, 0x20 + 88)
    access_read = None
    if args.read:
        parts = args.read.split(":")
        access_read = (int(parts[0], 0), int(parts[1], 0),
                       parts[2] if len(parts) > 2 else "epc")
    access_write = None
    if args.write:
        parts = args.write.split(":")
        word = int(parts[1], 16)
        bits = np.array([(word >> (15 - k)) & 1 for k in range(16)],
                        dtype=np.int64)
        access_write = (int(parts[0], 0), bits,
                        parts[2] if len(parts) > 2 else "user")
    link_profiles = None
    if args.link_adapt:
        from ..runtime.live import default_link_profiles

        link_profiles = default_link_profiles(cfg)
        cfg = link_profiles[0]
    lbt_mhz = None
    if args.lbt:
        from ..runtime.live import ETSI_LOWER_MHZ

        lbt_mhz = list(ETSI_LOWER_MHZ)
    rd = LiveReader(cfg, adaptive=args.adaptive, q_init=args.q,
                    q_mode=args.q_mode, nak_on_fail=args.nak, sic=args.sic,
                    target_ab=args.session_ab, select_mask=select_mask,
                    access_read=access_read, access_write=access_write,
                    authenticate=auth, challenge_auth=challenge_auth,
                    secure_read=secure_read, secure_write=secure_write,
                    auth_comm_write=auth_comm_write,
                    hop_mhz=args.hop_mhz, link_profiles=link_profiles,
                    lbt_mhz=lbt_mhz, device=args.dev)
    st = rd.run_inventory(channel, n_rounds=args.rounds)
    # Reuse the byte-format report (reader_impl.cc:173-192).
    import torch

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    print_results(InventoryStats(
        n_queries=i32(st.n_queries),
        cur_inventory_round=i32(st.cur_round),
        cur_slot=i32(st.cur_slot),
        n_epc_correct=i32(st.n_epc_correct),
        tag_reads=torch.as_tensor(st.tag_reads),
        unique_tags_round=torch.zeros(1, dtype=torch.int32),
        n_rounds_closed=i32(st.cur_round - 1),
        n_events=i32(st.n_queries),
        terminated=torch.tensor(False),
        n_slot_empty=i32(st.n_empty_slots),
        n_slot_single=i32(st.n_single_slots),
        n_slot_collision=i32(st.n_collision_slots),
        cmd_counts=torch.zeros(6, dtype=torch.int32),
    ))
    lat = st.latency_summary()
    if lat:
        print(f"| Slot latency: {lat['p50_ms']:.1f} ms p50 / "
              f"{lat['p95_ms']:.1f} ms p95 over {lat['n_slots']} slots")
    if st.n_sic_recovered:
        print(f"| Collided slots recovered via SIC: {st.n_sic_recovered}")
    if st.n_epc_sic_second:
        print("| Extra EPCs from EPC-window SIC residuals: "
              f"{st.n_epc_sic_second}")
    if st.n_qadjust:
        print(f"| QueryAdjust sent: {st.n_qadjust}  (Q trace: "
              f"{' '.join(map(str, st.q_trace))})")
    if st.n_target_flips:
        print(f"| Inventory target flips (A<->B): {st.n_target_flips}")
    if st.n_lbt_defers or st.lbt_trace:
        moves = " -> ".join(f"{f:.1f}" for _, f in st.lbt_trace)
        print(f"| LBT: {st.n_lbt_defers} busy-channel defers"
              + (f" ({moves} MHz)" if moves else ""))
    if st.link_trace:
        walk = " -> ".join(f"M{m}" if m > 1 else "FM0"
                           for _, m in st.link_trace)
        print(f"| Link adaptation: {len(st.link_trace)} switches "
              f"({walk}), final "
              f"{'M%d' % rd.cfg.miller_m if rd.cfg.miller_m > 1 else 'FM0'}")
    if st.n_req_rn_ok:
        print(f"| Access: {st.n_req_rn_ok} handles, {st.n_read_ok} Reads, "
              f"{st.n_write_ok} Writes OK")
        for tid, words in sorted(st.read_words.items()):
            hexw = "".join(f"{int(''.join(map(str, words[k:k+16])), 2):04x} "
                           for k in range(0, len(words), 16))
            print(f"| Tag {tid:#x} read data: {hexw.strip()}")
    if st.n_auth_ok or st.n_auth_fail or st.n_buffer_auth_ok:
        print(f"| Authentication: {st.n_auth_ok} TAM1 OK, "
              f"{st.n_buffer_auth_ok} buffered OK, "
              f"{st.n_auth_fail} crypto failures")
    if st.n_secure_read_ok or st.n_secure_write_ok or st.n_auth_comm_ok:
        print(f"| SecureComm: {st.n_secure_read_ok} reads OK, "
              f"{st.n_secure_write_ok} writes OK; AuthComm: "
              f"{st.n_auth_comm_ok} OK")
        for t, words in sorted(st.secure_read_words.items()):
            w = "".join(f"{int(''.join(map(str, words[k: k + 16])), 2):04x}"
                        for k in range(0, words.size, 16))
            print(f"| Tag {t:#x} secure read data: {w}")
    if st.error_counts:
        errs = ", ".join(f"{n}x {name}"
                         for name, n in sorted(st.error_counts.items()))
        print(f"| Tag error replies: {errs}")
    if args.hop_mhz:
        for tid in sorted(np.nonzero(np.asarray(st.tag_reads))[0]):
            est = rd.stats.range_estimate(int(tid))
            if est:
                print(f"| Tag {tid:#04x}: live PDOA range "
                      f"{est['range_m']:.3f} m (fit residual "
                      f"{est['resid_rad']:.3f} rad over "
                      f"{len(args.hop_mhz)} carriers)")
    return 0


def cmd_range(args) -> int:
    """PDOA ranging: decode one capture per FCC hop channel and fit each
    tag's range from the phase slope across carriers (runtime/ranging.py)."""
    from ..carry import host_decoded
    from ..io.tracefile import read_trace
    from ..runtime.inventory import decode_capture
    from ..runtime.ranging import range_from_captures, tag_phase_series

    cfg = _cfg_from_args(args)
    if len(args.capture) != len(args.freqs_mhz):
        raise AssertionError("need one --freqs-mhz entry per capture")
    per_freq = []
    for path, f_mhz in zip(args.capture, args.freqs_mhz):
        iq = read_trace(path)
        _, dec = decode_capture(iq, cfg, device=args.dev)
        per_freq.append((f_mhz * 1e6, tag_phase_series(host_decoded(dec), cfg)))
    est = range_from_captures(per_freq)
    if not est:
        print("| No tag observed on >= 2 hop channels")
        return 1
    for tid, r in sorted(est.items()):
        print(f"| Tag {tid:#04x}: range {r['range_m']:.3f} m "
              f"(fit residual {r['resid_rad']:.3f} rad over "
              f"{len(args.capture)} hops)")
    return 0


def cmd_golden(args) -> int:
    from ..io.tracefile import write_trace
    from ..sim.trace import golden_trace

    tr = golden_trace()
    write_trace(args.out, tr.iq)
    print(f"wrote golden capture ({tr.iq.size} samples) to {args.out}; "
          "expected decode: 71 queries / round 72 / 70 EPCs / tag 0x1b x70")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gen2-reader")
    p.add_argument("--log-level", default="WARNING",
                   help="Python logging level for gen2_rfid_tpu_torch loggers "
                        "(the log4cpp analogue, reader README.md:55-64)")
    p.add_argument("--device", default=None,
                   help="torch device of every decode (default: the CUDA card; "
                        "'cpu' decodes on the host)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode I/Q capture file(s); several "
                       "files aggregate into one session report")
    d.add_argument("capture", nargs="+")
    d.add_argument("--mrc", action="store_true",
                   help="treat the captures as time-aligned RX channels "
                        "(antenna-diversity MRC) instead of segments")
    d.add_argument("--chunked", action="store_true",
                   help="stream in chunks (long captures)")
    d.add_argument("--exact-gate", action="store_true",
                   help="use the sequential reference-exact gate FSM")
    d.add_argument("--q", type=int, help="FIXED_Q (default 0)")
    d.add_argument("--blf", type=float, help="backscatter link freq, kHz")
    d.add_argument("--miller", type=int, choices=[1, 2, 4, 8])
    d.add_argument("--max-events", type=int)
    d.add_argument("--cancel-cw", type=int, metavar="N", default=0,
                   help="estimate and subtract up to N strong CW "
                        "interferer tones from the whole capture before "
                        "decoding (dsp/interference.py)")
    d.add_argument("--softfix", type=int, metavar="K", default=0,
                   help="CRC-guided soft recovery of failed EPC frames over "
                        "the K least-reliable decisions (8 is a good value)")
    d.add_argument("--epc-sic", action="store_true",
                   help="post-pass: EPC-window interference cancellation "
                        "recovers second tags from same-RN16 collisions "
                        "(each residual frame CRC-validated)")
    d.add_argument("-v", "--verbose", action="store_true",
                   help="print slot-state and command-type breakdowns, "
                        "per-tag RSSI/phase, and Doppler velocity")
    d.add_argument("--wideband", type=int, metavar="N",
                   help="treat each capture as wideband (N x adc_rate): "
                        "PFB-channelize into N streams and decode each")
    d.add_argument("--epc-words", type=int,
                   help="longest EPC in the population, in 16-bit words "
                        "(sizes the decode window; PC-driven variable-"
                        "length decode handles shorter tags automatically)")
    d.add_argument("--freq-mhz", type=float,
                   help="carrier frequency (for the -v Doppler report)")
    d.add_argument("--antenna-pos", type=float, nargs="+", metavar="X",
                   help="with --mrc: RX antenna positions (m) along a "
                        "linear array; prints per-tag angle of arrival")
    d.add_argument("--report", metavar="FILE",
                   help="write per-read JSON-lines tag reports (time, EPC "
                        "hex, RSSI, phase) to FILE ('-' = stdout)")
    d.set_defaults(fn=cmd_decode, decodes=True)

    r = sub.add_parser("range", help="PDOA tag ranging: one capture per "
                       "FCC hop channel -> per-tag range fit")
    r.add_argument("capture", nargs="+")
    r.add_argument("--freqs-mhz", type=float, nargs="+", required=True,
                   help="carrier frequency (MHz) of each capture, in order")
    r.add_argument("--q", type=int)
    r.add_argument("--max-events", type=int)
    r.set_defaults(fn=cmd_range, decodes=True)

    s = sub.add_parser("simulate", help="synthesize an inventory capture")
    s.add_argument("out")
    s.add_argument("--rounds", type=int, default=10)
    s.add_argument("--tags", type=int, nargs="+", default=[27])
    s.add_argument("--q", type=int)
    s.add_argument("--blf", type=float)
    s.add_argument("--miller", type=int, choices=[1, 2, 4, 8])
    s.add_argument("--seed", type=int, default=1234)
    s.add_argument("--corrupt", type=int, nargs="*",
                   help="global slot indices whose EPC is corrupted")
    s.add_argument("--adaptive", action="store_true",
                   help="adaptive-Q (Annex D) closed loop; --rounds = slots")
    s.add_argument("--epc-words", type=int,
                   help="EPC length per tag in 16-bit words (default 6)")
    s.add_argument("--distance", type=float, nargs="*",
                   help="per-tag range in meters (imposes the round-trip "
                        "backscatter phase at --freq-mhz)")
    s.add_argument("--velocity", type=float, default=0.0,
                   help="radial velocity (m/s) of the moving tags")
    s.add_argument("--freq-mhz", type=float,
                   help="carrier frequency for the phase model")
    s.set_defaults(fn=cmd_simulate, decodes=False)

    ts = sub.add_parser("txspec", help="measure the reader TX spectrum "
                        "against the Gen2 Annex-G transmit masks")
    ts.add_argument("--tx-shape", type=float, default=0.0, metavar="US",
                    help="Gaussian envelope-shaping sigma in us "
                         "(0 = rectangular reference edges)")
    ts.add_argument("--tx-mod", choices=["dsb", "pr"], default="dsb",
                    help="interrogator modulation (Gen2 6.3.1.2): DSB-ASK "
                         "or PR-ASK (phase reversals; needs --tx-shape)")
    ts.add_argument("--dac", choices=["foh", "ideal"], default="foh",
                    help="DAC reconstruction model: first-order hold "
                         "(cheap DAC, conservative) or interpolating "
                         "(USRP-class TX chain)")
    ts.add_argument("--mask", choices=["multi", "dense"], default="dense")
    ts.set_defaults(fn=cmd_txspec, decodes=False)

    g = sub.add_parser("golden", help="regenerate the golden test capture")
    g.add_argument("out")
    g.set_defaults(fn=cmd_golden, decodes=False)

    lv = sub.add_parser("live", help="closed-loop live inventory "
                        "(simulated air interface, or --radio uhd)")
    lv.add_argument("--radio", choices=["sim", "uhd"], default="sim")
    lv.add_argument("--freq", type=float, default=910e6,
                    help="carrier frequency for --radio uhd")
    lv.add_argument("--rounds", type=int, default=10)
    lv.add_argument("--tags", type=int, nargs="+", default=[27])
    lv.add_argument("--q", type=int)
    lv.add_argument("--blf", type=float)
    lv.add_argument("--miller", type=int, choices=[1, 2, 4, 8])
    lv.add_argument("--adaptive", action="store_true",
                    help="adaptive Q (QueryAdjust); controller per --q-mode")
    lv.add_argument("--q-mode", choices=["annexd", "backlog"],
                    default="annexd",
                    help="Q controller: Annex-D +-C walk, or the "
                         "backlog-estimating controller (Schoute occupancy "
                         "+ SIC multiplicity; jumps to log2(n) and locks)")
    lv.add_argument("--nak", action="store_true",
                    help="transmit NAK on failed EPC CRC")
    lv.add_argument("--softfix", type=int, metavar="K", default=0,
                    help="CRC-guided soft recovery of failed EPC frames "
                         "(runtime/softfix.py)")
    lv.add_argument("--link-adapt", action="store_true",
                    help="link-rate adaptation: walk the FM0 -> Miller-2 "
                         "-> Miller-4 ladder down on failing/silent rounds "
                         "(e.g. dense-reader interference) and back up on "
                         "sustained clean rounds; Queries command the M, "
                         "tags follow per Gen2 6.3.2.12.1")
    lv.add_argument("--sic", action="store_true",
                    help="collision recovery: ACK the dominant collider "
                         "(successive interference cancellation, FM0)")
    lv.add_argument("--read", metavar="PTR:COUNT[:BANK]",
                    help="after each correct EPC run the Gen2 access "
                         "sequence (Req_RN -> handle -> Read) and fetch "
                         "COUNT words from word PTR (BANK epc|user, "
                         "default epc)")
    lv.add_argument("--write", metavar="PTR:HEX[:BANK]",
                    help="Gen2 Write: store the 16-bit HEX word at word "
                         "PTR (BANK epc|user, default user; EPC-bank "
                         "writes re-label the tag), cover-coded per spec")
    lv.add_argument("--auth", metavar="KEYID:KEYHEX",
                    help="Gen2 v2 tag authentication (ISO 29167-10 AES-128 "
                         "TAM1): after each correct EPC send Authenticate "
                         "with a fresh 96-bit challenge and crypto-verify "
                         "the 128-bit response (KEYHEX = 32 hex chars)")
    lv.add_argument("--challenge-auth", metavar="KEYID:KEYHEX",
                    help="broadcast-Challenge variant: tags precompute the "
                         "TAM1 response; ReadBuffer fetches + verifies it "
                         "after singulation")
    lv.add_argument("--secure-read", metavar="KEYID:KEYHEX:PTR:COUNT[:BANK]",
                    help="Gen2 v2 SecureComm confidential read: TAM1 "
                         "session + encrypted Read of COUNT words at PTR "
                         "(default bank user) - the words never travel "
                         "in clear")
    lv.add_argument("--secure-write", metavar="KEYID:KEYHEX:PTR:HEX[:BANK]",
                    help="Gen2 v2 SecureComm confidential write of the "
                         "16-bit HEX word at PTR (default bank user)")
    lv.add_argument("--auth-comm-write",
                    metavar="KEYID:KEYHEX:PTR:HEX[:BANK]",
                    help="Gen2 v2 AuthComm: MAC-authenticated (cleartext) "
                         "Write - a keyless rogue reader cannot forge it")
    lv.add_argument("--select-id", type=lambda s: int(s, 0),
                    help="transmit a Gen2 Select first and inventory only "
                         "tags whose ID byte (EPC bits 88:96) matches")
    lv.add_argument("--session-ab", action="store_true",
                    help="session inventory: tags toggle inventoried flags "
                         "when singulated; the reader flips its Query "
                         "target on an empty round (one read per tag per "
                         "pass)")
    lv.add_argument("--lbt", action="store_true",
                    help="listen-before-talk over the ETSI EN 302 208 "
                         "4-channel plan: sense (TX off) before each "
                         "Query round and move off busy channels")
    lv.add_argument("--hop-mhz", type=float, nargs="+", metavar="F",
                    help="FCC frequency hopping: cycle these carriers "
                         "(MHz) each Query round; a hopping session "
                         "yields per-tag live PDOA range")
    lv.add_argument("--tag-distance", type=float, nargs="*",
                    help="per-tag range in meters for the simulated air "
                         "interface (the hopping PDOA observable)")
    lv.add_argument("--seed", type=int, default=99)
    lv.set_defaults(fn=cmd_live, decodes=True)
    return p


def main(argv=None) -> int:
    import logging

    import torch

    from ..runtime.inventory import resolve_device

    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.WARNING),
        format="%(levelname)s:%(name)s: %(message)s",
    )
    # An entry point: every contraction runs in full float32 (the SIC and
    # the channelizer refuse TF32 on CUDA).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.decodes:
        try:
            args.dev = resolve_device(args.device)
        except RuntimeError as err:
            print(f"gen2-reader: {err} (on the command line: --device cpu)",
                  file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
