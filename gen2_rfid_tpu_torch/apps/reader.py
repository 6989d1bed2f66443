"""CLI: offline decode, trace simulation, TX spectrum, ranging.

PyTorch counterpart of ``gen2_rfid_tpu/apps/reader.py``, the batch-mode
equivalent of the reference application (``apps/reader.py``, whose
DEBUG=True path replays ``misc/data/file_source_test`` through the flowgraph
and prints the inventory report, ``apps/reader.py:101-131``).  Every line it
prints is the JAX CLI's on the same capture, but for the wall-time lines.

Every decode runs on the device that ``--device`` names, the CUDA card by
default; without one, and without ``--device cpu``, a decode command exits
non-zero and decodes nothing.  ``live`` waits for the port's live loop.

Usage:
  python -m gen2_rfid_tpu_torch.apps.reader decode CAPTURE.bin [--chunked] [--q Q]
  python -m gen2_rfid_tpu_torch.apps.reader simulate OUT.bin [--rounds N] [--tags ...]
  python -m gen2_rfid_tpu_torch.apps.reader golden OUT.bin
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


def _host_decoded(dec):
    """One host copy of a decode's fields, as CPU tensors: what the numpy
    reports (``runtime/ranging.py``, ``runtime/stats.py``) read."""
    from ..carry import decoded_from_numpy, decoded_to_numpy

    return decoded_from_numpy(decoded_to_numpy(dec))


def cmd_decode(args) -> int:
    import functools
    import logging

    import numpy as np

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
        host_dec = _host_decoded(last_dec) if args.verbose or args.antenna_pos else None
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
    host_dec = _host_decoded(last_dec) if single and (args.report or args.verbose) else None
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


def cmd_range(args) -> int:
    """PDOA ranging: decode one capture per FCC hop channel and fit each
    tag's range from the phase slope across carriers (runtime/ranging.py)."""
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
        per_freq.append((f_mhz * 1e6, tag_phase_series(_host_decoded(dec), cfg)))
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
