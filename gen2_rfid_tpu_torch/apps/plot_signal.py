"""Amplitude plot of an I/Q capture (reference: misc/code/plot_signal.m).

PyTorch counterpart of ``gen2_rfid_tpu/apps/plot_signal.py``.  The MATLAB
script loads interleaved-float32 I/Q and plots |x| so a capture can be
eyeballed against the known-good figure (README.md:76-86); this is the
matplotlib equivalent, with optional gate-event markers.  The matched
filter and the gate run on CUDA unless ``--device`` says otherwise.

Usage:
  python -m gen2_rfid_tpu_torch.apps.plot_signal capture.bin out.png
      [--start S] [--count N] [--decimated] [--events] [--device DEV]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("capture")
    ap.add_argument("out")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=-1)
    ap.add_argument("--decimated", action="store_true",
                    help="plot the post-matched-filter amplitude")
    ap.add_argument("--events", action="store_true",
                    help="mark detected gate events")
    ap.add_argument("--device", default=None,
                    help="torch device of the matched filter and the gate "
                         "(default: the CUDA card; 'cpu' to run without one)")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from ..config import ReaderConfig
    from ..io.tracefile import read_trace

    cfg = ReaderConfig()
    iq = read_trace(args.capture, args.start, args.count)
    fig, ax = plt.subplots(figsize=(14, 4))

    if args.decimated or args.events:
        import torch

        from ..dsp.filters import matched_filter_decimate
        from ..runtime.inventory import matched_taps, resolve_device

        dev = resolve_device(args.device)
        y_t = matched_filter_decimate(torch.from_numpy(np.array(iq, np.complex64)).to(dev),
                                      matched_taps(cfg), cfg.decim)
        y = y_t.cpu().numpy()
        t = np.arange(y.size) / cfg.sample_rate * 1e3
        ax.plot(t, np.abs(y), lw=0.4)
        ax.set_xlabel("time [ms] (post-decimation)")
        if args.events:
            from ..dsp.gate import gate_detect

            ev = gate_detect(y_t, cfg)
            idx = ev.index.cpu().numpy()[ev.valid.cpu().numpy()]
            for e in idx:
                ax.axvline(e / cfg.sample_rate * 1e3, color="r", lw=0.6,
                           alpha=0.6)
            ax.set_title(f"|y| with {idx.size} gate events")
    else:
        t = np.arange(iq.size) / cfg.adc_rate * 1e3
        ax.plot(t, np.abs(iq), lw=0.3)
        ax.set_xlabel("time [ms]")
        ax.set_title("|x| (ADC rate)")
    ax.set_ylabel("amplitude")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
