"""The reference's slot bands: where lone, collided and empty RN16 windows
fall in power over |h|^2 and in margin, by link, noise and tag phases.

    python -m rfidbench.slot_bands [--noises 0.004 0.016 0.032] [--seeds 3 17 29]
    python -m rfidbench.slot_bands --fit miller4

For each link (FM0, Miller-2, Miller-4, Miller-8), noise level and seed it
synthesizes four tags in a 6-round ``fixed_q`` 2 inventory, decodes it with
the plain reference (``rfidbench/reference``) on the CPU, finds the event
of each Query or QueryRep the synthesizer sent (``judge.sent_rows``) and
sorts its RN16 window by what was sent: one tag alone, several, or none.
The tags' RN16 seeds are the seed plus 0-3; their backscatter is either
the tag model's (``same``: every tag at one phase) or 0.08 at phases 1.1
rad apart (``spread``).  It prints one markdown row for each link, tag
set and noise, pooled over the seeds: the ranges of E / |h|^2 and of the
margin in each class; how many collided windows the lone windows' own
rule would call single (E / |h|^2 inside the lone range, the margin at
least the lone least: a ``slot_rule`` fitted to the lone windows, with
no noise to spare); and how many collided windows the FM0 rule
(``SlotRule()``, which the decode applies) calls single.  These are the
bands a per-link slot rule is fitted to.  With ``--fit <link>`` it prints
instead that link's ``slot_rule``, as a configuration file states it
(``fit``).  It needs no card and imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from . import judge
from .cells import ROOT, synthesizer
from .reference.decode import decode_capture
from .synth.config import ReaderConfig
from .synth.sim.tag import Tag
from .synth.sim.trace import synthesize_inventory

# (configuration file, fields set over it): Miller-2 and Miller-8 at the
# decimation and rate the port's bench cases run them at.
LINKS = {"fm0": ("fm0_blf40_2msps", {}),
         "miller2": ("miller4_blf160_2msps", {"miller_m": 2, "decim": 2}),
         "miller4": ("miller4_blf160_2msps", {}),
         "miller8": ("miller4_blf160_2msps", {"miller_m": 8, "adc_rate": 8e6, "decim": 2})}
PHASES = {"same": None, "spread": 1.1}


def link_config(name: str):
    """(the link's ReaderConfig, the synthesizer keywords its file gives)."""
    path, fields = LINKS[name]
    file = ROOT / "configs" / f"{path}.json"
    cfg = json.loads(file.read_text())
    assumed = {k: v for k, v in cfg["assumed"].items() if k != "why"}
    return ReaderConfig(**{**cfg["reader_config"], **assumed, **fields, "fixed_q": 2,
                           "max_events": 512}), synthesizer(cfg, file)


def inventory(cfg: ReaderConfig, seed: int, noise: float = 0.004, step=None, synth=None):
    """(planar capture, ground truth) of four tags (ids 11, 28, 45, 62, RN16
    seeds ``seed`` to ``seed + 3``; the tag model's backscatter, or with
    ``step`` 0.08 at phases ``step`` rad apart) in a 6-round inventory,
    the synthesizer given the keywords ``synth``."""
    tags = [Tag.with_id(i * 17 + 11, seed=seed + i,
                        **({} if step is None else {"backscatter": 0.08 * np.exp(1j * step * i)}))
            for i in range(4)]
    tr = synthesize_inventory(cfg, tags, n_rounds=6, seed=seed, noise=noise, **(synth or {}))
    x2 = torch.from_numpy(np.stack([tr.iq.real, tr.iq.imag]).astype(np.float32))
    taps = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)
    return x2, judge.Truth(tr.events, x2.shape[1], 1, cfg.decim, max(cfg.n_samples_pw, 1),
                           cfg.n_samples_t1 + 1 + (taps - 1) / (2 * cfg.decim))


def rn16_windows(cfg: ReaderConfig, step, noise: float, seed: int, synth=None):
    """[(class, E / |h|^2, margin, the FM0 rule's verdict)] of each
    Query-like command sent; class 0 empty, 1 one tag alone, 2 several."""
    x2, truth = inventory(cfg, seed, noise, step, synth)
    _, dec = decode_capture(x2, cfg)
    found, rows = judge.sent_rows(dec, truth)
    h2 = torch.clamp((dec.h_est.double() ** 2).sum(dim=-1), min=1e-12)
    out = []
    for e, ok, r in zip(truth.events, found[0], rows[0]):
        if e.kind not in ("query", "query_rep"):
            continue
        if not ok:
            raise RuntimeError(f"no event for the command sent at sample {e.cmd_end}")
        cls = 1 if e.reply_tag is not None and e.reply_bits is not None else 2 if e.collided else 0
        out.append((cls, float(dec.rn16_energy[r] / h2[r]), float(dec.rn16_margin[r]),
                    int(dec.slot_state[r])))
    return out


def fit(link: str, noises, seeds, digits: int = 2) -> dict:
    """The ``slot_rule`` fitted to ``link``'s lone windows, pooled over both
    tag sets, ``noises`` and ``seeds``: power over their range and
    ``margin_min`` at their least margin, each rounded outward to
    ``digits`` decimals.  Its ``why`` gives the readings, and how many
    collided windows the rule calls single."""
    cfg, synth = link_config(link)
    w = [x for step in PHASES.values() for noise in noises for s in seeds
         for x in rn16_windows(cfg, step, noise, s, synth)]
    lone, coll = [x for x in w if x[0] == 1], [x for x in w if x[0] == 2]
    q = 10 ** digits
    power = [x[1] for x in lone]
    lo, hi = math.floor(min(power) * q) / q, math.ceil(max(power) * q) / q
    margin_min = math.floor(min(x[2] for x in lone) * q) / q
    single = sum(x[2] >= margin_min and lo <= x[1] <= hi for x in coll)
    why = (f"python -m rfidbench.slot_bands --fit {link}: {len(lone)} lone windows read "
           f"E/|h|^2 {min(power):.4f}-{max(power):.4f} and margin from "
           f"{min(x[2] for x in lone):.4f}, "
           f"{len(coll)} collided ones E/|h|^2 {span([x[1] for x in coll])}, margin "
           f"{span([x[2] for x in coll])}, over noises {noises}, seeds {seeds} and tag sets "
           f"{sorted(PHASES)}; rounded outward, the rule calls {single} collided single")
    return {"margin_min": margin_min, "excess": [lo, hi], "why": why}


def span(v) -> str:
    return f"{min(v):.3f}-{max(v):.3f}" if v else "none"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--noises", type=float, nargs="+", default=[0.004, 0.016, 0.032])
    p.add_argument("--seeds", type=int, nargs="+", default=[3, 17, 29])
    p.add_argument("--fit", choices=sorted(LINKS),
                   help="print this link's fitted slot_rule in place of the table")
    args = p.parse_args(argv)
    if args.fit:
        with torch.no_grad():
            print(json.dumps(fit(args.fit, args.noises, args.seeds)))
        return 0
    print("| Link | Tags | Noise | Lone (n): E/\\|h\\|^2, margin | Collided (n): E/\\|h\\|^2, "
          "margin | Empty (n): E/\\|h\\|^2, margin | Collided single by the lone band "
          "| Collided called single by the FM0 rule |")
    print("|---|---|---|---|---|---|---|---|")
    with torch.no_grad():
        for link in LINKS:
            cfg, synth = link_config(link)
            for tags, step in PHASES.items():
                for noise in args.noises:
                    w = [x for s in args.seeds
                         for x in rn16_windows(cfg, step, noise, s, synth)]
                    cls = {c: [x for x in w if x[0] == c] for c in (0, 1, 2)}
                    lone, coll = cls[1], cls[2]
                    box = [x for x in coll if lone
                           and min(y[1] for y in lone) <= x[1] <= max(y[1] for y in lone)
                           and min(y[2] for y in lone) <= x[2]]
                    print(f"| {link} | {tags} | {noise} "
                          f"| ({len(lone)}) {span([x[1] for x in lone])}, "
                          f"{span([x[2] for x in lone])} "
                          f"| ({len(coll)}) {span([x[1] for x in coll])}, "
                          f"{span([x[2] for x in coll])} "
                          f"| ({len(cls[0])}) {span([x[1] for x in cls[0]])}, "
                          f"{span([x[2] for x in cls[0]])} "
                          f"| {len(box)} | {sum(x[3] == 1 for x in coll)} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
