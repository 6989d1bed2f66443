"""Long single-channel reader captures: a synthesized inventory, tiled.

Parameters (the traffic file): ``tags``, each ``{"id": <8-bit tag id>,
"seed": <the tag's RN16 generator seed>, "backscatter": [re, im] or null}``
(null keeps the tag model's default); ``rounds``, the inventory rounds
synthesized; ``tiles``, how many times that inventory is repeated back to
back on the card; ``captures``, how many such captures a run makes and
decodes in turn; ``noise``, the receiver's noise amplitude.  The keywords
a configuration gives the synthesizer (``cells.synthesizer``: the tag's
reply delay) go to it as they are.

Capture k draws the synthesizer's seed from ``--seed``
(``numpy.random.SeedSequence``): its noise, and with several tags their
slot draws, differ from capture to capture and from run to run.  The
tags' RN16s come from their own fixed seeds, because an ACK's length
follows its RN16's bits: so every capture of a one-tag traffic has the
same length at every seed.  The inventory is synthesized on the host by
the frozen generator (``rfidbench/synth``) under the cell's reader
configuration, put on the card as planar float32 and tiled there.  Each
capture carries the synthesizer's ground truth (``judge.Truth``): a
command's event is looked for T1 and a sample after the command's last
rise, delayed by half the matched filter, within a reader pulse width
either side.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..judge import Truth
from ..synth.sim.tag import Tag
from ..synth.sim.trace import synthesize_inventory


class Capture(NamedTuple):
    x2: torch.Tensor      # (2, N) float32 on the device
    epcs: int             # EPCs the synthesizer sent that pass their CRC
    truth: Truth          # the commands and replies the synthesizer sent


def _tags(spec) -> List[Tag]:
    out = []
    for t in spec:
        bs = t["backscatter"]
        kw = {} if bs is None else {"backscatter": complex(bs[0], bs[1])}
        out.append(Tag.with_id(int(t["id"]), seed=int(t["seed"]), **kw))
    return out


def make(params: dict, cfg, seed: int, device: torch.device, **synth) -> List[Capture]:
    states = np.random.SeedSequence(seed % 2 ** 64).generate_state(params["captures"])
    out = []
    for k in range(params["captures"]):
        tr = synthesize_inventory(cfg, _tags(params["tags"]), n_rounds=params["rounds"],
                                  seed=int(states[k]), noise=params["noise"], **synth)
        tile = torch.from_numpy(np.stack([tr.iq.real, tr.iq.imag]).astype(np.float32))
        x2 = tile.to(device).repeat(1, params["tiles"])
        taps = int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m)
        delay = cfg.n_samples_t1 + 1 + (taps - 1) / (2 * cfg.decim)
        truth = Truth(tr.events, tile.shape[1], params["tiles"], cfg.decim,
                      max(cfg.n_samples_pw, 1), delay)
        out.append(Capture(x2, tr.expected_epc_pass * params["tiles"], truth))
    return out
