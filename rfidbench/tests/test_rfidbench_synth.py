"""The frozen generator gives the port's captures byte for byte."""

from __future__ import annotations

import pytest

from gen2_rfid_tpu_torch.config import ReaderConfig as PortConfig
from gen2_rfid_tpu_torch.sim.tag import Tag as PortTag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory as port_synthesize
from rfidbench.synth.config import ReaderConfig
from rfidbench.synth.sim.tag import Tag
from rfidbench.synth.sim.trace import synthesize_inventory

LINKS = {"fm0": {}, "miller4": {"miller_m": 4, "decim": 1}, "q4": {"fixed_q": 4}}


@pytest.mark.parametrize("seed", [2, 3, 2 ** 31 + 11])
@pytest.mark.parametrize("link", sorted(LINKS))
def test_captures_equal_the_port(link, seed):
    kw = LINKS[link]
    ids = [27] if link != "q4" else [11 + 17 * i for i in range(5)]
    ours = synthesize_inventory(ReaderConfig(**kw), [Tag.with_id(t, seed=7 + i)
                                                     for i, t in enumerate(ids)],
                                n_rounds=3, seed=seed)
    port = port_synthesize(PortConfig(**kw), [PortTag.with_id(t, seed=7 + i)
                                              for i, t in enumerate(ids)],
                           n_rounds=3, seed=seed)
    assert ours.iq.dtype == port.iq.dtype
    assert ours.iq.tobytes() == port.iq.tobytes()
    assert ours.expected_epc_pass == port.expected_epc_pass
