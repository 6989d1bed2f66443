"""The decode's one front end (dsp/gate.py::front_end, ``gate_input``) and
the gate's average (dsp/filters.py::window_mean), on the CPU.

* ``front_end`` gives the build its mode's gate reads, bit for bit: the y
  build and the gate-stack flags of its y natively, the full build's |y|
  and avgsum / win_length in compat mode and for the exact gate.
* The capture decode, the live window decoder and the sharded decode's
  ``gate_block`` each form the gate's input once a decode, native and
  compat.
* ``window_mean`` copies its divisor to a device once.
"""

import pytest
import torch

from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.dsp import filters
from gen2_rfid_tpu_torch.dsp import gate as gate_mod
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg, gate_front_y_for_cfg
from gen2_rfid_tpu_torch.kernels.gate_stack import gate_stack_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime import live_decode
from gen2_rfid_tpu_torch.shard import decode_sharded as ds
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import synthesize_inventory
from gen2_rfid_tpu_torch.utils import profiling
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)


def _x2(cfg):
    tr = synthesize_inventory(cfg, [Tag.with_id(27, seed=7)], n_rounds=2, seed=1)
    return inv.to_planar(tr.iq)


# Case -> (ReaderConfig's keywords, exact_gate).
FRONT_CASES = {"native": ({}, False), "compat": ({"mode": "compat"}, False),
               "exact_gate": ({}, True)}


@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_front_end_is_its_modes_build(case):
    kw, exact_gate = FRONT_CASES[case]
    cfg = ReaderConfig(**kw)
    x2 = _x2(cfg)
    y, flags, amp, avg = gate_mod.front_end(x2, cfg, exact_gate)
    if case == "native":
        y2 = gate_front_y_for_cfg(x2, cfg)
        assert amp is None and avg is None
        assert torch.equal(flags, gate_stack_for_cfg(y2, cfg))
        assert bool((flags & gate_mod.RISE).any())
    else:
        y2, want_amp, avgsum, _ = gate_front_for_cfg(x2, cfg)
        assert flags is None
        assert torch.equal(amp, want_amp)
        assert torch.equal(avg, avgsum / torch.tensor(float(cfg.win_length)))
        assert avg.dtype == torch.float32 and bool((avg > 0).any())
    assert torch.equal(y, torch.complex(y2[0], y2[1]))


@pytest.fixture
def fresh_window_decoders():
    """The live decoder's programs built anew, and dropped after the test,
    so that none keeps a patched front end."""
    live_decode._window_decoder.cache_clear()
    yield
    live_decode._window_decoder.cache_clear()


def _counted(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _capture_decode(cfg, x2):
    st, _ = inv.decode_capture_planar(x2, cfg, device="cpu")
    assert int(st.n_epc_correct) == 2


def _live_window(cfg, x2):
    out = live_decode._window_decoder(cfg, "rn16", torch.device("cpu"))(x2.contiguous())
    assert out.dtype == torch.float32 and bool(out[0])     # a window fits


def _shard_block(cfg, x2):
    _, events = ds.gate_block(x2, cfg, cfg)
    assert int(events.valid.sum()) > 0


# Path -> (its decode, the module whose name it calls, that name).
COMPOSE_PATHS = {
    "decode_capture_planar": (_capture_decode, inv, "front_end"),
    "live_window": (_live_window, gate_mod, "front_end"),
    "gate_block": (_shard_block, ds, "gate_input"),
}


@pytest.mark.parametrize("mode", ["native", "compat"])
@pytest.mark.parametrize("path", list(COMPOSE_PATHS))
def test_each_decode_forms_its_gate_input_once(monkeypatch, fresh_window_decoders, path, mode):
    run, module, name = COMPOSE_PATHS[path]
    cfg = ReaderConfig(mode=mode, max_events=64)
    x2 = _x2(cfg)
    calls = _counted(monkeypatch, module, name)
    run(cfg, x2)
    assert calls == [name]


def test_window_mean_copies_its_divisor_once_a_device():
    filters.f32_scalar.cache_clear()
    s = torch.arange(40, dtype=torch.float32)
    with profiling.recording():
        got = [filters.window_mean(s * k, 7) for k in range(3)]
        other = filters.window_mean(s, 9)
    copies = [r for r in profiling.spans() if r["name"] == profiling.HOST_COPY]
    assert len(copies) == 2                               # one a (win, device)
    for k, g in enumerate(got):
        assert torch.equal(g, (s * k) / torch.tensor(7.0))
    assert torch.equal(other, s / torch.tensor(9.0))
