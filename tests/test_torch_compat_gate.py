"""The compat-gate kernel's CPU side: its tile model and its plain version.

* ``compat_gate_tiles_plain``, the PyTorch model of the kernel's
  descriptors, halo and look-back (kernels/compat_gate.py), equals
  ``compat_gate_plain`` exactly on the golden trace's |y| and average and on
  every constructed input of ``compat_cases``, at tiles of 32, 33 and the
  kernel's own.  Every output is an integer or a bool: no tolerance.
* The descriptors' combine is associative, folding it over a split span
  gives the span's own descriptor, a look-back over any number of
  aggregates gives the carry of the exclusive scan, and a capture of one
  tile gets the same words' carries from its scans of the carry's parts
  (hypothesis).  A rise whose next below sample lies nt1 + 1 or nt1 + 2
  samples on across a tile edge is quiet only at nt1 + 2, in the model as
  in the plain version.
* ``compat_gate_plain``, through the port's compat ``gate_detect``, gives the
  JAX package's compat event table (``gate_detect`` jitted whole) on the
  golden scene with exact ties put in, alone and in runs.
* The wrapper on CPU tensors runs the plain version, counts no launch and
  keeps nothing; it rejects other shapes and devices.  ``choose_config``
  picks the configurations the card's sweep found.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.dsp import gate as ref_gate
from gen2_rfid_tpu.sim.trace import golden_trace
from gen2_rfid_tpu_torch import kernels
from gen2_rfid_tpu_torch.dsp import gate
from gen2_rfid_tpu_torch.kernels import compat_gate as cg
from gen2_rfid_tpu_torch.kernels.gate_front import gate_front_for_cfg
from gen2_rfid_tpu_torch.runtime import inventory as inv
from torch_compare import assert_same_events, one_torch_thread, port_cfg  # noqa: F401

ref_gate_detect = jax.jit(ref_gate.gate_detect, static_argnames=("cfg",))

COMPAT = RefConfig(mode="compat")
TILES = (32, 33, cg.TILE)
CASES = {tile: cg.compat_cases(tile) for tile in TILES}
PARAMS = [("golden", tile) for tile in TILES] + [
    (k, tile) for tile in TILES for k in range(len(CASES[tile]))]
IDS = [f"tile{tile}-" + ("golden" if k == "golden" else CASES[tile][k][0])
       for k, tile in PARAMS]


def _args(cfg):
    return (cfg.thresh_fraction, cfg.n_samples_pw // 2, cfg.n_samples_t1,
            cfg.num_pulses_command)


@pytest.fixture(scope="module")
def golden():
    """(y, amp, avg) of the golden trace from gate_front's full build, as the
    compat decode takes them."""
    cfg = port_cfg(COMPAT)
    y2, amp, avgsum, _ = gate_front_for_cfg(inv.to_planar(golden_trace(COMPAT).iq), cfg)
    return torch.complex(y2[0], y2[1]), amp, avgsum / torch.tensor(float(cfg.win_length))


@pytest.mark.parametrize("case,tile", PARAMS, ids=IDS)
def test_tiles_model_equals_plain(golden, case, tile):
    if case == "golden":
        _, amp, avg = golden
        args = _args(port_cfg(COMPAT))
    else:
        _, amp, avg, args = CASES[tile][case]
    want_trig, want_pulses = cg.compat_gate_plain(amp, avg, *args)
    got_trig, got_pulses = cg.compat_gate_tiles_plain(amp, avg, *args, tile=tile)
    assert torch.equal(got_trig, want_trig)
    assert torch.equal(got_pulses, want_pulses)
    if case == "golden":
        assert int(want_trig.sum()) == 142


@pytest.mark.parametrize("tile", [32, cg.TILE])
def test_cases_trigger_where_they_are_built(tile):
    """The constructed inputs put their triggers where their labels say: a
    command's last rise on a tile's first or last sample triggers there;
    one more pulse after a trigger triggers in the fixed point's first pass
    only; a last rise at n - nt1 - 2 triggers, at n - nt1 - 1 not; ties
    alone never."""
    seen = set()
    for label, amp, avg, args in CASES[tile]:
        trig = cg.compat_gate_plain(amp, avg, *args)[0].nonzero().flatten().tolist()
        words = label.split()
        if label.startswith("a command's last rise"):
            assert trig == [int(words[-1])], label
            seen.add("rise")
        elif label.startswith("a trigger at"):
            assert trig == [int(words[3].rstrip(","))], label
            seen.add("pass")
        elif label.startswith("n=") and "last rise" in label:
            n, rise = int(words[0][2:].rstrip(",")), int(words[-1])
            assert trig == ([rise] if rise == n - args[2] - 2 else []), label
            seen.add("tail")
        elif label.startswith("ties only"):
            assert trig == [], label
        elif label.startswith("ties from sample 0"):
            assert len(trig) == 1 and trig[0] > tile, label
    assert seen == {"rise", "pass", "tail"}


def test_trigger_after_trigger_needs_the_second_pass():
    """The first pass (resets at short rises only) triggers on the pulse after
    a trigger; the second pass resets the count at the trigger and does not."""
    label, amp, avg, args = next(c for c in CASES[cg.TILE] if c[0].endswith("long pulse"))
    frac, pw_half, nt1, npc = args
    state = cg.gate_signal_state(amp, avg * torch.tensor(frac))
    rises = ((state == 1) & (torch.cat([torch.tensor([-1]), state[:-1]]) == -1)).nonzero()
    # The carrier's own rise at sample 0, the command's npc+1 and one more.
    assert int(rises[0]) == 0 and rises.numel() == npc + 3
    trig, pulses = cg.compat_gate_plain(amp, avg, *args)
    assert trig.nonzero().flatten().tolist() == [int(rises[-2])]
    assert int(pulses[int(rises[-1])]) == 1


def _with_ties(amp, avg, frac, seed):
    """amp with exact ties (amp == avg * frac in float32) at 3% of the
    samples alone and over 200 runs of 1-20 samples."""
    rng = np.random.default_rng(seed)
    thresh = (avg * torch.tensor(frac, dtype=torch.float32)).numpy()
    a = amp.numpy().copy()
    n = a.shape[0]
    at = rng.random(n) < 0.03
    for start, length in zip(rng.integers(0, n - 20, 200), rng.integers(1, 21, 200)):
        at[start:start + length] = True
    a[at] = thresh[at]
    return torch.from_numpy(a), int(at.sum())


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_events_match_jax_with_ties(golden, seed):
    y, amp, avg = golden
    cfg = port_cfg(COMPAT)
    tied, n_ties = _with_ties(amp, avg, cfg.thresh_fraction, seed)
    assert n_ties > 0.03 * amp.shape[0]
    got = gate.gate_detect(y, cfg, amp=tied, avg=avg)
    want = ref_gate_detect(jnp.asarray(y.numpy()), COMPAT, jnp.asarray(tied.numpy()),
                           jnp.asarray(avg.numpy()))
    assert int(got.n_events) > 0
    assert_same_events(got, want)
    # The ties moved edges: the events differ from the untied scene's.
    plain = gate.gate_detect(y, cfg, amp=amp, avg=avg)
    assert not torch.equal(got.n_pulses, plain.n_pulses) or \
        not torch.equal(got.index, plain.index)


def test_gate_keeps_the_jax_names():
    """dsp/gate.py's compat helpers are the module's, under the JAX names."""
    assert gate.gate_signal_state is cg.gate_signal_state and gate._last_le is cg._last_le
    amp = torch.tensor([1.0, 1.0, 3.0, 2.0, 2.0, 0.0, 2.0, 5.0, 2.0])
    assert gate.gate_signal_state(amp, torch.full((9,), 2.0)).tolist() == \
        [-1, -1, 1, 1, 1, -1, -1, 1, 1]


def test_wrapper_on_cpu_runs_plain_counts_and_keeps_nothing(golden):
    _, amp, avg = golden
    args = _args(port_cfg(COMPAT))
    kernels.reset_launches()
    kernels.keep_inputs(True)
    try:
        got = cg.compat_gate(amp, avg, *args)
    finally:
        kernels.keep_inputs(False)
    want = cg.compat_gate_plain(amp, avg, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launches["compat_gate"] == 0 and not kernels.kept
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    # The compat decode's gate goes through the wrapper.
    y, _, _ = golden
    ev = gate.gate_detect(y, port_cfg(COMPAT), amp=amp, avg=avg)
    assert int(ev.n_events) == int(want[0].sum()) == 142


def test_wrapper_rejects_other_shapes_and_devices():
    args = (0.5, 2, 5, 3)
    with pytest.raises(ValueError):
        cg.compat_gate(torch.zeros(10), torch.zeros(9), *args)
    with pytest.raises(ValueError):
        cg.compat_gate(torch.zeros((2, 10)), torch.zeros((2, 10)), *args)
    meta = torch.zeros(10, device="meta")
    with pytest.raises(ValueError):
        cg.compat_gate(meta, meta, *args)


@pytest.mark.parametrize("n,nt1,want", [
    (1, 96, 1), (cg.TILE, 96, 1), (cg.TILE + 1, 96, 0), (215_542, 96, 0), (1 << 19, 96, 1),
    (96 * 8192 - 1, 96, 1), (96 * 8192, 96, 2), (1 << 20, 96, 2), (1_940_860, 96, 2),
    (cg.TILE, 3840, 1), (1_248_504, 960, 2), (2_497_008, 1920, 3), (2_585_440, 3840, 3)])
def test_choose_config(n, nt1, want):
    """One tile of 128 threads for a live window, then by T1 window and by
    the tiles a length gives (the card's sweep); every choice is one of
    CONFIGS."""
    assert cg.choose_config(n, nt1) == want
    assert 0 <= want < len(cg.CONFIGS)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs(n):
    amp = torch.ones(n)
    for tile in (1, 32):
        got = cg.compat_gate_tiles_plain(amp, amp, 0.5, 2, 5, 3, tile=tile)
        want = cg.compat_gate_plain(amp, amp, 0.5, 2, 5, 3)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# Runs of one decision (+1 above, -1 below, 0 tie) with whether a rise in
# the run would be a candidate, and where the span is cut.
RUNS = st.lists(st.tuples(st.sampled_from([-1, 0, 1]), st.integers(1, 5), st.booleans()),
                min_size=1, max_size=14)


def _span(runs, offset):
    dec = torch.tensor([d for d, k, _ in runs for _ in range(k)], dtype=torch.int64)
    cand = torch.tensor([c for _, k, c in runs for _ in range(k)])
    return dec, torch.arange(dec.numel(), dtype=torch.int64) + offset, cand


@settings(max_examples=150, deadline=None, database=None)
@given(runs=RUNS, cuts=st.lists(st.integers(1, 80), min_size=2, max_size=4),
       pw_half=st.integers(0, 6), npc=st.integers(-1, 4), offset=st.integers(0, 30))
def test_descriptor_combine_is_associative_and_folds_a_split(runs, cuts, pw_half, npc, offset):
    dec, gi, cand = _span(runs, offset)
    n = dec.numel()
    cuts = sorted({c % n for c in cuts} - {0})
    bounds = [0] + cuts + [n]
    parts = [cg.span_descriptors(dec[a:b], gi[a:b], cand[a:b], pw_half, npc)
             for a, b in zip(bounds, bounds[1:])]
    whole = cg.span_descriptors(dec, gi, cand, pw_half, npc)
    # Folding over the split, in any grouping, gives the span's descriptor.
    assert torch.equal(cg.desc_scan(torch.stack(parts), 0)[-1], whole)
    left = parts[0]
    for p in parts[1:]:
        left = cg.desc_compose(left, p)
    right = parts[-1]
    for p in reversed(parts[:-1]):
        right = cg.desc_compose(p, right)
    assert torch.equal(left, whole) and torch.equal(right, whole)
    if len(parts) >= 3:
        a, b, c = parts[0], parts[1], cg.desc_scan(torch.stack(parts[2:]), 0)[-1]
        assert torch.equal(cg.desc_compose(cg.desc_compose(a, b), c),
                           cg.desc_compose(a, cg.desc_compose(b, c)))
    # The identity is neutral.
    ident = cg.desc_identity()
    assert torch.equal(cg.desc_compose(ident, whole), whole)
    assert torch.equal(cg.desc_compose(whole, ident), whole)


@settings(max_examples=60, deadline=None, database=None)
@given(runs=RUNS, ntiles=st.integers(1, 12), lags=st.lists(st.integers(0, 3), min_size=12,
                                                            max_size=12),
       pw_half=st.integers(0, 4), npc=st.integers(0, 3))
def test_look_back_gives_the_exclusive_scan(runs, ntiles, lags, pw_half, npc):
    """Whatever number of aggregates a tile composes before it meets an
    inclusive carry, it gets the carry of the exclusive scan."""
    dec, gi, cand = _span(runs * ntiles, 0)
    cut = torch.linspace(0, dec.numel(), ntiles + 1).long().tolist()
    tiles = torch.stack([cg.span_descriptors(dec[a:b], gi[a:b], cand[a:b], pw_half, npc)
                         if b > a else cg.desc_identity() for a, b in zip(cut, cut[1:])])
    c0 = torch.tensor(cg.CARRY0).expand(ntiles, 5)
    want = cg.desc_apply(cg.desc_scan(tiles, 0, exclusive=True), c0)
    assert torch.equal(cg.look_back_carries(tiles, torch.tensor(lags[:ntiles])), want)
    assert torch.equal(cg.look_back_carries(tiles, torch.zeros(ntiles, dtype=torch.int64)), want)


@pytest.mark.parametrize("tile", [32, 33])
@pytest.mark.parametrize("gap", [1, 2])
def test_halo_next_below_across_a_tile_edge(tile, gap):
    """A rise 3 samples before a tile's end whose next below sample lies
    nt1 + gap on, in the next tile: T1-quiet (a trigger) only at gap 2."""
    frac, pw_half, nt1, npc = 0.5, 2, 5, 0
    rise = 2 * tile - 3
    amp = torch.ones(rise + nt1 + 40)
    amp[rise - 4: rise] = 0.0                 # a long low run, then the rise
    amp[rise + nt1 + gap] = 0.0
    avg = torch.ones_like(amp)
    want = cg.compat_gate_plain(amp, avg, frac, pw_half, nt1, npc)
    got = cg.compat_gate_tiles_plain(amp, avg, frac, pw_half, nt1, npc, tile=tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(want[0][rise]) == (gap == 2)
    assert rise // tile != (rise + nt1 + gap) // tile


@settings(max_examples=60, deadline=None, database=None)
@given(runs=RUNS, reps=st.integers(1, 6), pw_half=st.integers(0, 6), npc=st.integers(-1, 3))
def test_one_tile_carries_equal_the_descriptor_scan(runs, reps, pw_half, npc):
    """The one-tile launch's words' carries (two scans of the carry's
    parts) equal those of the descriptor scan from the capture's start."""
    dec, gi, cand = _span(runs * reps, 0)
    pad = -dec.numel() % cg.WORD
    dec, cand = torch.cat([dec, dec.new_zeros(pad)]), torch.cat([cand, cand.new_zeros(pad)])
    gi = torch.arange(dec.numel(), dtype=torch.int64)
    d, g, c = (x.reshape(-1, cg.WORD) for x in (dec, gi, cand))
    words = cg.span_descriptors(d, g, c, pw_half, npc)
    want = cg.desc_apply(cg.desc_scan(words, 0, exclusive=True),
                         torch.tensor(cg.CARRY0).expand(d.shape[0], 5))
    assert torch.equal(cg.one_tile_carries(d, g, c, pw_half, npc), want)
