"""The closed-form replay's first-pass flags (runtime/inventory.py::
_first_passes, a scatter-min of row numbers) against the JAX package's
replay and against the one-hot cumsum it replaces, on tables the golden
trace never reaches: every tag id, passes after failed CRCs, repeats, no
pass at all, one row.  Every InventoryStats field must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.runtime import inventory as ref_inv
from gen2_rfid_tpu_torch import carry
from gen2_rfid_tpu_torch.runtime import inventory as inv
from gen2_rfid_tpu_torch.runtime.stats import N_TAG_BINS
from torch_compare import assert_same_stats, port_cfg, replay_table
from torch_compare import one_torch_thread  # noqa: F401 (an autouse fixture)

ref_replay = jax.jit(ref_inv.replay_inventory, static_argnames=("cfg",))

# Four slots a round, so unique_tags_round holds a count at every fourth
# ACK; limits past every table's queries and tags.
REF_CFG = RefConfig(fixed_q=2, max_num_queries=100_000, max_unique_tags=1_000)
CAPACITY = 1024


def _interleave(reads, every=3):
    """A QueryRep before each read, and an empty slot after every
    ``every``-th."""
    rows = []
    for k, r in enumerate(reads):
        rows += [None, r] + ([None] if k % every == every - 1 else [])
    return rows


def _every_tag_id():
    rng = np.random.default_rng(20)
    ids = np.concatenate([rng.permutation(N_TAG_BINS), rng.integers(0, N_TAG_BINS, 100)])
    ok = np.concatenate([np.ones(N_TAG_BINS, bool), rng.random(100) < 0.7])
    return _interleave([(int(t), bool(c)) for t, c in zip(ids, ok)])


def _repeats():
    rng = np.random.default_rng(21)
    cycle = [5, 9, 5, 200, 9, 5, 0, 200, 255]
    return _interleave([(t, bool(rng.random() < 0.75)) for t in cycle * 12], every=4)


TABLES = {
    "every_tag_id": (_every_tag_id(), CAPACITY),
    "pass_after_failed_crc": (_interleave(
        [(7, False), (7, False), (3, True), (7, True), (0, False), (7, True),
         (0, True), (255, False), (3, False), (255, True), (0, True)]), CAPACITY),
    "interleaved_repeats": (_repeats(), CAPACITY),
    "no_pass": (_interleave([(t, False) for t in (0, 1, 255, 1, 0, 17, 17)]), CAPACITY),
    "one_row": ([(255, True)], None),
}


def _one_hot_first_passes(passed, tag_id):
    """The replaced formula: a read is new where the running count of its
    tag id's passes, a cumsum of the (E, 257) one-hot, reads 1."""
    e = passed.shape[0]
    tid = torch.where(passed, tag_id, N_TAG_BINS).to(torch.int64)
    onehot = torch.nn.functional.one_hot(tid, N_TAG_BINS + 1).to(torch.int32)
    seen = torch.cumsum(onehot, 0, dtype=torch.int32)[
        torch.arange(e), torch.clamp(tag_id.to(torch.int64), max=N_TAG_BINS)]
    return passed & (seen == 1)


@pytest.mark.parametrize("name", list(TABLES))
def test_closed_form_replay_equals_reference(name):
    rows, capacity = TABLES[name]
    fields = replay_table(rows, REF_CFG, capacity)
    cfg = port_cfg(REF_CFG)
    dec = carry.decoded_from_numpy(fields)
    assert inv._replay_fast_ok(dec, cfg)
    want = ref_replay(ref_inv.DecodedEvents(**{f: jnp.asarray(v) for f, v in fields.items()}),
                      REF_CFG)
    got = inv._replay_fast_stats(dec, cfg)
    assert_same_stats(got, want)
    assert_same_stats(inv.replay_inventory_scan(dec, cfg), want)

    _, role_epc, _, _, proc = inv._processed(dec)
    passed = proc & role_epc & dec.epc_pass
    new = inv._first_passes(passed, dec.tag_id)
    assert torch.equal(new, _one_hot_first_passes(passed, dec.tag_id))
    assert int(new.sum()) == int((got.tag_reads > 0).sum())


@pytest.mark.parametrize("e,n_ids", [(5, 256), (1000, 256), (36_864, 1), (36_864, 200)])
def test_first_passes_equal_one_hot_on_drawn_rows(e, n_ids):
    """Drawn pass masks and tag ids, the cell's table length among them."""
    rng = np.random.default_rng(e + n_ids)
    passed = torch.from_numpy(rng.random(e) < 0.6)
    tag_id = torch.from_numpy(rng.integers(0, n_ids, e).astype(np.int32))
    assert torch.equal(inv._first_passes(passed, tag_id),
                       _one_hot_first_passes(passed, tag_id))


def test_batch_replay_counts_each_channel():
    """``replay_inventory_batch`` counts one replay a channel, by the route
    it took: the closed form, or the scan where a limit is reached."""
    cfg = port_cfg(REF_CFG)
    dec = carry.decoded_from_numpy(replay_table(TABLES["pass_after_failed_crc"][0], REF_CFG))
    dec_c = inv.DecodedEvents(*(torch.stack([f, f]) for f in dec))
    before = dict(inv.replays)
    inv.replay_inventory_batch(dec_c, cfg)
    assert inv.replays == {"closed_form": before["closed_form"] + 2, "scan": before["scan"]}
    inv.replay_inventory_batch(dec_c, dataclasses.replace(cfg, max_unique_tags=1))
    assert inv.replays == {"closed_form": before["closed_form"] + 2,
                           "scan": before["scan"] + 2}
