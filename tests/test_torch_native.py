"""The port's native (C++) engine adapter against the JAX package's.

Both packages build the same ``gen2_stream.cc`` (the port's is a verbatim
copy, tests/test_torch_copies.py) with the same ``g++`` flags, so events and
stats must be equal, field for field.  The port's adapter returns every
field of its ``InventoryStats`` as a tensor, which ``print_results`` and
``merge_stats`` take.  Skips where ``g++`` is missing, as
tests/test_native.py does.
"""

import numpy as np
import pytest

from gen2_rfid_tpu.config import ReaderConfig as RefConfig
from gen2_rfid_tpu.native.engine import NativeEngine as RefEngine
from gen2_rfid_tpu.runtime import stats as ref_stats
from gen2_rfid_tpu_torch.config import ReaderConfig
from gen2_rfid_tpu_torch.native import engine as port_engine
from gen2_rfid_tpu_torch.native import NativeEngine, native_available
from gen2_rfid_tpu_torch.runtime import stats as port_stats
from gen2_rfid_tpu_torch.sim.tag import Tag
from gen2_rfid_tpu_torch.sim.trace import golden_trace, synthesize_inventory


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    if not native_available():
        pytest.skip("native toolchain unavailable (g++)")


@pytest.fixture(scope="module")
def two_tags():
    """tests/test_native.py's cross-validation scene: FIXED_Q=1, tags 3 and
    77, 5 rounds."""
    cfg = ReaderConfig(fixed_q=1)
    tags = [Tag.with_id(3, seed=1), Tag.with_id(77, seed=2)]
    return cfg, synthesize_inventory(cfg, tags, n_rounds=5, seed=13)


def _run(engine_cls, cfg, pieces):
    e = engine_cls(cfg)
    for p in pieces:
        e.feed(p)
    return e.stats(), e.events()


def _assert_same_stats(got, want):
    for f in got._fields:
        np.testing.assert_array_equal(got._asdict()[f].numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_library_is_built_beside_the_package():
    path = port_engine.library_path()
    assert path.exists()
    assert path.parent == port_engine.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "gen2_rfid_tpu_torch")


def test_golden_tuple_and_events():
    st, ev = _run(NativeEngine, ReaderConfig(), [golden_trace(ReaderConfig()).iq])
    assert (int(st.n_queries), int(st.cur_inventory_round), int(st.n_epc_correct)) == (71, 72, 70)
    assert int(st.tag_reads[27]) == 70 and port_stats.unique_tags(st) == 1
    assert int(st.n_events) == 142 and ev.size == 142


def test_events_and_every_stats_field_match_jax(two_tags):
    cfg, tr = two_tags
    st, ev = _run(NativeEngine, cfg, [tr.iq])
    ref_st, ref_ev = _run(RefEngine, RefConfig(fixed_q=1), [tr.iq])
    assert len(st._fields) == 13
    _assert_same_stats(st, ref_st)
    np.testing.assert_array_equal(ev, ref_ev)
    assert int(st.n_epc_correct) > 0 and int(st.tag_reads[3]) and int(st.tag_reads[77])


def test_chunked_feeding_equals_one_shot(two_tags):
    cfg, tr = two_tags
    st, ev = _run(NativeEngine, cfg, [tr.iq])
    st_c, ev_c = _run(NativeEngine, cfg, np.array_split(tr.iq, 11))
    for f in st._fields:
        assert np.array_equal(getattr(st_c, f).numpy(), getattr(st, f).numpy()), f
    np.testing.assert_array_equal(ev_c, ev)


def test_stats_print_and_merge_like_jax(two_tags, capsys):
    """Every field is a tensor: print_results and merge_stats take the
    engine's stats and give the JAX package's report."""
    cfg, tr = two_tags
    st, _ = _run(NativeEngine, cfg, [tr.iq])
    st_g, _ = _run(NativeEngine, ReaderConfig(), [golden_trace(ReaderConfig()).iq])
    ref_st, _ = _run(RefEngine, RefConfig(fixed_q=1), [tr.iq])
    ref_g, _ = _run(RefEngine, RefConfig(), [golden_trace(RefConfig()).iq])
    merged = port_stats.merge_stats(st, st_g)
    ref_merged = ref_stats.merge_stats(ref_st, ref_g)
    _assert_same_stats(merged, ref_merged)
    port_stats.print_results(merged)
    out = capsys.readouterr().out
    assert out == ref_stats.format_results(ref_merged) + "\n"
    assert "| Tag ID : 1b  Num of reads : 70" in out
