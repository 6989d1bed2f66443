"""The pinned capture fixtures' recipes (tests/fixtures/*.sigmf-*).

A re-creation of ``tools/make_fixtures.py::fixture_specs`` on the port's
``ReaderConfig`` and ``Tag``: what each committed SigMF capture was
synthesized from, so the port can decode a fixture with its configuration
and regenerate its bytes without the JAX package.  The pinned stats sit
beside each capture in ``<name>.expect.json``.
"""

from __future__ import annotations


def fixture_specs():
    """Fixture name -> dict(cfg, tags, synth kwargs)."""
    from ..config import ReaderConfig
    from ..sim.tag import Tag

    return {
        "golden_fm0": dict(
            cfg=ReaderConfig(max_events=64),
            tags=[Tag.with_id(27, seed=7)],
            synth=dict(n_rounds=6, corrupt_slots=[3], seed=1234),
        ),
        "miller4_impaired": dict(
            cfg=ReaderConfig(miller_m=4, max_events=64, track_channel=True),
            tags=[Tag.with_id(77, seed=3, blf_offset=0.01, cfo_hz=300.0,
                              amp_ramp=0.1)],
            synth=dict(n_rounds=5, seed=99),
        ),
    }


def synthesize(name: str):
    """(cfg, trace) of a fixture, from the port's simulator."""
    from ..sim.trace import synthesize_inventory

    spec = fixture_specs()[name]
    return spec["cfg"], synthesize_inventory(spec["cfg"], spec["tags"], **spec["synth"])
