"""The root ``bench*.py`` scripts and their twins in
``gen2_rfid_tpu_torch/tools/``, shared by the ``test_torch_bench*`` files.

The JAX scripts build their cases inside functions that synthesize and
decode at full size.  ``jax_case`` runs a case function of the root
``bench_configs.py`` with its ``make_decode_case`` replaced by a recorder
(monkeypatched; no root file changes), so that a test reads the case's
configuration, tags, rounds, seed and tiles, and may build the capture at a
narrowed size through the real ``make_decode_case``.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp
from gen2_rfid_tpu_torch.tools.bench import narrowed
from gen2_rfid_tpu_torch.tools.bench_configs import CASES
from torch_compare import assert_same_stats

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# The keys of a twin's line: the JAX script's, then the ones the twins add.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "epc_per_s", "band"}
ADDED_KEYS = {"device", "power_limit_w", "decodes", "decode_ms", "first_decode_ms",
              "launches", "epcs", "samples_per_iter", "peak_mem_bytes", "narrowed"}
SCALING_KEYS = {"metric", "value", "unit", "n_devices", "msps_1", "msps_n",
                "per_device_msps_n"}
NO_LAUNCHES = {"gate_front": 0, "gate_stack_stream": 0, "gate_stack_segment": 0,
               "gate_scan": 0}


def root_script(name: str):
    """The root ``<name>.py`` as a module of its own name-space.  The
    scripts set ``JAX_COMPILATION_CACHE_DIR`` when imported; it is put back,
    so that no later process of the test run writes a compilation cache."""
    key = f"jax_root_{name}"
    if key not in sys.modules:
        saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        spec = importlib.util.spec_from_file_location(key, REPO / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            if saved is None:
                os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
            else:
                os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
        sys.modules[key] = mod
    return sys.modules[key]


@dataclasses.dataclass
class JaxCase:
    cfg: object          # the JAX package's ReaderConfig
    tags: list           # the JAX package's Tags
    n_rounds: int
    seed: int
    tiles: int
    iq2: np.ndarray = None   # the capture at the narrowed size, when asked


def jax_case(monkeypatch, name: str, rounds: int = None, tiles: int = None) -> JaxCase:
    """Root ``bench_configs.case_<name>``'s spec, recorded from its call of
    ``make_decode_case``; with ``rounds`` and ``tiles`` its capture too,
    synthesized at that size by the real ``make_decode_case``."""
    jbc = root_script("bench_configs")
    real = jbc.make_decode_case
    got = {}

    def record(cfg, tags, n_rounds, seed, reps):
        got["case"] = JaxCase(cfg, tags, n_rounds, seed, reps)
        if rounds is None:
            return None, None, None
        return real(cfg, tags, rounds, seed, tiles)

    monkeypatch.setattr(jbc, "make_decode_case", record)
    iq2, _, _ = getattr(jbc, f"case_{name}")()
    got["case"].iq2 = iq2
    return got["case"]


def assert_same_tags(port_tags, jax_tags):
    assert len(port_tags) == len(jax_tags)
    for p, j in zip(port_tags, jax_tags):
        np.testing.assert_array_equal(p.epc96, j.epc96)
        np.testing.assert_array_equal(p.pc16, j.pc16)
        assert (p.seed, p.backscatter) == (j.seed, j.backscatter)


def assert_same_cfg(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def jax_cfg(cfg):
    """The JAX package's ReaderConfig with the port's ``cfg``'s fields."""
    from gen2_rfid_tpu.config import ReaderConfig

    return ReaderConfig(**dataclasses.asdict(cfg))


def bit_equal(a, b) -> bool:
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def jax_decode(iq2: np.ndarray, cfg):
    """The JAX package's single-channel decode of a planar capture, jitted."""
    from gen2_rfid_tpu.runtime.inventory import decode_capture_planar

    return decode_capture_planar(jnp.asarray(iq2), cfg)


def jax_sharded(iq2: np.ndarray, cfg, n_time: int, events_per_shard: int, n_chan: int = 0):
    """The JAX package's sharded decode of a (C, 2, N) capture on its first
    n_time CPU devices, jitted whole; with ``n_chan``, a planar (2, N)
    wideband capture channelized first, as ``bench_configs.case_wideband8``
    composes them."""
    from gen2_rfid_tpu.dsp.channelizer import channelize_planar
    from gen2_rfid_tpu.shard.decode_sharded import make_sharded_decoder
    from gen2_rfid_tpu.shard.mesh import make_mesh

    run = make_sharded_decoder(cfg, make_mesh(n_time, 1, devices=jax.devices()[:n_time]),
                               events_per_shard=events_per_shard)
    if n_chan:
        m = iq2.shape[-1] // n_chan
        m_use = m - m % cfg.decim
        return jax.jit(lambda x: run(channelize_planar(x, n_chan)[:, :, :m_use]))(
            jnp.asarray(iq2))
    return jax.jit(run)(jnp.asarray(iq2))


def run_main(module, argv, capsys):
    """``module.main(argv + ["--device", "cpu"])``: (exit code, its JSON
    lines, standard error)."""
    rc = module.main(list(argv) + ["--device", "cpu"])
    out, err = capsys.readouterr()
    return rc, [json.loads(line) for line in out.splitlines()], err


def check_line(line, keys, decodes=2):
    """A narrowed CPU run's line: ``keys`` present, the CPU named, no card
    numbers, some EPCs, ``decodes`` timed decodes."""
    assert keys <= set(line), keys - set(line)
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["peak_mem_bytes"] is None and line["narrowed"] is True
    assert line["epcs"] > 0 and line["decodes"] == decodes


# The narrowed size of the decode comparisons: 3 rounds tiled twice.
ROUNDS, TILES = 3, 2


def check_case_decode(monkeypatch, name):
    """The case's narrowed capture and decode against the JAX script's;
    returns the port's and the JAX package's decoded events."""
    want = jax_case(monkeypatch, name, ROUNDS, TILES)
    w = narrowed(CASES[name], ROUNDS, TILES).workload(CPU)
    assert bit_equal(w.x2.numpy(), want.iq2)
    stats, dec = w.decode(w.x2)
    ref, ref_dec = jax_decode(want.iq2, want.cfg)
    assert_same_stats(stats, ref)
    assert int(stats.n_epc_correct) == w.epcs[0] > 0
    return dec, ref_dec
