"""Carry configuration and stage outputs between the port and the JAX package.

The system has no weights: what crosses between the two packages is the
configuration and what each stage hands the next.  These helpers work by
duck typing on plain values (dicts, objects with the right attributes,
anything ``numpy.asarray`` takes), so the port imports nothing of the JAX
package.  With them a test can feed the JAX gate's events into the port's
decode and pin a disagreement to one stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import ReaderConfig
from .dsp.gate import GateEvents


def config_from_fields(fields: Mapping[str, Any]) -> ReaderConfig:
    """The port's ReaderConfig from ``dataclasses.asdict`` of a reference one."""
    names = {f.name for f in dataclasses.fields(ReaderConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"fields the port's ReaderConfig lacks: {sorted(unknown)}")
    return ReaderConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in fields.items()})


def events_from_numpy(events, device="cpu") -> GateEvents:
    """GateEvents from any object with GateEvents' fields as arrays."""
    def t(name):
        return torch.from_numpy(np.array(getattr(events, name))).to(device)

    return GateEvents(**{name: t(name) for name in GateEvents._fields})


def _to_numpy(tup) -> Dict[str, np.ndarray]:
    return {name: getattr(tup, name).cpu().numpy() for name in tup._fields}


def decoded_to_numpy(dec) -> Dict[str, np.ndarray]:
    """The port's DecodedEvents as a dict of numpy arrays."""
    return _to_numpy(dec)


def decoded_from_numpy(fields, device="cpu"):
    """The port's DecodedEvents from a mapping (a dict, an ``np.load``
    archive's fields) or an object with DecodedEvents' fields as arrays."""
    from .runtime.inventory import DecodedEvents

    get = fields.__getitem__ if isinstance(fields, Mapping) else (
        lambda name: getattr(fields, name))
    return DecodedEvents(**{name: torch.from_numpy(np.array(get(name))).to(device)
                            for name in DecodedEvents._fields})


def stats_to_numpy(stats) -> Dict[str, np.ndarray]:
    """The port's InventoryStats as a dict of numpy arrays."""
    return _to_numpy(stats)
