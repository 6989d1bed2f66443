"""SigMF capture interop (https://sigmf.org — The Signal Metadata Format).

New capability with no reference analogue: the reference reads/writes bare
interleaved-float32 I/Q files whose sample rate, carrier and provenance
live only in the MATLAB script's constants (``misc/code/plot_signal.m``,
``apps/reader.py:52-61``).  SigMF is the de-facto standard for annotated
RF captures: a raw ``.sigmf-data`` file plus a JSON ``.sigmf-meta``
sidecar carrying datatype, sample rate, carrier frequency, and
annotations.  This module reads/writes the pair with zero dependencies,
so captures interoperate with the wider SDR ecosystem — and the decoder's
findings (per-EPC reads, sniffed commands) can be exported as SigMF
annotations any SigMF viewer can display.

Supported datatypes: ``cf32_le`` (native), ``ci16_le``, ``ci8`` — the
common SDR recording formats.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ReaderConfig

_VERSION = "1.0.0"


def _paths(path: str) -> Tuple[str, str]:
    """Accept any of base / .sigmf-meta / .sigmf-data; return the pair."""
    for suf in (".sigmf-meta", ".sigmf-data"):
        if path.endswith(suf):
            path = path[: -len(suf)]
            break
    return path + ".sigmf-meta", path + ".sigmf-data"


def save_sigmf(
    path: str,
    iq: np.ndarray,
    cfg: ReaderConfig,
    description: str = "gen2_rfid_tpu capture",
    annotations: Optional[List[Dict]] = None,
    datatype: str = "cf32_le",
) -> Tuple[str, str]:
    """Write ``iq`` (complex, ADC rate) as a SigMF pair; returns the two
    file paths.  ``annotations`` follow the SigMF annotation schema
    (``core:sample_start``/``core:sample_count``/``core:label``, sample
    indices at the ADC rate) — see :func:`epc_annotations`."""
    meta_p, data_p = _paths(path)
    iq = np.asarray(iq, dtype=np.complex64)
    if datatype == "cf32_le":
        raw = iq.astype("<c8").view("<f4")
    elif datatype == "ci16_le":
        scale = 32767.0 / max(float(np.abs(iq).max()), 1e-12)
        raw = np.round(
            np.stack([iq.real, iq.imag], -1).reshape(-1) * scale
        ).astype("<i2")
    elif datatype == "ci8":
        scale = 127.0 / max(float(np.abs(iq).max()), 1e-12)
        raw = np.round(
            np.stack([iq.real, iq.imag], -1).reshape(-1) * scale
        ).astype(np.int8)
    else:
        raise ValueError(f"unsupported SigMF datatype {datatype!r}")
    raw.tofile(data_p)
    meta = {
        "global": {
            "core:datatype": datatype,
            "core:sample_rate": float(cfg.adc_rate),
            "core:version": _VERSION,
            "core:description": description,
            "core:recorder": "gen2_rfid_tpu",
        },
        "captures": [
            {"core:sample_start": 0, "core:frequency": float(cfg.freq_hz)}
        ],
        "annotations": list(annotations or []),
    }
    with open(meta_p, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
        f.write("\n")
    return meta_p, data_p


def load_sigmf(path: str) -> Tuple[np.ndarray, Dict]:
    """Read a SigMF pair -> (complex64 iq, metadata dict).

    The metadata dict is the parsed ``.sigmf-meta`` JSON; callers can
    check ``global']['core:sample_rate']`` against their config (the CLI
    refuses rate mismatches instead of decoding garbage)."""
    meta_p, data_p = _paths(path)
    with open(meta_p) as f:
        meta = json.load(f)
    dt = meta["global"]["core:datatype"]
    if dt == "cf32_le":
        iq = np.fromfile(data_p, dtype="<f4").view("<c8").astype(
            np.complex64)
    elif dt == "ci16_le":
        raw = np.fromfile(data_p, dtype="<i2").astype(np.float32) / 32767.0
        iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    elif dt == "ci8":
        raw = np.fromfile(data_p, dtype=np.int8).astype(np.float32) / 127.0
        iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    else:
        raise ValueError(f"unsupported SigMF datatype {dt!r}")
    return iq, meta


def epc_annotations(dec, cfg: ReaderConfig) -> List[Dict]:
    """SigMF annotations for every CRC-passed EPC read in a batch decode:
    one annotation per read spanning the EPC reply window (ADC-rate
    sample indices), labeled with the EPC hex / TDS URI so any SigMF
    viewer shows the inventory on the waveform."""
    from ..protocol import tds
    from ..protocol.gen2 import parse_epc_frame_full

    valid = np.asarray(dec.valid) & np.asarray(dec.epc_pass)
    idx = np.asarray(dec.index)[valid]
    bits = np.asarray(dec.epc_bits)[valid]
    out = []
    for k in range(idx.size):
        fr = parse_epc_frame_full(bits[k])
        if not fr["ok"]:
            continue
        epc = fr["epc"]
        label = "".join(
            f"{int(''.join(map(str, epc[j: j + 4])), 2):x}"
            for j in range(0, epc.size, 4))
        ident = tds.decode_epc(epc)
        if "uri" in ident:
            label = ident["uri"]
        out.append({
            "core:sample_start": int(idx[k]) * cfg.decim,
            "core:sample_count": int(cfg.epc_window) * cfg.decim,
            "core:label": f"EPC {label}",
        })
    return out


def command_annotations(records: List[Dict], cfg: ReaderConfig) -> List[Dict]:
    """SigMF annotations from a sniffed command stream
    (``runtime/sniffer.py::sniff_commands``)."""
    out = []
    for r in records:
        label = r["name"]
        if label == "query":
            label = f"query q={r.get('q')}"
        out.append({
            "core:sample_start": int(r["t_s"] * cfg.adc_rate),
            "core:sample_count": int(
                r.get("duration_us", 100.0) * 1e-6 * cfg.adc_rate),
            "core:label": label,
        })
    return out
