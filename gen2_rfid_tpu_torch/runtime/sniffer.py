"""PIE command sniffer: decode the reader's own command stream from a
capture (the protocol-analyzer surface).

New capability with no reference analogue: the reference always *knows*
what it transmitted (the decoder branches on ``decoder_status``,
``tag_decoder_impl.cc:223,291``) and never decodes its own PIE waveform.
The batch pipeline already classifies commands by pulse *count*
(``runtime/inventory.py::classify_commands``); this module goes the rest
of the way and demodulates the PIE symbols themselves — delimiter, Tari
measurement from the data-0 reference symbol, RTcal/TRcal calibration,
per-symbol duration slicing against the RTcal/2 pivot (Gen2 6.3.1.2) —
then parses the recovered bits into typed Gen2 commands (Query fields,
ACKed RN16s, Select masks, access-command opcodes) with CRC-5/16
verification.  Together with the tag-reply decoder this makes the
framework a full Gen2 air-interface analyzer: point it at any capture —
including another reader's — and read the whole dialogue.

Host-side numpy on the raw ADC capture (a per-command reporting pass,
like ``runtime/recovery.py``; the per-sample hot path stays in the jitted
pipeline).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..config import ReaderConfig
from ..protocol import gen2
from ..protocol.crc import crc5_append


def _low_runs(amp: np.ndarray, thresh: float):
    """(start, end) index pairs of runs where amp < thresh."""
    low = amp < thresh
    d = np.diff(low.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0] + 1
    if low[0]:
        starts = np.concatenate([[0], starts])
    if low[-1]:
        ends = np.concatenate([ends, [low.size]])
    return list(zip(starts.tolist(), ends.tolist()))


def _parse_query(bits: np.ndarray) -> Dict[str, object]:
    crc_ok = bool(np.array_equal(crc5_append(bits[:17]), bits))
    q = int("".join(map(str, bits[13:17])), 2)
    m = {(0, 0): 1, (0, 1): 2, (1, 0): 4, (1, 1): 8}[
        (int(bits[5]), int(bits[6]))]
    return {
        "name": "query", "dr": int(bits[4]), "m": m,
        "trext": int(bits[7]), "sel": (int(bits[8]), int(bits[9])),
        "session": 2 * int(bits[10]) + int(bits[11]),
        "target": int(bits[12]), "q": q, "crc_ok": crc_ok,
    }


_UPDN = {(1, 1, 0): +1, (0, 0, 0): 0, (0, 1, 1): -1}

#: 8-bit access/v2 command opcodes -> names (Gen2 6.3.2.12.3, Gen2 v2).
_ACCESS_CODES = {
    gen2.REQ_RN_CODE: "req_rn",
    gen2.READ_CODE: "read",
    gen2.WRITE_CODE: "write",
    gen2.KILL_CODE: "kill",
    gen2.LOCK_CODE: "lock",
    gen2.ACCESS_CODE: "access",
    gen2.BLOCKWRITE_CODE: "blockwrite",
    gen2.BLOCKERASE_CODE: "blockerase",
    gen2.BLOCKPERMALOCK_CODE: "blockpermalock",
    gen2.CHALLENGE_CODE: "challenge",
    gen2.AUTHENTICATE_CODE: "authenticate",
    gen2.READBUFFER_CODE: "readbuffer",
    gen2.KEYUPDATE_CODE: "keyupdate",
    gen2.UNTRACEABLE_CODE: "untraceable",
    gen2.AUTH_COMM_CODE: "auth_comm",
    gen2.SECURE_COMM_CODE: "secure_comm",
}


def parse_command_bits(bits: np.ndarray) -> Dict[str, object]:
    """Typed parse of a PIE-demodulated bit vector.

    Returns at least ``name`` (``"unknown"`` for undecodable vectors) and
    ``n_bits``; known commands add their fields and a CRC verdict where
    the command carries one (Query CRC-5; Select and the access commands
    CRC-16; QueryRep/QueryAdjust/ACK/NAK have none, Gen2 6.3.2.12).
    """
    b = np.asarray(bits, dtype=np.int64)
    out: Dict[str, object] = {"name": "unknown", "n_bits": int(b.size)}
    first4 = tuple(int(x) for x in b[:4]) if b.size >= 4 else None
    if b.size == 22 and first4 == (1, 0, 0, 0):
        out.update(_parse_query(b))
    elif b.size == 4 and tuple(b[:2]) == (0, 0):
        out.update(name="query_rep",
                   session=2 * int(b[2]) + int(b[3]))
    elif b.size == 18 and tuple(b[:2]) == (0, 1):
        out.update(name="ack", rn16="".join(map(str, b[2:])))
    elif b.size == 9 and first4 == (1, 0, 0, 1):
        out.update(name="query_adjust",
                   session=2 * int(b[4]) + int(b[5]),
                   updn=_UPDN.get(tuple(int(x) for x in b[6:9])))
    elif b.size == 8 and tuple(b) == (1, 1, 0, 0, 0, 0, 0, 0):
        out.update(name="nak")
    elif b.size >= 45 and first4 == (1, 0, 1, 0):
        try:
            tgt, act, bank, ptr, mask, trunc, crc_ok = gen2.parse_select(b)
            out.update(name="select", target=tgt, action=act,
                       membank=bank, pointer=ptr,
                       mask="".join(map(str, mask)), truncate=trunc,
                       crc_ok=crc_ok)
        except Exception:
            pass
    elif b.size >= 40:
        code = tuple(int(x) for x in b[:8])
        name = _ACCESS_CODES.get(code)
        if name is not None:
            # Access commands end with handle(16) + CRC-16 over the body
            # (Challenge is broadcast: CRC only).  Report the generic
            # envelope; command-specific fields stay with gen2.parse_*.
            body, crc = b[:-16], b[-16:]
            crc_ok = bool(np.array_equal(gen2._crc16_any(body), crc))
            out.update(name=name, crc_ok=crc_ok)
            if name != "challenge":
                out["handle"] = "".join(map(str, b[-32:-16]))
    return out


def sniff_commands(iq, cfg: ReaderConfig) -> List[Dict[str, object]]:
    """Demodulate every PIE command in a raw ADC-rate capture.

    Returns one record per command, in time order: ``t_s`` (command
    start, capture clock), ``tari_us``/``rtcal_us`` (+ ``trcal_us`` when
    the full preamble was sent — only Query carries it, reader_impl.cc:
    87-96), ``n_bits``, and the parsed fields of
    :func:`parse_command_bits`.  Reader power-downs (≥ ~1 ms of carrier
    off, reader_impl.cc:71-73) appear as ``{"name": "power_down"}``
    events.  Robust to unknown readers: all timing is *measured* from
    the capture's own delimiter/data-0/RTcal calibration symbols, per
    Gen2 6.3.1.2 — ``cfg`` supplies only the ADC rate and the
    command-grouping gap.
    """
    iq = np.asarray(iq)
    amp = np.abs(iq).astype(np.float64)
    us = 1e6 / cfg.adc_rate                   # one sample, in microseconds
    hi = np.percentile(amp, 75)
    if hi <= 0:
        return []
    runs = _low_runs(amp, 0.5 * hi)
    if not runs:
        return []

    # Group low runs into commands: a gap longer than TRcal cannot occur
    # inside one command (the largest intra-command high run is
    # TRcal - PW), while the CW between a command and the next spans at
    # least T1 + T2.
    split = (cfg.trcal_us + cfg.pw_us) / us
    groups: List[List[tuple]] = []
    power_downs: List[tuple] = []
    for r in runs:
        if (r[1] - r[0]) * us >= 1000.0:      # carrier off >= 1 ms
            power_downs.append(r)
            continue
        if groups and r[0] - groups[-1][-1][1] <= split:
            groups[-1].append(r)
        else:
            groups.append([r])

    out: List[Dict[str, object]] = []
    for g in groups:
        if len(g) < 3:
            continue                          # delim + >=2 symbols minimum
        # Leading silence (not a ~delim-sized low) is not a command start.
        delim_us = (g[0][1] - g[0][0]) * us
        if not (0.3 * cfg.delim_us <= delim_us <= 3 * cfg.delim_us):
            continue
        ends = np.array([e for _, e in g], dtype=np.float64)
        durs = np.diff(ends) * us             # symbol lengths, us
        tari = durs[0]                        # data-0 reference symbol
        if len(durs) < 2:
            continue
        rtcal = durs[1]
        if not (1.5 * tari <= rtcal <= 3.5 * tari):
            continue                          # not a PIE preamble
        rec: Dict[str, object] = {
            "t_s": round(float(g[0][0] / cfg.adc_rate), 6),
            "tari_us": round(float(tari), 2),
            "rtcal_us": round(float(rtcal), 2),
        }
        data = durs[2:]
        if data.size and data[0] > 1.05 * rtcal:
            rec["trcal_us"] = round(float(data[0]), 2)
            data = data[1:]
        bits = (data > rtcal / 2.0).astype(np.int64)
        rec.update(parse_command_bits(bits))
        out.append(rec)

    for r in power_downs:
        out.append({"t_s": round(float(r[0] / cfg.adc_rate), 6),
                    "name": "power_down",
                    "duration_us": round((r[1] - r[0]) * us, 1)})
    out.sort(key=lambda r: r["t_s"])
    return out
