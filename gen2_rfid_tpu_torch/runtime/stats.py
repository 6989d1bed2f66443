"""Inventory statistics as tensors, and the exact-format results report.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/stats.py`` (the reference's
``READER_STATS`` struct, ``global_vars.h:36-53``, and
``reader::print_results``, ``reader_impl.cc:173-192``).  The report text is
byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_TAG_BINS = 256  # tag id = EPC frame bits[104:112], an 8-bit field


class InventoryStats(NamedTuple):
    n_queries: torch.Tensor            # () int32 Query/QueryRep commands processed
    cur_inventory_round: torch.Tensor  # () int32
    cur_slot: torch.Tensor             # () int32
    n_epc_correct: torch.Tensor        # () int32
    tag_reads: torch.Tensor            # (256,) int32 reads per tag id
    unique_tags_round: torch.Tensor    # (R,) int32 unique count at each round close
    n_rounds_closed: torch.Tensor      # () int32
    n_events: torch.Tensor             # () int32 gate events seen
    terminated: torch.Tensor           # () bool
    n_slot_empty: torch.Tensor         # () int32 slot states over Query-like windows
    n_slot_single: torch.Tensor        # () int32
    n_slot_collision: torch.Tensor     # () int32
    cmd_counts: torch.Tensor           # (6,) int32 processed events per CMD_*


def unique_tags(stats: InventoryStats) -> int:
    return int((stats.tag_reads > 0).sum())


def merge_stats(a: InventoryStats, b: InventoryStats) -> InventoryStats:
    """Combine stats from consecutive capture segments."""
    return InventoryStats(
        n_queries=a.n_queries + b.n_queries,
        cur_inventory_round=a.cur_inventory_round + b.cur_inventory_round - 1,
        cur_slot=b.cur_slot,
        n_epc_correct=a.n_epc_correct + b.n_epc_correct,
        tag_reads=a.tag_reads + b.tag_reads,
        unique_tags_round=torch.cat([a.unique_tags_round, b.unique_tags_round]),
        n_rounds_closed=a.n_rounds_closed + b.n_rounds_closed,
        n_events=a.n_events + b.n_events,
        terminated=torch.logical_or(a.terminated, b.terminated),
        n_slot_empty=a.n_slot_empty + b.n_slot_empty,
        n_slot_single=a.n_slot_single + b.n_slot_single,
        n_slot_collision=a.n_slot_collision + b.n_slot_collision,
        cmd_counts=a.cmd_counts + b.cmd_counts,
    )


def format_results(stats: InventoryStats) -> str:
    """Byte-format clone of reader::print_results (reader_impl.cc:173-192)."""
    reads = stats.tag_reads.cpu().numpy()
    lines = [
        "\n --------------------------",
        f"| Number of queries/queryreps sent : {int(stats.n_queries)}",
        f"| Current Inventory round : {int(stats.cur_inventory_round)}",
        " --------------------------",
        f"| Correctly decoded EPC : {int(stats.n_epc_correct)}",
        f"| Number of unique tags : {int(np.sum(reads > 0))}",
    ]
    for tid in np.nonzero(reads > 0)[0]:
        lines.append(f"| Tag ID : {tid:x}  Num of reads : {int(reads[tid])}")
    lines.append(" --------------------------")
    return "\n".join(lines)


def print_results(stats: InventoryStats) -> None:
    print(format_results(stats))


def tag_signal_report(dec) -> dict:
    """Per-tag RSSI / phase from the per-read channel estimates
    (stats.py:91-124).

    For each tag id with CRC-passing EPC reads: ``rssi_dbfs``, 10*log10(mean
    |h|^2) of the post-matched-filter channel estimate; ``phase_rad``, the
    circular mean of angle(h); ``phase_spread_rad``, the circular std;
    ``n_reads``.  ``dec`` is the port's DecodedEvents (moved to the host
    once, as numpy arrays); the arithmetic is the JAX package's, in numpy."""
    from ..carry import decoded_to_numpy

    d = decoded_to_numpy(dec)
    valid = d["valid"] & d["epc_pass"]
    h = d["h_est"][valid]
    tid = d["tag_id"][valid]
    out = {}
    for t in np.unique(tid):
        hs = h[tid == t]
        z = hs[:, 0] + 1j * hs[:, 1]
        power = float(np.mean(np.abs(z) ** 2))
        unit = z / np.maximum(np.abs(z), 1e-20)
        r = np.abs(unit.mean())
        out[int(t)] = {
            "rssi_dbfs": 10.0 * float(np.log10(max(power, 1e-30))),
            "phase_rad": float(np.angle(unit.mean())),
            "phase_spread_rad": float(np.sqrt(max(-2.0 * np.log(max(r, 1e-12)), 0.0))),
            "n_reads": int(hs.shape[0]),
        }
    return out


def tag_report_records(dec, cfg, freq_hz: float = None) -> list:
    """Per-read tag report records, the LLRP RO_ACCESS_REPORT analogue
    (stats.py:126-176): one dict per CRC-passed EPC read with its time (s,
    capture clock), EPC hex (PC-length-aware), ``epc_uri`` where the EPC
    carries a known TDS header, tag id, RSSI (dBfs), phase (rad), the XPC
    word's ``u_flag`` where there is one and the carrier (MHz) when given.
    ``dec`` as for ``tag_signal_report``."""
    from ..carry import decoded_to_numpy
    from ..protocol import tds
    from ..protocol.gen2 import parse_epc_frame_full

    d = decoded_to_numpy(dec)
    valid = d["valid"] & d["epc_pass"]
    idx = d["index"][valid]
    bits = d["epc_bits"][valid]
    tid = d["tag_id"][valid]
    h = d["h_est"][valid]
    hc = h[:, 0] + 1j * h[:, 1]
    out = []
    for k in range(idx.size):
        fr = parse_epc_frame_full(bits[k])
        epc = fr["epc"]                   # XPC word (if any) excluded
        epc_hex = "".join(
            f"{int(''.join(map(str, epc[j: j + 4])), 2):x}"
            for j in range(0, epc.size, 4)) if fr["ok"] else ""
        rec = {
            "time_s": round(float(idx[k] / cfg.sample_rate), 6),
            "epc": epc_hex,
            "epc_words": epc.size // 16,
            "tag_id": int(tid[k]),
            "rssi_dbfs": round(float(
                10 * np.log10(max(abs(hc[k]) ** 2, 1e-30))), 2),
            "phase_rad": round(float(np.angle(hc[k])), 4),
        }
        if fr["ok"] and epc.size:
            ident = tds.decode_epc(epc)
            if "uri" in ident:
                rec["epc_uri"] = ident["uri"]
        if fr["xi"]:
            rec["u_flag"] = fr["u"]
        if freq_hz:
            rec["channel_mhz"] = round(freq_hz / 1e6, 3)
        out.append(rec)
    return out
