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
