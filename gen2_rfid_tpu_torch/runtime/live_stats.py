"""Live-loop statistics (`LiveStats`): the closed-loop session record.

Split out of runtime/live.py (round 4 decomposition); the import surface
is unchanged — ``from gen2_rfid_tpu.runtime.live import LiveStats`` still
works.  The counter set is the live analogue of the batch
`runtime.stats.InventoryStats` plus per-feature observables (access ops,
crypto, SIC, localization, LBT/link traces); see the field comments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .stats import N_TAG_BINS


@dataclasses.dataclass
class LiveStats:
    n_queries: int = 0
    n_epc_correct: int = 0
    cur_round: int = 1
    cur_slot: int = 1
    n_no_rn16: int = 0          # slots where no command event / reply decoded
    tag_reads: Optional[np.ndarray] = None
    # Slot classification + adaptive-Q bookkeeping (new vs the reference,
    # which only ever learns a slot failed via the EPC CRC).
    n_empty_slots: int = 0
    n_single_slots: int = 0
    n_collision_slots: int = 0
    n_qadjust: int = 0
    n_nak: int = 0
    n_target_flips: int = 0    # A<->B inventoried-flag target flips
    n_sic_recovered: int = 0   # collided slots whose EPC was still read
    n_epc_sic_second: int = 0  # extra EPCs read from the EPC-window residual
    n_req_rn_ok: int = 0       # handles fetched (access sequence)
    n_read_ok: int = 0         # Read replies with CRC + handle echo OK
    n_write_ok: int = 0        # Write replies with CRC + handle echo OK
    n_access_ok: int = 0       # Access sequences completed (-> Secured)
    n_lock_ok: int = 0         # Lock success replies verified
    n_blockwrite_ok: int = 0   # BlockWrite success replies verified
    n_blockerase_ok: int = 0   # BlockErase success replies verified
    n_blockpermalock_ok: int = 0  # BlockPermalock (Read/Lock=1) successes
    n_truncated_reads: int = 0  # EPCs read via truncated replies
    n_kill_ok: int = 0         # tags killed (second-half success reply)
    n_auth_ok: int = 0         # TAM1 Authenticate responses verified
    n_auth_fail: int = 0       # Authenticate replies that failed crypto
    n_buffer_auth_ok: int = 0  # Challenge-precomputed (ReadBuffer) verifies
    n_untraceable_ok: int = 0  # Untraceable success replies verified
    n_keyupdate_ok: int = 0    # KeyUpdate success replies verified
    n_tam2_ok: int = 0         # TAM2 confidential reads verified
    n_secure_read_ok: int = 0  # SecureComm(Read) replies decrypted+verified
    n_secure_write_ok: int = 0  # SecureComm(Write) success replies
    n_auth_comm_ok: int = 0    # AuthComm-encapsulated command successes
    secure_read_words: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)  # tag id -> last TAM2/SecureComm-decrypted
    #                            data bits (confidential reads)
    # Tag error-specific replies (Gen2 Annex I) decoded from failed access
    # commands: error name -> count.  The LLRP access-op result-code
    # analogue; empty when tags stay silent on failure.
    error_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    read_words: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)  # tag id -> last Read data bits
    permalock_status: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)  # tag id -> BlockPermalock status bits
    # Per-read localization observables: tag id -> [(t_s, phase_rad,
    # rssi_dbfs, carrier_hz), ...] from each correct EPC's channel
    # estimate - the live counterpart of runtime/ranging.py::
    # tag_phase_series, with the hop carrier recorded so a hopping
    # session yields live PDOA range.
    phase_reads: Dict[int, List[tuple]] = dataclasses.field(
        default_factory=dict)
    # SIC diagnostics: (acked RN16, residual RN16) per collided slot.
    sic_rn16_pairs: List[tuple] = dataclasses.field(default_factory=list)
    q_trace: List[int] = dataclasses.field(default_factory=list)
    # Link-rate adaptation (link_profiles): (round, miller_m) at every
    # profile switch - the reader's rate-control trace.
    link_trace: List[tuple] = dataclasses.field(default_factory=list)
    # Listen-before-talk: (round, MHz) at every busy-channel move, plus
    # the defer count (EN 302 208-style clear-channel assessment).
    lbt_trace: List[tuple] = dataclasses.field(default_factory=list)
    n_lbt_defers: int = 0
    slot_latency_s: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.tag_reads is None:
            self.tag_reads = np.zeros(N_TAG_BINS, np.int64)

    def phase_series(self, tag_id: int) -> Dict[str, np.ndarray]:
        """(time_s, phase_rad, rssi_dbfs, freq_hz) arrays for one tag -
        feed to runtime.ranging.estimate_velocity (one carrier) or
        ``range_estimate`` (hopping session)."""
        rows = np.asarray(self.phase_reads.get(tag_id, []), dtype=np.float64)
        if rows.size == 0:
            rows = rows.reshape(0, 4)
        return {"time_s": rows[:, 0], "phase_rad": rows[:, 1],
                "rssi_dbfs": rows[:, 2], "freq_hz": rows[:, 3]}

    def range_estimate(self, tag_id: int):
        """Live PDOA range from a frequency-hopping session: the per-read
        phases are grouped by hop carrier (circular mean each) and fit
        across frequency (runtime.ranging.estimate_range).  None unless
        the tag was read on >= 2 carriers."""
        from .ranging import circular_mean, estimate_range

        s = self.phase_series(tag_id)
        by_f: Dict[float, list] = {}
        for ph, f in zip(s["phase_rad"], s["freq_hz"]):
            by_f.setdefault(float(f), []).append(float(ph))
        if len(by_f) < 2:
            return None
        fs = sorted(by_f)
        return estimate_range(fs, [circular_mean(np.asarray(by_f[f]))
                                   for f in fs])

    def latency_summary(self) -> Dict[str, float]:
        lat = np.asarray(self.slot_latency_s, dtype=np.float64)
        if lat.size == 0:
            return {}
        return {
            "mean_ms": float(lat.mean() * 1e3),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "n_slots": int(lat.size),
        }
