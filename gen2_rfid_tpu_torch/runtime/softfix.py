"""CRC-guided soft-decision EPC recovery (``cfg.epc_softfix``).

PyTorch counterpart of ``gen2_rfid_tpu/runtime/softfix.py``.  The
reference discards CRC-failed EPC frames (``tag_decoder_impl.cc:330-344``);
this re-slices them by hypothesis testing over the K least reliable
detector decisions: every single and pair of decision flips is mapped to
its bit-flip mask, and the candidate with the least flipped reliability
that passes validation is taken.

Under FM0's differential rule a wrong sign j toggles bits {j, j+1} (only bit
n-1 for the last sign); under Miller each event is one bit.  The K least
reliable decisions are the first K of a stable ascending sort of
reliability, the order ``lax.top_k(-rel, k)`` gives: on ties the lower
index first (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..utils import profiling


@functools.lru_cache(maxsize=32)
def _pair_indices(k: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i, j) int64 index vectors of all i < j pairs among k events, on a
    device, kept for the next decode."""
    pi, pj = np.triu_indices(k, 1)
    return tuple(profiling.to_device(v.astype(np.int64), device) for v in (pi, pj))


def candidate_flips(bits: torch.Tensor, rel: torch.Tensor, k: int,
                    fm0_pairs: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single and pair decision-flip candidates (softfix.py:58-81).

    bits, rel: (E, n).  Returns (candidates (E, C, n) int32, cost (E, C)
    float32) with C = k + k(k-1)/2 and cost the summed reliability of the
    flipped decisions."""
    n = bits.shape[-1]
    dev = bits.device
    idx = torch.sort(-rel, dim=-1, descending=True, stable=True).indices[:, :k]
    relk = rel.gather(1, idx)
    ar = torch.arange(n, device=dev)
    masks = ar[None, None, :] == idx[:, :, None]          # (E, k, n)
    if fm0_pairs:
        masks = masks | (ar[None, None, :] == idx[:, :, None] + 1)
    pi, pj = _pair_indices(k, dev)
    all_masks = torch.cat([masks, masks[:, pi] ^ masks[:, pj]], dim=1)
    cost = torch.cat([relk, relk[:, pi] + relk[:, pj]], dim=1)
    cands = bits[:, None, :].to(torch.int32) ^ all_masks.to(torch.int32)
    return cands, cost


def recover_epc_batch(
    epc_bits: torch.Tensor, rel: torch.Tensor, cfg: ReaderConfig,
    validate: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Try to repair CRC-failed EPC frames (softfix.py:84-110).

    ``validate`` maps a (B, n) bit table to (pass (B,), tag_id (B,)).
    Returns (bits_out (E, n), fixed (E,) bool); ``fixed`` marks frames where
    some candidate passed (callers apply it only to frames that failed)."""
    k = int(cfg.epc_softfix)
    e, n = epc_bits.shape
    cands, cost = candidate_flips(epc_bits, rel, k, cfg.miller_m == 1)
    c = cands.shape[1]
    ok = validate(cands.reshape(e * c, n))[0].reshape(e, c)
    best = torch.argmin(torch.where(ok, cost, torch.inf), dim=1)
    fixed = ok.any(dim=1)
    bits_best = cands[torch.arange(e, device=cands.device), best]
    return torch.where(fixed[:, None], bits_best, epc_bits), fixed
