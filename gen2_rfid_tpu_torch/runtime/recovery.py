"""Batch-pipeline EPC-window SIC: recover second tags from offline captures.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/recovery.py``.  When two tags
that drew the same RN16 both answer the ACK, the batch decode reads the
dominant frame and loses the other.  This post-pass runs every valid EPC
window of a decode through ``dsp/collision.py::epc_sic_batch``; the residual
pass's frame is kept only when its CRC-16 passes and it differs from the
window's primary frame, so extra EPCs surface only where a second frame is.

On the decode's device: one ``gate_front`` launch (its y build) gives the
same y as the decode's, the windows are gathered in one batch, and the SIC
runs on all of them at once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import ReaderConfig
from ..dsp.collision import epc_sic_batch
from ..kernels.gate_front import gate_front_y_for_cfg
from .inventory import DecodedEvents, _tag_ids, resolve_device, to_planar


def _planar(iq) -> torch.Tensor:
    """A (2, N) float32 planar tensor as it is, or a complex host capture
    made planar."""
    if isinstance(iq, torch.Tensor) and iq.dim() == 2 and iq.shape[0] == 2 \
            and not iq.is_complex():
        return iq
    return to_planar(iq)


def recover_epc_collisions(iq, dec: DecodedEvents, cfg: ReaderConfig, device=None
                           ) -> List[Tuple[int, int, np.ndarray]]:
    """Run EPC-window SIC over every valid EPC window of a batch decode
    (recovery.py:42-87).

    iq: the decoded ADC-rate capture, complex on the host or a (2, N)
    float32 planar tensor; dec: its decode.  Runs on CUDA unless ``device``
    says otherwise; an entry point, it turns TF32 matmuls off.  Returns
    [(event index, tag id, 128 frame bits int32), ...] for each CRC-valid
    residual frame that differs from the window's primary decode and from
    pass 1: the second tags of same-RN16 collisions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(device)
    valid = (dec.valid & dec.epc_fits).to(dev)
    rows = torch.nonzero(valid)[:, 0]
    if rows.numel() == 0:
        return []
    x2 = _planar(iq).to(device=dev, dtype=torch.float32).contiguous()
    y2 = gate_front_y_for_cfg(x2, cfg)
    y = torch.complex(y2[0], y2[1])
    n = y.shape[0]
    w = cfg.epc_window
    dcw = cfg.dc_length
    s = dec.index.to(dev)[rows].to(torch.int64)
    # DC: the mean of y[max(s - dcw + 1, 0) : s + 1], over the samples there
    # are near the capture's start; summed in double precision, rounded once.
    lo = torch.clamp(s - (dcw - 1), min=0)
    pos = lo[:, None] + torch.arange(dcw, device=dev)
    yd = torch.where(pos <= s[:, None], y[torch.clamp(pos, max=n - 1)], 0)
    dc = (yd.to(torch.complex128).sum(dim=1) / (s + 1 - lo)).to(torch.complex64)
    # A window past the capture's end stays zero (recovery.py:63-65).
    win = y[torch.clamp(s[:, None] + torch.arange(w, device=dev), max=n - 1)] - dc[:, None]
    frames = torch.where((s + w <= n)[:, None], win, 0)
    r = epc_sic_batch(frames, cfg)
    second = r.bits[:, 1]
    primary = dec.epc_bits.to(dev)[rows]
    keep = (r.crc_ok[:, 1] & ~torch.all(second == primary, dim=1)
            & ~torch.all(second == r.bits[:, 0], dim=1))
    events = rows[keep].tolist()
    tids = _tag_ids(second[keep]).tolist()
    frames_out = second[keep].cpu().numpy()
    return [(e, t, b) for e, t, b in zip(events, tids, frames_out)]


def extra_tag_reads(recovered) -> Dict[int, int]:
    """Aggregate recovered frames into a tag-id -> extra-reads map."""
    reads: Dict[int, int] = {}
    for _, tid, _ in recovered:
        reads[tid] = reads.get(tid, 0) + 1
    return reads
