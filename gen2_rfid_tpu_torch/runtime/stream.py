"""Chunked decode of long captures with exact cross-chunk event ownership.

PyTorch counterpart of ``gen2_rfid_tpu/runtime/stream.py``.  The ADC-rate
stream is cut into fixed-size chunks, each decoded with a carried context
tail (overlap-save), so that:

* every command event is owned by exactly one chunk, the one whose owned
  interval holds its trigger, with enough left context to rebuild the gate
  state and enough right room to extract its whole EPC window;
* one trailing all-zero chunk closes the tail, so events near the capture's
  end are owned too;
* window-fit flags are re-checked against the real capture length;
* the per-chunk event tables are joined on the host (a stable sort by global
  index, at most ``max_events`` kept) and the round FSM replays once over
  the whole sequence.

On CUDA each chunk runs the batch path's two kernels: the valid-mode front
end (shard/decode_sharded.py::gate_block, one ``gate_front`` launch: its y
build in native mode, its full build in compat) and the gate flags (one
``gate_stack`` launch) in native mode.  Checkpoints are
``.npz`` files with the JAX package's names and dtypes, so either package
resumes the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from ..carry import decoded_from_numpy, decoded_to_numpy
from ..config import ReaderConfig
from ..kernels.gate_front import front_taps
from ..shard.decode_sharded import UNOWNED, gate_block, halo_sizes
from .inventory import DecodedEvents, decode_events, replay_inventory, resolve_device
from .stats import InventoryStats

@dataclasses.dataclass
class StreamDecoder:
    """Stateful host-side loop around the per-chunk decode, on CUDA unless
    ``device`` says otherwise."""

    cfg: ReaderConfig
    chunk_adc: int = 2_000_000       # ADC samples per chunk (1 s at 2 Msps)
    events_per_chunk: int = 512
    device: object = None

    def __post_init__(self):
        cfg = self.cfg
        if self.chunk_adc % cfg.decim:
            raise ValueError(f"chunk_adc={self.chunk_adc} is not a multiple of "
                             f"decim={cfg.decim}")
        self.hl_y, self.hr_y = halo_sizes(cfg)
        self.chunk_y = self.chunk_adc // cfg.decim
        self.n_taps = front_taps(cfg)
        self.ctx_adc = (self.hl_y + self.hr_y) * cfg.decim + self.n_taps - 1
        self._dev = resolve_device(self.device)
        self._cap_cfg = dataclasses.replace(cfg, max_events=self.events_per_chunk)

    def _chunk_decode(self, x2: torch.Tensor) -> DecodedEvents:
        """x2: planar (2, ctx_adc + chunk_adc) float32 on the device.  Owned
        local indices: [hl_y, hl_y + chunk_y)."""
        cfg = self.cfg
        y, events = gate_block(x2, cfg, self._cap_cfg)
        owned = (events.valid & (events.index >= self.hl_y)
                 & (events.index < self.hl_y + self.chunk_y))
        events = events._replace(valid=owned)
        dec = decode_events(y, events, cfg, specialize=cfg.mode != "compat")
        return dec._replace(valid=owned)

    # The resumable state is (context tail, buffered samples, counts, the
    # per-chunk event tables as dicts of numpy arrays).

    def reset(self) -> None:
        self._tables = []
        self._ctx = np.zeros(self.ctx_adc, np.complex64)      # zero history
        self._buf = np.zeros(0, np.complex64)
        self._total_adc = 0
        self._chunk_no = 0

    def _flush(self, block: np.ndarray) -> None:
        x_ext = np.concatenate([self._ctx, block])
        x2 = torch.from_numpy(np.stack([x_ext.real, x_ext.imag]).astype(np.float32))
        dec = decoded_to_numpy(self._chunk_decode(x2.to(self._dev)))
        # Local owned index hl_y maps to global chunk_no * chunk_y - hr_y.
        g0 = self._chunk_no * self.chunk_y - self.hl_y - self.hr_y
        dec["index"] = np.where(dec["valid"], dec["index"] + g0, UNOWNED)
        self._tables.append(dec)
        self._ctx = x_ext[-self.ctx_adc:]
        self._chunk_no += 1

    def feed(self, chunk: np.ndarray) -> None:
        """Feed ADC-rate complex64 samples (any length)."""
        if not hasattr(self, "_tables"):
            self.reset()
        chunk = np.asarray(chunk, np.complex64)
        self._total_adc += len(chunk)
        self._buf = np.concatenate([self._buf, chunk])
        while len(self._buf) >= self.chunk_adc:
            self._flush(self._buf[: self.chunk_adc])
            self._buf = self._buf[self.chunk_adc:]

    def save_checkpoint(self, path: str) -> None:
        """Persist the decode state; a new StreamDecoder (of either package)
        resumes from it."""
        table_arrays = {f"t{i}_{name}": arr for i, t in enumerate(self._tables)
                        for name, arr in t.items()}
        np.savez_compressed(
            path, ctx=self._ctx, buf=self._buf,
            total_adc=self._total_adc, chunk_no=self._chunk_no,
            n_tables=len(self._tables), **table_arrays,
        )

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as z:
            self._ctx = z["ctx"]
            self._buf = z["buf"]
            self._total_adc = int(z["total_adc"])
            self._chunk_no = int(z["chunk_no"])
            self._tables = [{f: z[f"t{i}_{f}"] for f in DecodedEvents._fields}
                            for i in range(int(z["n_tables"]))]

    def finish(self) -> Tuple[InventoryStats, int]:
        """Close the stream (pad + zero chunk) and replay the global FSM:
        (stats on the device, ADC samples fed)."""
        cfg = self.cfg
        if not hasattr(self, "_tables"):
            self.reset()
        self._flush(np.pad(self._buf, (0, self.chunk_adc - len(self._buf))))
        self._buf = np.zeros(0, np.complex64)
        self._flush(np.zeros(self.chunk_adc, np.complex64))
        dec = {f: np.concatenate([t[f] for t in self._tables], axis=0)
               for f in DecodedEvents._fields}
        order = np.argsort(dec["index"], kind="stable")
        dec = {f: a[order] for f, a in dec.items()}
        # Drop events past the real capture end and re-check window fit
        # against the real length (a window that cannot fill is never
        # decoded).
        total_y = self._total_adc // cfg.decim
        idx = dec["index"]
        dec["valid"] = dec["valid"] & (idx < total_y)
        dec["rn16_fits"] = dec["rn16_fits"] & (idx + cfg.rn16_window <= total_y)
        dec["epc_fits"] = dec["epc_fits"] & (idx + cfg.epc_window <= total_y)
        keep = min(len(idx), max(cfg.max_events, 1))
        table = decoded_from_numpy({f: a[:keep] for f, a in dec.items()}, self._dev)
        return replay_inventory(table, cfg), self._total_adc

    def decode(self, chunks: Iterable[np.ndarray]) -> Tuple[InventoryStats, int]:
        """Decode an iterable of ADC-rate complex64 chunks -> (stats, total)."""
        self.reset()
        for chunk in chunks:
            self.feed(chunk)
        return self.finish()
