"""ctypes bindings and build at first use for the native streaming engine.

PyTorch counterpart of ``gen2_rfid_tpu/native/engine.py``.  ``gen2_stream.cc``
(a verbatim copy of the JAX package's) is the framework's host C++ decoder:
a closed-loop streaming gate, decode and round FSM over ADC-rate chunks,
exposed through a plain-C ABI.  It runs on the host CPU; no GPU is involved.

The library is built with the JAX package's ``g++`` flags into
``build/gen2_rfid_tpu_torch/libgen2_stream-<hash>.so`` beside the package
(``kernels/_build.py``'s directory), where the hash covers the source, the
flags and the host (``-march=native`` ties the library to the CPU that built
it): an edited source builds anew, an unchanged one is loaded as it is.  The
stats come back as the port's ``InventoryStats``, every field a CPU tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ReaderConfig
from ..kernels._build import BUILD_DIR
from ..runtime.stats import InventoryStats

SRC = Path(__file__).resolve().parent / "gen2_stream.cc"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class _Params(ctypes.Structure):
    _fields_ = [
        ("decim", ctypes.c_int32),
        ("n_taps", ctypes.c_int32),
        ("win_length", ctypes.c_int32),
        ("dc_length", ctypes.c_int32),
        ("n_samples_t1", ctypes.c_int32),
        ("pw_half", ctypes.c_int32),
        ("num_pulses_command", ctypes.c_int32),
        ("thresh_fraction", ctypes.c_float),
        ("n_samples_tag_bit", ctypes.c_float),
        ("rn16_window", ctypes.c_int32),
        ("epc_window", ctypes.c_int32),
        ("rn16_half_bits", ctypes.c_int32),
        ("epc_data_bits", ctypes.c_int32),
        ("tag_preamble_bits", ctypes.c_int32),
        ("max_slot", ctypes.c_int32),
        ("max_queries", ctypes.c_int32),
        ("max_unique", ctypes.c_int32),
        ("pc_length", ctypes.c_int32),
        ("miller_m", ctypes.c_int32),
        ("trext", ctypes.c_int32),
    ]


class _Stats(ctypes.Structure):
    _fields_ = [
        ("n_queries", ctypes.c_int32),
        ("cur_round", ctypes.c_int32),
        ("cur_slot", ctypes.c_int32),
        ("n_epc_correct", ctypes.c_int32),
        ("n_events", ctypes.c_int32),
        ("terminated", ctypes.c_int32),
        ("tag_reads", ctypes.c_int32 * 256),
    ]


def library_path() -> Path:
    digest = hashlib.sha256()
    digest.update(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"libgen2_stream-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # Built under a name of this process's own, then renamed into place:
        # concurrent builds never load a half-written library.
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            lib.gen2_engine_new.restype = ctypes.c_void_p
            lib.gen2_engine_new.argtypes = [ctypes.POINTER(_Params)]
            lib.gen2_engine_free.restype = None
            lib.gen2_engine_free.argtypes = [ctypes.c_void_p]
            lib.gen2_engine_feed.restype = None
            lib.gen2_engine_feed.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib.gen2_engine_stats.restype = None
            lib.gen2_engine_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Stats)]
            lib.gen2_engine_events.restype = ctypes.c_int64
            lib.gen2_engine_events.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the engine builds (``g++`` present) and loads here."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


def _params(cfg: ReaderConfig) -> _Params:
    return _Params(
        decim=cfg.decim,
        n_taps=int(cfg.tag_bit_us / 2 * cfg.adc_rate / 1e6 / cfg.miller_m),
        win_length=cfg.win_length,
        dc_length=cfg.dc_length,
        n_samples_t1=cfg.n_samples_t1,
        pw_half=cfg.n_samples_pw // 2,
        num_pulses_command=cfg.num_pulses_command,
        thresh_fraction=cfg.thresh_fraction,
        n_samples_tag_bit=cfg.n_samples_tag_bit,
        rn16_window=cfg.rn16_window,
        epc_window=cfg.epc_window,
        rn16_half_bits=cfg.rn16_half_bits,
        epc_data_bits=cfg.epc_data_bits,
        tag_preamble_bits=cfg.tag_preamble_bits,
        max_slot=cfg.max_slot_number,
        max_queries=cfg.max_num_queries,
        max_unique=cfg.max_unique_tags,
        # Native mode parses the PC length field (variable-length EPC);
        # compat pins the reference's fixed-length check.
        pc_length=0 if cfg.mode == "compat" else 1,
        miller_m=cfg.miller_m,
        trext=cfg.trext,
    )


def _i32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


class NativeEngine:
    """Streaming closed-loop decoder: feed ADC-rate chunks, read stats."""

    def __init__(self, cfg: ReaderConfig):
        self.cfg = cfg
        self._lib = _lib()
        self._h = self._lib.gen2_engine_new(ctypes.byref(_params(cfg)))

    def feed(self, iq: np.ndarray) -> None:
        iq = np.ascontiguousarray(iq, dtype=np.complex64)
        ptr = iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.gen2_engine_feed(self._h, ptr, iq.size)

    def events(self, cap: int = 65536) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self._lib.gen2_engine_events(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        return out[:n]

    def stats(self) -> InventoryStats:
        """Every field of the port's InventoryStats as a CPU tensor.  The
        engine keeps no slot-state or command-type accounting and no
        per-round unique counts: those fields are zero (empty for the
        per-round counts), as the JAX adapter's defaults leave them."""
        s = _Stats()
        self._lib.gen2_engine_stats(self._h, ctypes.byref(s))
        reads = np.ctypeslib.as_array(s.tag_reads).copy()
        return InventoryStats(
            n_queries=_i32(s.n_queries),
            cur_inventory_round=_i32(s.cur_round),
            cur_slot=_i32(s.cur_slot),
            n_epc_correct=_i32(s.n_epc_correct),
            tag_reads=torch.from_numpy(reads),
            unique_tags_round=torch.zeros(0, dtype=torch.int32),
            n_rounds_closed=_i32(s.cur_round - 1),
            n_events=_i32(s.n_events),
            terminated=torch.tensor(bool(s.terminated)),
            n_slot_empty=_i32(0),
            n_slot_single=_i32(0),
            n_slot_collision=_i32(0),
            cmd_counts=torch.zeros(6, dtype=torch.int32),
        )

    def close(self) -> None:
        if self._h:
            self._lib.gen2_engine_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
