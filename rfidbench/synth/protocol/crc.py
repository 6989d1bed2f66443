"""EPC Gen2 CRC-5 and CRC-16/CCITT.

Re-derivation of the checks used by the reference (CRC-5 shift register in
``reader_impl.cc:383-443``; bit-serial CRC-16 in ``tag_decoder_impl.cc:401-445``:
poly 0x1021, init 0xFFFF, final complement, MSB-first byte packing).

TPU-first design: CRC over GF(2) is affine in the message bits, so the frame
check becomes ``crc(d) = (M @ d) mod 2  XOR  crc(0)`` with a precomputed
16 x n_bits 0/1 matrix - a tiny matmul that XLA fuses into the batched decode
instead of a 112-step serial loop per frame.
"""

from __future__ import annotations

import functools

import numpy as np

CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF

# Gen2 CRC-5: poly x^5 + x^3 + 1, preset 01001 (reader_impl.cc:385 seeds the
# register as {1,0,0,1,0} in its index order).
CRC5_POLY = 0x09
CRC5_INIT = 0x09  # bit4..bit0 = 01001


def crc5_append(bits: np.ndarray) -> np.ndarray:
    """Return ``bits`` with the Gen2 CRC-5 appended (MSB first).

    Matches the Query construction path (reader_impl.cc:131-146): the CRC is
    computed over the first 17 Query bits and appended to make 22.
    """
    bits = np.asarray(bits, dtype=np.int64)
    reg = [(CRC5_INIT >> i) & 1 for i in range(5)]  # reg[i] = coefficient of x^i
    for b in bits:
        fb = reg[4] ^ int(b)
        reg = [fb, reg[0], reg[1], reg[2] ^ fb, reg[3]]
    crc = np.array(reg[::-1], dtype=np.int64)  # MSB (x^4) first
    return np.concatenate([bits, crc])


def crc16_bits(data_bits: np.ndarray) -> np.ndarray:
    """CRC-16/CCITT over MSB-first bits; returns 16 bits MSB first.

    Bit-serial NumPy oracle used for test vectors and for the tag simulator's
    frame synthesis; must invert to 0 residue under check_crc16 semantics.
    """
    data_bits = np.asarray(data_bits, dtype=np.int64)
    assert data_bits.size % 8 == 0, "reference packs bits into whole bytes"
    crc = CRC16_INIT
    for i in range(0, data_bits.size, 8):
        byte = 0
        for j in range(8):
            byte = (byte << 1) | int(data_bits[i + j])
        crc ^= byte << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ CRC16_POLY) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
    crc = (~crc) & 0xFFFF
    return np.array([(crc >> (15 - k)) & 1 for k in range(16)], dtype=np.int64)


def check_crc16(frame_bits: np.ndarray) -> bool:
    """Check an EPC frame: last 16 bits are the CRC of the preceding bits.

    Semantics of tag_decoder_impl.cc:401-445 (pack MSB-first, compare received
    CRC word with computed one).
    """
    frame_bits = np.asarray(frame_bits, dtype=np.int64)
    data, rcvd = frame_bits[:-16], frame_bits[-16:]
    return bool(np.array_equal(crc16_bits(data), rcvd))


@functools.lru_cache(maxsize=8)
def crc16_affine(n_data_bits: int):
    """Precompute (M, c0) with crc_bits(d) == (M @ d) % 2 ^ c0.

    M is (16, n_data_bits) uint8; c0 is (16,) uint8 (the CRC of the all-zero
    message, which absorbs the nonzero init and final complement).  Used by
    the vectorized JAX checker: one tiny matmul per frame instead of a serial
    LFSR - this keeps the whole EPC validation stage on the TPU with no
    per-frame Python.
    """
    assert n_data_bits % 8 == 0
    zero = np.zeros(n_data_bits, dtype=np.int64)
    c0 = crc16_bits(zero)
    cols = np.empty((16, n_data_bits), dtype=np.uint8)
    for i in range(n_data_bits):
        e = zero.copy()
        e[i] = 1
        cols[:, i] = (crc16_bits(e) ^ c0).astype(np.uint8)
    return cols, c0.astype(np.uint8)
