"""Gen2 command bit synthesis (Query / QueryRep / QueryAdjust / ACK / NAK).

Covers the reference's command builders (``reader_impl.cc:131-162`` plus the
command codes in ``global_vars.h:115-133``).  All builders are plain NumPy -
commands are tiny and static per config, so they are computed once at trace /
schedule build time and baked into jit-static waveform tables.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    ACK_CODE,
    NAK_CODE,
    QADJ_CODE,
    QREP_CODE,
    QUERY_CODE,
    Q_UPDN,
    Q_VALUE,
    ReaderConfig,
)
from .crc import crc5_append, crc16_bits

_MILLER_CODE = {1: (0, 0), 2: (0, 1), 4: (1, 0), 8: (1, 1)}

# Query Sel field (EPC Gen2 6.3.2.12.1): which SL population participates.
SEL_ALL = (0, 0)
SEL_NOT_SL = (1, 0)
SEL_SL = (1, 1)


def query_bits(cfg: ReaderConfig, q: int = None,
               target: int = None, sel=None) -> np.ndarray:
    """22-bit Query: code+DR+M+TRext+Sel+Session+Target+Q then CRC-5.

    Field order follows reader_impl.cc:131-146.  ``q`` overrides the
    config's fixed Q (the adaptive live reader re-issues Query with its
    current Q; the reference pins FIXED_Q, global_vars.h:72); ``target``
    overrides the config's inventoried-flag target (0=A / 1=B — the
    reference pins TARGET=0, global_vars.h:121; the live reader's
    session-inventory mode flips it between passes); ``sel`` overrides the
    Sel field (SEL_ALL / SEL_NOT_SL / SEL_SL — pair with a preceding
    Select command to inventory a masked sub-population).
    """
    bits = list(QUERY_CODE)
    bits.append(cfg.dr)
    bits.extend(_MILLER_CODE[cfg.miller_m])
    bits.append(cfg.trext)
    bits.extend(cfg.sel if sel is None else sel)
    bits.extend(cfg.session)
    bits.append(cfg.target if target is None else target)
    bits.extend(Q_VALUE[cfg.fixed_q if q is None else q])
    out = crc5_append(np.array(bits, dtype=np.int64))
    assert out.size == cfg.query_length
    return out


def parse_query_q(bits: np.ndarray) -> int:
    """Q field of a transmitted Query (bits[13:17], MSB first) - how a
    listening tag learns the slot-count, EPC Gen2 spec section 6.3.2.12.1."""
    b = np.asarray(bits, dtype=np.int64)
    return int(b[13] * 8 + b[14] * 4 + b[15] * 2 + b[16])


def parse_query_m(bits: np.ndarray) -> int:
    """M field of a transmitted Query (bits[5:7]) -> 1/2/4/8: which
    backscatter encoding (FM0 or Miller-M) the Query commands for the
    round's replies, EPC Gen2 spec 6.3.2.12.1.  Real tags take their
    reply encoding from here — the key to reader-side link-rate
    adaptation (runtime/live.py link_profiles)."""
    b = np.asarray(bits, dtype=np.int64)
    inv = {v: k for k, v in _MILLER_CODE.items()}
    return inv[(int(b[5]), int(b[6]))]


def parse_query_trext(bits: np.ndarray) -> int:
    """TRext field of a transmitted Query (bit 7): 1 commands the extended
    (pilot-tone) tag preamble, EPC Gen2 spec 6.3.2.12.1."""
    return int(np.asarray(bits, dtype=np.int64)[7])


def parse_query_sel(bits: np.ndarray):
    """Sel field of a transmitted Query (bits 8:10 — after code4+DR+M2+
    TRext): 00/01 all, 10 ~SL, 11 SL (EPC Gen2 spec 6.3.2.12.1)."""
    b = np.asarray(bits, dtype=np.int64)
    return (int(b[8]), int(b[9]))


def parse_query_session(bits: np.ndarray) -> int:
    """Session field of a transmitted Query (bits 10:12) -> 0..3 (S0-S3),
    EPC Gen2 spec 6.3.2.12.1: which session's inventoried flag the round
    reads and toggles."""
    b = np.asarray(bits, dtype=np.int64)
    return int(b[10] * 2 + b[11])


def parse_query_target(bits: np.ndarray) -> int:
    """Target field of a transmitted Query (bit 12): which inventoried-flag
    population (0=A / 1=B) shall participate, EPC Gen2 spec 6.3.2.12.1."""
    return int(np.asarray(bits, dtype=np.int64)[12])


def parse_query_adjust_updn(bits: np.ndarray) -> int:
    """UpDn field of a QueryAdjust (bits[6:9]) -> +1 / 0 / -1."""
    row = tuple(int(x) for x in np.asarray(bits)[6:9])
    table = {tuple(Q_UPDN[0]): +1, tuple(Q_UPDN[1]): 0, tuple(Q_UPDN[2]): -1}
    return table[row]


def query_rep_bits(cfg: ReaderConfig) -> np.ndarray:
    """QueryRep = command 00 + 2-bit session (reader_impl.cc:110-114 sends
    frame-sync + four data-0 symbols, i.e. bits 0,0,0,0)."""
    return np.array(list(QREP_CODE) + list(cfg.session), dtype=np.int64)


def ack_bits(rn16: np.ndarray) -> np.ndarray:
    """ACK = 01 + RN16 (reader_impl.cc:149-154)."""
    rn16 = np.asarray(rn16, dtype=np.int64)
    assert rn16.size == 16
    return np.concatenate([np.array(ACK_CODE, dtype=np.int64), rn16])


def query_adjust_bits(cfg: ReaderConfig, updn: int = 0) -> np.ndarray:
    """QueryAdjust = 1001 + session + Q_UPDN row (reader_impl.cc:156-162).

    ``updn``: +1 increment, 0 unchanged, -1 decrement.
    """
    row = {1: Q_UPDN[0], 0: Q_UPDN[1], -1: Q_UPDN[2]}[updn]
    return np.array(list(QADJ_CODE) + list(cfg.session) + list(row), dtype=np.int64)


def nak_bits() -> np.ndarray:
    return np.array(NAK_CODE, dtype=np.int64)


# Access commands (EPC Gen2 6.3.2.12.3) - the reference stops at inventory
# (reader_impl.cc:200-380 never leaves the Query/ACK loop).  New capability:
# Req_RN fetches a 16-bit handle from an acknowledged tag; Read returns
# memory words.  Replies are CRC-16-protected, Read additionally echoes the
# handle - both checked by the live reader.
REQ_RN_CODE = (1, 1, 0, 0, 0, 0, 0, 1)
READ_CODE = (1, 1, 0, 0, 0, 0, 1, 0)
WRITE_CODE = (1, 1, 0, 0, 0, 0, 1, 1)
KILL_CODE = (1, 1, 0, 0, 0, 1, 0, 0)
LOCK_CODE = (1, 1, 0, 0, 0, 1, 0, 1)
ACCESS_CODE = (1, 1, 0, 0, 0, 1, 1, 0)
BLOCKWRITE_CODE = (1, 1, 0, 0, 0, 1, 1, 1)
MEMBANK_RESERVED = (0, 0)
MEMBANK_TID = (1, 0)
MEMBANK_USER = (1, 1)


def req_rn_bits(rn16: np.ndarray) -> np.ndarray:
    """Req_RN = 11000001 + RN16 + CRC-16 (Gen2 6.3.2.12.3.1)."""
    rn16 = np.asarray(rn16, dtype=np.int64)
    assert rn16.size == 16
    body = np.concatenate([np.array(REQ_RN_CODE, dtype=np.int64), rn16])
    return np.concatenate([body, _crc16_any(body)])


def parse_req_rn(bits: np.ndarray):
    """-> (rn16 (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == REQ_RN_CODE
    return b[8:24], bool(np.array_equal(_crc16_any(b[:24]), b[24:]))


def read_bits(handle: np.ndarray, membank=None, wordptr: int = 2,
              wordcount: int = 1) -> np.ndarray:
    """Read = 11000010 + MemBank(2) + WordPtr(EBV-8) + WordCount(8) +
    handle(16) + CRC-16 (Gen2 6.3.2.12.3.2).  Defaults read the EPC bank
    from word 2 (the EPC field: StoredCRC word 0, PC word 1)."""
    handle = np.asarray(handle, dtype=np.int64)
    membank = MEMBANK_EPC if membank is None else membank
    assert handle.size == 16 and 0 <= wordptr < 128
    bits = list(READ_CODE) + list(membank)
    bits += [(wordptr >> k) & 1 for k in range(7, -1, -1)]   # EBV-8
    bits += [(wordcount >> k) & 1 for k in range(7, -1, -1)]
    body = np.concatenate([np.array(bits, dtype=np.int64), handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_read(bits: np.ndarray):
    """-> (membank, wordptr, wordcount, handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == READ_CODE
    membank = (int(b[8]), int(b[9]))
    wordptr = int("".join(map(str, b[10:18])), 2)
    wordcount = int("".join(map(str, b[18:26])), 2)
    handle = b[26:42]
    crc_ok = bool(np.array_equal(_crc16_any(b[:42]), b[42:]))
    return membank, wordptr, wordcount, handle, crc_ok


def write_bits(handle: np.ndarray, cover_data: np.ndarray, membank=None,
               wordptr: int = 0) -> np.ndarray:
    """Write = 11000011 + MemBank(2) + WordPtr(EBV-8) + Data(16,
    cover-coded: word XOR a fresh RN16 from a second Req_RN) + handle(16)
    + CRC-16 (Gen2 6.3.2.12.3.3)."""
    handle = np.asarray(handle, dtype=np.int64)
    cover_data = np.asarray(cover_data, dtype=np.int64)
    membank = MEMBANK_USER if membank is None else membank
    assert handle.size == 16 and cover_data.size == 16
    assert 0 <= wordptr < 128
    bits = list(WRITE_CODE) + list(membank)
    bits += [(wordptr >> k) & 1 for k in range(7, -1, -1)]   # EBV-8
    body = np.concatenate([np.array(bits, dtype=np.int64), cover_data,
                           handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_write(bits: np.ndarray):
    """-> (membank, wordptr, cover_data (16,), handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == WRITE_CODE
    membank = (int(b[8]), int(b[9]))
    wordptr = int("".join(map(str, b[10:18])), 2)
    cover = b[18:34]
    handle = b[34:50]
    crc_ok = bool(np.array_equal(_crc16_any(b[:50]), b[50:]))
    return membank, wordptr, cover, handle, crc_ok


def write_reply_bits(handle: np.ndarray) -> np.ndarray:
    """Tag success reply to Write: header-0 + handle + CRC-16 over
    header+handle (33 bits, Gen2 6.3.2.12.3.3)."""
    body = np.concatenate([np.zeros(1, np.int64),
                           np.asarray(handle, dtype=np.int64)])
    return np.concatenate([body, _crc16_any(body)])


def handle_reply_bits(handle: np.ndarray) -> np.ndarray:
    """Tag reply to Req_RN: handle + CRC-16 over the handle (32 bits)."""
    handle = np.asarray(handle, dtype=np.int64)
    return np.concatenate([handle, _crc16_any(handle)])


def read_reply_bits(words: np.ndarray, handle: np.ndarray) -> np.ndarray:
    """Tag reply to Read: header-0 + data + handle + CRC-16 over
    header+data+handle (Gen2 6.3.2.12.3.2)."""
    body = np.concatenate([np.zeros(1, np.int64),
                           np.asarray(words, dtype=np.int64),
                           np.asarray(handle, dtype=np.int64)])
    return np.concatenate([body, _crc16_any(body)])


# ---- security commands (EPC Gen2 6.3.2.12.3.4-6) --------------------------
# Access (password -> Secured state), Kill, Lock, BlockWrite: the rest of
# the spec's access-command set, absent from the reference entirely.  Each
# password travels as two cover-coded 16-bit halves (MSB half first), each
# half XOR'd with a fresh RN16 fetched by Req_RN(handle).

def access_bits(handle: np.ndarray, cover_half: np.ndarray) -> np.ndarray:
    """Access = 11000110 + password half (16, cover-coded) + handle(16) +
    CRC-16 (Gen2 6.3.2.12.3.6).  Two Accesses (MSB half then LSB half) move
    an Open tag to Secured; the tag echoes its handle after each."""
    handle = np.asarray(handle, dtype=np.int64)
    cover_half = np.asarray(cover_half, dtype=np.int64)
    assert handle.size == 16 and cover_half.size == 16
    body = np.concatenate([np.array(ACCESS_CODE, dtype=np.int64),
                           cover_half, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_access(bits: np.ndarray):
    """-> (cover_half (16,), handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == ACCESS_CODE
    return b[8:24], b[24:40], bool(np.array_equal(_crc16_any(b[:40]), b[40:]))


def kill_bits(handle: np.ndarray, cover_half: np.ndarray,
              rfu=(0, 0, 0)) -> np.ndarray:
    """Kill = 11000100 + password half (16, cover-coded) + RFU(3) + handle
    (16) + CRC-16 (Gen2 6.3.2.12.3.4).  The first Kill carries the kill
    password's MSB half (tag echoes its handle); the second carries the LSB
    half and, when valid, permanently silences the tag (delayed header-0 +
    handle + CRC reply).  RFU=000; nonzero values are the recommissioning
    extension."""
    handle = np.asarray(handle, dtype=np.int64)
    cover_half = np.asarray(cover_half, dtype=np.int64)
    assert handle.size == 16 and cover_half.size == 16
    body = np.concatenate([np.array(KILL_CODE, dtype=np.int64), cover_half,
                           np.array(rfu, dtype=np.int64), handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_kill(bits: np.ndarray):
    """-> (cover_half (16,), rfu (3,), handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == KILL_CODE
    return (b[8:24], b[24:27], b[27:43],
            bool(np.array_equal(_crc16_any(b[:43]), b[43:])))


# Lock payload field order (Gen2 table 6.36): 2 bits per field, fields are
# [kill pwd, access pwd, EPC bank, TID bank, USER bank].  For the password
# fields the first action bit is pwd-read/write (bank readable/writable only
# in Secured), for the memory banks it is pwd-write; the second bit is
# permalock.
LOCK_FIELDS = ("kill", "access", "epc", "tid", "user")


def lock_payload(**fields) -> np.ndarray:
    """Build the 20-bit Lock payload: 10 mask bits + 10 action bits.

    Keyword per field in ``LOCK_FIELDS``: a ``(lock, permalock)`` pair of
    0/1 (both action bits asserted in the mask), or ``None``/omitted to
    skip the field (mask 0).  E.g. ``lock_payload(epc=(1, 0))`` write-locks
    the EPC bank, ``lock_payload(kill=(1, 1))`` permanently password-locks
    the kill password.
    """
    mask = np.zeros(10, dtype=np.int64)
    action = np.zeros(10, dtype=np.int64)
    for i, name in enumerate(LOCK_FIELDS):
        pair = fields.pop(name, None)
        if pair is None:
            continue
        mask[2 * i: 2 * i + 2] = 1
        action[2 * i] = int(pair[0])
        action[2 * i + 1] = int(pair[1])
    assert not fields, f"unknown lock fields: {sorted(fields)}"
    return np.concatenate([mask, action])


def lock_bits(handle: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Lock = 11000101 + payload(20) + handle(16) + CRC-16
    (Gen2 6.3.2.12.3.5).  Valid only in the Secured state; success reply is
    the delayed header-0 + handle + CRC-16."""
    handle = np.asarray(handle, dtype=np.int64)
    payload = np.asarray(payload, dtype=np.int64)
    assert handle.size == 16 and payload.size == 20
    body = np.concatenate([np.array(LOCK_CODE, dtype=np.int64), payload,
                           handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_lock(bits: np.ndarray):
    """-> (payload (20,), handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == LOCK_CODE
    return b[8:28], b[28:44], bool(np.array_equal(_crc16_any(b[:44]), b[44:]))


def blockwrite_bits(handle: np.ndarray, data: np.ndarray, membank=None,
                    wordptr: int = 0) -> np.ndarray:
    """BlockWrite = 11000111 + MemBank(2) + WordPtr(EBV-8) + WordCount(8) +
    Data(16*WordCount, NOT cover-coded) + handle(16) + CRC-16
    (Gen2 6.3.2.12.3.7): the multi-word write, plaintext data (unlike
    Write's one cover-coded word)."""
    handle = np.asarray(handle, dtype=np.int64)
    data = np.asarray(data, dtype=np.int64)
    membank = MEMBANK_USER if membank is None else membank
    assert handle.size == 16 and data.size % 16 == 0 and data.size > 0
    wordcount = data.size // 16
    assert 0 <= wordptr < 128 and wordcount < 256
    bits = list(BLOCKWRITE_CODE) + list(membank)
    bits += [(wordptr >> k) & 1 for k in range(7, -1, -1)]   # EBV-8
    bits += [(wordcount >> k) & 1 for k in range(7, -1, -1)]
    body = np.concatenate([np.array(bits, dtype=np.int64), data, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_blockwrite(bits: np.ndarray):
    """-> (membank, wordptr, data, handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == BLOCKWRITE_CODE
    membank = (int(b[8]), int(b[9]))
    wordptr = int("".join(map(str, b[10:18])), 2)
    wordcount = int("".join(map(str, b[18:26])), 2)
    data = b[26: 26 + 16 * wordcount]
    handle = b[26 + 16 * wordcount: 42 + 16 * wordcount]
    body = b[: 42 + 16 * wordcount]
    crc_ok = bool(np.array_equal(_crc16_any(body), b[42 + 16 * wordcount:]))
    return membank, wordptr, data, handle, crc_ok


BLOCKERASE_CODE = (1, 1, 0, 0, 1, 0, 0, 0)
BLOCKPERMALOCK_CODE = (1, 1, 0, 0, 1, 0, 0, 1)


def blockerase_bits(handle: np.ndarray, membank=None, wordptr: int = 0,
                    wordcount: int = 1) -> np.ndarray:
    """BlockErase = 11001000 + MemBank(2) + WordPtr(EBV-8) + WordCount(8) +
    handle(16) + CRC-16 (Gen2 6.3.2.12.3.8): zero WordCount words starting
    at WordPtr; delayed Write-style success reply (header-0 + handle +
    CRC-16)."""
    handle = np.asarray(handle, dtype=np.int64)
    membank = MEMBANK_USER if membank is None else membank
    assert handle.size == 16 and 0 <= wordptr < 128 and 0 < wordcount < 256
    bits = list(BLOCKERASE_CODE) + list(membank)
    bits += [(wordptr >> k) & 1 for k in range(7, -1, -1)]   # EBV-8
    bits += [(wordcount >> k) & 1 for k in range(7, -1, -1)]
    body = np.concatenate([np.array(bits, dtype=np.int64), handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_blockerase(bits: np.ndarray):
    """-> (membank, wordptr, wordcount, handle (16,), crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == BLOCKERASE_CODE
    membank = (int(b[8]), int(b[9]))
    wordptr = int("".join(map(str, b[10:18])), 2)
    wordcount = int("".join(map(str, b[18:26])), 2)
    handle = b[26:42]
    crc_ok = bool(np.array_equal(_crc16_any(b[:42]), b[42:]))
    return membank, wordptr, wordcount, handle, crc_ok


def blockpermalock_bits(handle: np.ndarray, membank=None, read_lock: int = 0,
                        blockptr: int = 0, blockrange: int = 1,
                        mask: np.ndarray = None) -> np.ndarray:
    """BlockPermalock = 11001001 + RFU(8) + Read/Lock(1) + MemBank(2) +
    BlockPtr(EBV-8) + BlockRange(8) + Mask(16*BlockRange, only when
    Read/Lock=1) + handle(16) + CRC-16 (Gen2 6.3.2.12.3.9).

    Read/Lock=0 requests the permalock-status bits of BlockRange mask
    words starting at BlockPtr (Read-style reply); Read/Lock=1 permalocks
    the blocks whose mask bit is 1 (one-way; delayed Write-style reply).
    Block granularity is vendor-defined - the tag model uses one 16-bit
    word per block, so mask word i bit j covers word 16*BlockPtr+16i+j.
    """
    handle = np.asarray(handle, dtype=np.int64)
    membank = MEMBANK_USER if membank is None else membank
    assert handle.size == 16 and 0 <= blockptr < 128 and 0 < blockrange < 256
    if read_lock:
        mask = np.asarray(mask, dtype=np.int64)
        assert mask.size == 16 * blockrange
    else:
        assert mask is None
        mask = np.zeros(0, dtype=np.int64)
    bits = list(BLOCKPERMALOCK_CODE) + [0] * 8 + [int(read_lock)]
    bits += list(membank)
    bits += [(blockptr >> k) & 1 for k in range(7, -1, -1)]  # EBV-8
    bits += [(blockrange >> k) & 1 for k in range(7, -1, -1)]
    body = np.concatenate([np.array(bits, dtype=np.int64), mask, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_blockpermalock(bits: np.ndarray):
    """-> (membank, read_lock, blockptr, blockrange, mask, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == BLOCKPERMALOCK_CODE
    read_lock = int(b[16])
    membank = (int(b[17]), int(b[18]))
    blockptr = int("".join(map(str, b[19:27])), 2)
    blockrange = int("".join(map(str, b[27:35])), 2)
    nm = 16 * blockrange if read_lock else 0
    mask = b[35: 35 + nm]
    handle = b[35 + nm: 51 + nm]
    crc_ok = bool(np.array_equal(_crc16_any(b[: 51 + nm]), b[51 + nm:]))
    return membank, read_lock, blockptr, blockrange, mask, handle, crc_ok


# ---- Gen2 v2 security commands (EPC UHF Gen2 v2.0.1 6.3.2.12.3.10-12) ----
# Cryptographic tag authentication - a whole protocol generation past the
# reference (which predates Gen2 v2 entirely).  Challenge is broadcast
# before inventory so tags precompute their response; Authenticate is
# handle-addressed with an immediate reply; ReadBuffer retrieves a stored
# (Challenge-precomputed) response.  The crypto suite itself lives in
# protocol/crypto.py (ISO 29167-10 AES-128, TAM1).

CHALLENGE_CODE = (1, 1, 0, 1, 0, 1, 0, 0)
AUTHENTICATE_CODE = (1, 1, 0, 1, 0, 1, 0, 1)
READBUFFER_CODE = (1, 1, 0, 1, 0, 0, 1, 0)


def _len12(n: int):
    return [(n >> k) & 1 for k in range(11, -1, -1)]


def challenge_bits(message: np.ndarray, csi: int = 0,
                   immed: int = 0) -> np.ndarray:
    """Challenge = 11010100 + Immed(1) + IncRepLen(1)=0 + RFU(2) + CSI(8) +
    Length(12) + Message + CRC-16 (Gen2 v2 6.3.2.12.3.10).  Broadcast (no
    handle); tags supporting the suite precompute their response into the
    ResponseBuffer (Immed=0; Immed=1's EPC-appended reply is not modeled)."""
    message = np.asarray(message, dtype=np.int64)
    assert immed == 0, "Immed=1 (EPC-appended reply) not modeled"
    bits = list(CHALLENGE_CODE) + [immed, 0, 0, 0]
    bits += [(csi >> k) & 1 for k in range(7, -1, -1)]
    bits += _len12(message.size)
    body = np.concatenate([np.array(bits, dtype=np.int64), message])
    return np.concatenate([body, _crc16_any(body)])


def parse_challenge(bits: np.ndarray):
    """-> (immed, csi, message, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == CHALLENGE_CODE
    immed = int(b[8])
    csi = int("".join(map(str, b[12:20])), 2)
    n = int("".join(map(str, b[20:32])), 2)
    message = b[32: 32 + n]
    body = b[: 32 + n]
    return immed, csi, message, bool(
        np.array_equal(_crc16_any(body), b[32 + n:]))


def authenticate_bits(handle: np.ndarray, message: np.ndarray,
                      csi: int = 0) -> np.ndarray:
    """Authenticate = 11010101 + RFU(2) + SenRep(1)=1 + IncRepLen(1)=0 +
    CSI(8) + Length(12) + Message + handle(16) + CRC-16
    (Gen2 v2 6.3.2.12.3.11).  SenRep=1: the tag sends its response in the
    reply (header-0 + response + handle + CRC-16) rather than storing it."""
    handle = np.asarray(handle, dtype=np.int64)
    message = np.asarray(message, dtype=np.int64)
    assert handle.size == 16
    bits = list(AUTHENTICATE_CODE) + [0, 0, 1, 0]
    bits += [(csi >> k) & 1 for k in range(7, -1, -1)]
    bits += _len12(message.size)
    body = np.concatenate([np.array(bits, dtype=np.int64), message, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_authenticate(bits: np.ndarray):
    """-> (senrep, csi, message, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == AUTHENTICATE_CODE
    senrep = int(b[10])
    csi = int("".join(map(str, b[12:20])), 2)
    n = int("".join(map(str, b[20:32])), 2)
    message = b[32: 32 + n]
    handle = b[32 + n: 48 + n]
    body = b[: 48 + n]
    return senrep, csi, message, handle, bool(
        np.array_equal(_crc16_any(body), b[48 + n:]))


AUTH_COMM_CODE = (1, 1, 0, 1, 0, 1, 1, 1)
SECURE_COMM_CODE = (1, 1, 0, 1, 0, 1, 1, 0)


def auth_comm_bits(handle: np.ndarray, inner_bits: np.ndarray,
                   mac32: np.ndarray) -> np.ndarray:
    """AuthComm = 11010111 + Length(12) + inner command (cleartext, the
    full access-command frame incl. its own handle+CRC) + MAC(32) +
    handle(16) + CRC-16 (Gen2 v2 6.3.2.12.3.14 shape).

    The MAC is the TAM1-session CBC-MAC over the inner bits
    (protocol/crypto.py::session_mac): command *integrity* - a reader
    without the session key cannot forge e.g. a Write - while the data
    still travels in clear (use SecureComm for confidentiality)."""
    handle = np.asarray(handle, dtype=np.int64)
    inner = np.asarray(inner_bits, dtype=np.int64)
    mac = np.asarray(mac32, dtype=np.int64)
    assert handle.size == 16 and mac.size == 32
    bits = list(AUTH_COMM_CODE) + _len12(inner.size)
    body = np.concatenate([np.array(bits, dtype=np.int64), inner, mac,
                           handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_auth_comm(bits: np.ndarray):
    """-> (inner_bits, mac32, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == AUTH_COMM_CODE
    n = int("".join(map(str, b[8:20])), 2)
    inner = b[20: 20 + n]
    mac = b[20 + n: 52 + n]
    handle = b[52 + n: 68 + n]
    body = b[: 68 + n]
    return inner, mac, handle, bool(
        np.array_equal(_crc16_any(body), b[68 + n:]))


def secure_comm_bits(handle: np.ndarray,
                     enc_inner_bits: np.ndarray) -> np.ndarray:
    """SecureComm = 11010110 + Length(12) + encrypted inner command +
    handle(16) + CRC-16 (Gen2 v2 6.3.2.12.3.15 shape).

    The inner access-command frame is XOR'd with the TAM1-session CTR
    keystream (protocol/crypto.py::session_keystream, direction 0); the
    secret part of the reply comes back under the direction-1 keystream
    of the same exchange counter.  Both sides advance the counter per
    SecureComm exchange."""
    handle = np.asarray(handle, dtype=np.int64)
    enc = np.asarray(enc_inner_bits, dtype=np.int64)
    assert handle.size == 16
    bits = list(SECURE_COMM_CODE) + _len12(enc.size)
    body = np.concatenate([np.array(bits, dtype=np.int64), enc, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_secure_comm(bits: np.ndarray):
    """-> (enc_inner_bits, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == SECURE_COMM_CODE
    n = int("".join(map(str, b[8:20])), 2)
    enc = b[20: 20 + n]
    handle = b[20 + n: 36 + n]
    body = b[: 36 + n]
    return enc, handle, bool(
        np.array_equal(_crc16_any(body), b[36 + n:]))


KEYUPDATE_CODE = (1, 1, 1, 0, 0, 0, 1, 0)


def keyupdate_bits(handle: np.ndarray, key_id: int,
                   enc_key128: np.ndarray) -> np.ndarray:
    """KeyUpdate = 11100010 + RFU(2) + SenRep(1)=1 + IncRepLen(1)=0 +
    CSI(8) + Length(12) + Message + handle(16) + CRC-16 (Gen2 v2
    6.3.2.12.3.14 shape; crypto-suite payload per ISO 29167-10).

    Message = KeyID(8) + the new 128-bit key encrypted under the tag's
    *current* key for that KeyID (AES-128 ECB, one block) - the key never
    travels in clear.  Secured state required; the tag replies with the
    delayed Write-style success report only after installing the key."""
    handle = np.asarray(handle, dtype=np.int64)
    enc_key128 = np.asarray(enc_key128, dtype=np.int64)
    assert handle.size == 16 and enc_key128.size == 128
    assert 0 <= key_id < 256
    msg = np.concatenate([
        np.array([(key_id >> k) & 1 for k in range(7, -1, -1)],
                 dtype=np.int64), enc_key128])
    bits = list(KEYUPDATE_CODE) + [0, 0, 1, 0]
    bits += [0] * 8                               # CSI 0x00 = AES-128
    bits += _len12(msg.size)
    body = np.concatenate([np.array(bits, dtype=np.int64), msg, handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_keyupdate(bits: np.ndarray):
    """-> (csi, key_id, enc_key128, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == KEYUPDATE_CODE
    csi = int("".join(map(str, b[12:20])), 2)
    n = int("".join(map(str, b[20:32])), 2)
    key_id = int("".join(map(str, b[32:40])), 2)
    enc = b[40: 32 + n]
    handle = b[32 + n: 48 + n]
    body = b[: 48 + n]
    return csi, key_id, enc, handle, bool(
        np.array_equal(_crc16_any(body), b[48 + n:]))


def readbuffer_bits(handle: np.ndarray, bitptr: int = 0,
                    bitcount: int = 128) -> np.ndarray:
    """ReadBuffer = 11010010 + WordPtr(EBV-8, bit address / 16) +
    BitCount(8) + handle(16) + CRC-16 (Gen2 v2 6.3.2.12.3.12): fetch
    ``bitcount`` bits of the stored (Challenge-precomputed) response.
    Reply is Read-shaped: header-0 + bits + handle + CRC-16."""
    handle = np.asarray(handle, dtype=np.int64)
    assert handle.size == 16 and bitptr % 16 == 0 and 0 < bitcount < 256
    bits = list(READBUFFER_CODE)
    bits += [((bitptr // 16) >> k) & 1 for k in range(7, -1, -1)]  # EBV-8
    bits += [(bitcount >> k) & 1 for k in range(7, -1, -1)]
    body = np.concatenate([np.array(bits, dtype=np.int64), handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_readbuffer(bits: np.ndarray):
    """-> (bitptr, bitcount, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == READBUFFER_CODE
    bitptr = 16 * int("".join(map(str, b[8:16])), 2)
    bitcount = int("".join(map(str, b[16:24])), 2)
    handle = b[24:40]
    return bitptr, bitcount, handle, bool(
        np.array_equal(_crc16_any(b[:40]), b[40:]))


UNTRACEABLE_CODE = (1, 1, 1, 0, 0, 0, 0, 0)
UNTRACE_TID = {"none": (0, 0), "some": (0, 1), "all": (1, 0)}
UNTRACE_RANGE = {"normal": (0, 0), "toggle": (0, 1), "reduced": (1, 0)}


def untraceable_bits(handle: np.ndarray, u: int = 0,
                     epc_words: int = None, tid: str = "none",
                     hide_user: int = 0,
                     range_: str = "normal") -> np.ndarray:
    """Untraceable = 11100000 + RFU(2) + U(1) + Hide-EPC(1) + EPC-Len(5) +
    TID(2) + User(1) + Range(2) + handle(16) + CRC-16 (Gen2 v2
    6.3.2.12.3.13) - the privacy command: permanently (until re-issued
    from Secured) hides memory and/or reduces the tag's operating range.

    ``epc_words``: None = EPC exposure unchanged; N = tag thereafter
    backscatters only its first N EPC words (PC length field adjusted).
    ``tid``: "none" / "some" (allocation-class + designer ID words stay
    readable) / "all".  ``hide_user``: USER bank unreadable.  ``range_``:
    "reduced" = persistently reduced operating range ("toggle" not
    modeled).  Secured state required; delayed Write-style success reply.
    """
    handle = np.asarray(handle, dtype=np.int64)
    assert handle.size == 16
    hide_epc = int(epc_words is not None)
    n = 0 if epc_words is None else int(epc_words)
    assert 0 <= n < 32
    bits = list(UNTRACEABLE_CODE) + [0, 0, int(u), hide_epc]
    bits += [(n >> k) & 1 for k in range(4, -1, -1)]
    bits += list(UNTRACE_TID[tid]) + [int(hide_user)]
    bits += list(UNTRACE_RANGE[range_])
    body = np.concatenate([np.array(bits, dtype=np.int64), handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_untraceable(bits: np.ndarray):
    """-> (u, epc_words | None, tid, hide_user, range_, handle, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:8]) == UNTRACEABLE_CODE
    u = int(b[10])
    epc_words = (int("".join(map(str, b[12:17])), 2) if b[11] else None)
    tid = {v: k for k, v in UNTRACE_TID.items()}[(int(b[17]), int(b[18]))]
    hide_user = int(b[19])
    range_ = {v: k for k, v in UNTRACE_RANGE.items()}[
        (int(b[20]), int(b[21]))]
    handle = b[22:38]
    crc_ok = bool(np.array_equal(_crc16_any(b[:38]), b[38:]))
    return u, epc_words, tid, hide_user, range_, handle, crc_ok


# Tag error-specific replies (Gen2 Annex I / v2 table I-2): when a
# handle-addressed access command fails, the tag backscatters header-1 +
# ErrorCode(8) + handle + CRC-16 instead of its success reply (password
# failures excepted - a wrong Access/Kill half is silence by spec).  The
# reference never leaves inventory so it has no analogue; commercial
# readers surface these as LLRP access-op result codes.
ERROR_CODES = {
    "other": 0b00000000,
    "not supported": 0b00000001,
    "insufficient privileges": 0b00000010,
    "memory overrun": 0b00000011,
    "memory locked": 0b00000100,
    "crypto suite": 0b00000101,
    "not encapsulated": 0b00000110,
    "buffer overflow": 0b00000111,
    "security timeout": 0b00001000,
    "insufficient power": 0b00001011,
    "non-specific": 0b00001111,
}
_ERROR_NAMES = {v: k for k, v in ERROR_CODES.items()}
ERROR_REPLY_BITS = 1 + 8 + 16 + 16


def error_reply_bits(error: str, handle: np.ndarray) -> np.ndarray:
    """Tag error reply: header-1 + ErrorCode(8) + handle(16) + CRC-16
    over header+code+handle (Gen2 Annex I)."""
    code = ERROR_CODES[error]
    handle = np.asarray(handle, dtype=np.int64)
    body = np.concatenate([
        np.ones(1, np.int64),
        np.array([(code >> k) & 1 for k in range(7, -1, -1)], np.int64),
        handle])
    return np.concatenate([body, _crc16_any(body)])


def parse_error_reply(bits: np.ndarray):
    """-> (error_name, handle, ok) - ok iff header-1 + CRC-16 verify and
    the code is a known Annex-I value."""
    b = np.asarray(bits, dtype=np.int64)
    if b.size < ERROR_REPLY_BITS or b[0] != 1:
        return None, None, False
    b = b[:ERROR_REPLY_BITS]
    code = int("".join(map(str, b[1:9])), 2)
    handle = b[9:25]
    ok = (code in _ERROR_NAMES
          and bool(np.array_equal(_crc16_any(b[:25]), b[25:])))
    return _ERROR_NAMES.get(code), handle, ok


def pwd_halves(pwd32: int):
    """A 32-bit password as (MSB half bits, LSB half bits) - the order the
    two Access / Kill steps transmit them (Gen2 6.3.2.12.3.4/6)."""
    hi = np.array([(pwd32 >> k) & 1 for k in range(31, 15, -1)], np.int64)
    lo = np.array([(pwd32 >> k) & 1 for k in range(15, -1, -1)], np.int64)
    return hi, lo


# Select command (EPC Gen2 6.3.2.12.1.1) - a mandatory Gen2 command the
# reference does not implement (its reader FSM knows only Query/QueryRep/
# QueryAdjust/ACK/NAK, reader_impl.cc:200-380).  New capability: mask-based
# sub-population selection, paired with Query's Sel field.
SELECT_CODE = (1, 0, 1, 0)
SELECT_TARGET_SL = (1, 0, 0)      # modify the SL flag
# Targets 000-011: the inventoried flag of session S0-S3 (Gen2 table 6.28).
SELECT_TARGET_S = {0: (0, 0, 0), 1: (0, 0, 1), 2: (0, 1, 0), 3: (0, 1, 1)}
MEMBANK_EPC = (0, 1)

# Select action table (Gen2 table 6.29): per action, what matching /
# non-matching tags do to the targeted flag.  "assert" = SL asserted or
# inventoried -> A; "deassert" = SL deasserted or inventoried -> B.
SELECT_ACTIONS = {
    0: ("assert", "deassert"),
    1: ("assert", "none"),
    2: ("none", "deassert"),
    3: ("negate", "none"),
    4: ("deassert", "assert"),
    5: ("deassert", "none"),
    6: ("none", "assert"),
    7: ("none", "negate"),
}


def select_bits(mask: np.ndarray, pointer: int = 0x20,
                membank=MEMBANK_EPC, target=SELECT_TARGET_SL,
                action: int = 0, truncate: int = 0) -> np.ndarray:
    """Select = 1010 + Target(3) + Action(3) + MemBank(2) + Pointer(EBV-8)
    + Length(8) + Mask + Truncate + CRC-16.

    ``pointer`` is a bit address into the membank (single-byte EBV,
    pointer < 128; 0x20 = start of the EPC field in the EPC bank);
    ``action`` 0 = matching tags assert SL / nonmatching deassert.
    """
    mask = np.asarray(mask, dtype=np.int64)
    assert 0 <= pointer < 128, "single-byte EBV pointer"
    assert mask.size < 256
    bits = list(SELECT_CODE) + list(target)
    bits += [(action >> k) & 1 for k in (2, 1, 0)]
    bits += list(membank)
    bits += [(pointer >> k) & 1 for k in range(7, -1, -1)]   # EBV-8
    bits += [(mask.size >> k) & 1 for k in range(7, -1, -1)]
    bits += [int(b) for b in mask]
    bits.append(truncate)
    body = np.array(bits, dtype=np.int64)
    # CRC-16 over the whole command (Gen2 Select is CRC-16-protected; the
    # byte-wise oracle needs whole bytes, so pad-left semantics are avoided
    # by using the bit-serial LFSR form directly).
    return np.concatenate([body, _crc16_any(body)])


def _crc16_any(bits: np.ndarray) -> np.ndarray:
    """CRC-16/CCITT over an arbitrary-length bit string (the byte-packed
    oracle in protocol.crc requires whole bytes; Select commands are not
    byte-aligned)."""
    crc = 0xFFFF
    for b in np.asarray(bits, dtype=np.int64):
        fb = ((crc >> 15) & 1) ^ int(b)
        crc = ((crc << 1) & 0xFFFF) ^ (0x1021 if fb else 0)
    crc ^= 0xFFFF
    return np.array([(crc >> k) & 1 for k in range(15, -1, -1)],
                    dtype=np.int64)


def parse_select(bits: np.ndarray):
    """Decode a Select command -> (target, action, membank, pointer,
    mask, truncate, crc_ok)."""
    b = np.asarray(bits, dtype=np.int64)
    assert tuple(b[:4]) == SELECT_CODE
    target = tuple(int(x) for x in b[4:7])
    action = int(b[7] * 4 + b[8] * 2 + b[9])
    membank = (int(b[10]), int(b[11]))
    pointer = int("".join(map(str, b[12:20])), 2)
    length = int("".join(map(str, b[20:28])), 2)
    mask = b[28:28 + length]
    truncate = int(b[28 + length])
    body = b[: 29 + length]
    crc_ok = bool(np.array_equal(_crc16_any(body), b[29 + length:]))
    return target, action, membank, pointer, mask, truncate, crc_ok


def parse_epc_frame(bits: np.ndarray):
    """Parse a decoded EPC reply payload by its PC length field.

    Gen2 6.3.2.1.2.2: PC bits 0-4 give the backscattered payload length L
    in 16-bit words (XPC word included when the XI bit announces one,
    Gen2 v2 6.3.2.1.2.4), so the frame is PC16 + 16L payload + CRC16.
    The reference hard-pins L=6 (EPC_BITS=129, global_vars.h:107) and
    reads the id at bits[104:112] (tag_decoder_impl.cc:348-352); this
    generalizes both.  ``bits`` may be longer than the frame (the decoder
    slices the maximum window) - the trailing bits are ignored.

    Returns (crc_ok, payload_words, tag_id) with tag_id = the last EPC
    byte (-1 when the frame cannot be validated).
    """
    b = np.asarray(bits, dtype=np.int64)
    l = int("".join(map(str, b[:5])), 2)
    dl = 16 + 16 * l
    if dl + 16 > b.size:
        return False, l, -1
    ok = bool(np.array_equal(_crc16_any(b[:dl]), b[dl: dl + 16]))
    tid = int("".join(map(str, b[dl - 8: dl])), 2)
    return ok, l, tid


def parse_epc_frame_full(bits: np.ndarray):
    """Full EPC-frame parse incl. the Gen2 v2 XPC word.

    Returns a dict: ``ok``, ``tag_id``, ``epc`` (the EPC bits proper,
    XPC excluded), ``xi`` (XPC word present, PC bit 16h), ``u`` (the
    Untraceable flag riding XPC_W1), ``umi`` (PC bit 15h).
    """
    b = np.asarray(bits, dtype=np.int64)
    ok, l, tid = parse_epc_frame(b)
    xi = bool(b[6])
    umi = bool(b[5])
    off = 16 + (16 if xi else 0)
    u = bool(xi and b[17] == 1)          # modeled XPC_W1 bit 1 = U
    epc = b[off: 16 + 16 * l] if ok else np.zeros(0, np.int64)
    return {"ok": ok, "tag_id": tid, "epc": epc, "xi": xi, "u": u,
            "umi": umi}
