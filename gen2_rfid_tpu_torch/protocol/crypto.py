"""AES-128 crypto suite for Gen2 v2 tag authentication (ISO/IEC 29167-10).

The reference reader predates EPC Gen2 v2 and has no security layer at all
(its command set stops at Query/QueryRep/QueryAdjust/ACK/NAK,
``reader_impl.cc:200-380``).  Gen2 v2 adds cryptographic tag authentication:
the reader issues a Challenge/Authenticate carrying a crypto-suite message,
and the tag proves key possession by returning a cryptographic response.
Crypto suite 0x00 is ISO/IEC 29167-10 AES-128; its TAM1 (Tag Authentication
Method 1) exchange is the shape implemented here:

* reader draws a 96-bit random challenge ``IChallenge``;
* the tag forms the 128-bit block ``IChallenge || TRnd32`` (TRnd32 = a
  fresh tag-generated 32-bit random) and replies with its AES-128
  encryption under the selected key;
* the reader decrypts and verifies the embedded challenge - a wrong key or
  a replayed response fails the comparison.

AES-128 itself follows FIPS-197 exactly (verified against the appendix-C
known-answer vector in ``tests/test_auth.py``).  Everything is plain
NumPy/Python: authentication is protocol-plane work at a few dozen blocks
per inventory, nowhere near the TPU signal path, so it stays host-side like
the rest of the command synthesis (``protocol/gen2.py``).

The S-box is *computed* from its definition (multiplicative inverse in
GF(2^8) mod the AES polynomial, then the affine transform) rather than
pasted as a table, and the round constants from repeated xtime - both
self-checked once at import against their defining identities.
"""

from __future__ import annotations

import numpy as np

# ---- GF(2^8) arithmetic (AES polynomial x^8+x^4+x^3+x+1 = 0x11B) ----------


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


def _build_sbox():
    # Multiplicative inverse table by brute force (256*255 tiny ops, once).
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            if _gmul(a, b) == 1:
                inv[a] = b
                break
    sbox = [0] * 256
    for a in range(256):
        x = inv[a]
        # Affine transform: b_i = x_i ^ x_{i+4} ^ x_{i+5} ^ x_{i+6} ^
        # x_{i+7} ^ c_i with c = 0x63 (FIPS-197 5.1.1).
        y = 0
        for i in range(8):
            bit = ((x >> i) ^ (x >> ((i + 4) % 8)) ^ (x >> ((i + 5) % 8))
                   ^ (x >> ((i + 6) % 8)) ^ (x >> ((i + 7) % 8))
                   ^ (0x63 >> i)) & 1
            y |= bit << i
        sbox[a] = y
    return sbox


_SBOX = _build_sbox()
_INV_SBOX = [0] * 256
for _i, _v in enumerate(_SBOX):
    _INV_SBOX[_v] = _i
# Defining identities: S(0)=0x63, S(0x53)=0xED (FIPS-197 figure 7).
assert _SBOX[0x00] == 0x63 and _SBOX[0x53] == 0xED
_RCON = [1]
for _ in range(9):
    _RCON.append(_xtime(_RCON[-1]))
assert _RCON[8] == 0x1B and _RCON[9] == 0x36


def _expand_key(key: bytes):
    """176-byte AES-128 key schedule (FIPS-197 5.2) as 11 round keys."""
    assert len(key) == 16
    w = [list(key[4 * i: 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]                       # RotWord
            t = [_SBOX[b] for b in t]               # SubWord
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [bytes(sum(w[4 * r: 4 * r + 4], [])) for r in range(11)]


def _state(block: bytes) -> np.ndarray:
    """Column-major 4x4 state (FIPS-197 3.4): state[r, c] = in[r + 4c]."""
    return np.frombuffer(block, dtype=np.uint8).reshape(4, 4).T.copy()


def _unstate(st: np.ndarray) -> bytes:
    return bytes(st.T.reshape(-1))


def _mix_single(col, mat):
    return [(_gmul(int(col[0]), mat[r][0]) ^ _gmul(int(col[1]), mat[r][1])
             ^ _gmul(int(col[2]), mat[r][2]) ^ _gmul(int(col[3]), mat[r][3]))
            for r in range(4)]


_MIX = [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]]
_INV_MIX = [[14, 11, 13, 9], [9, 14, 11, 13], [13, 9, 14, 11],
            [11, 13, 9, 14]]


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One-block AES-128 ECB encryption (FIPS-197 5.1)."""
    rk = _expand_key(key)
    st = _state(block) ^ _state(rk[0])
    for rnd in range(1, 11):
        st = np.array([[_SBOX[b] for b in row] for row in st], np.uint8)
        st = np.array([np.roll(st[r], -r) for r in range(4)], np.uint8)
        if rnd < 10:
            st = np.array(
                [_mix_single(st[:, c], _MIX) for c in range(4)],
                np.uint8).T
        st ^= _state(rk[rnd])
    return _unstate(st)


def aes128_decrypt_block(key: bytes, block: bytes) -> bytes:
    """One-block AES-128 ECB decryption (FIPS-197 5.3)."""
    rk = _expand_key(key)
    st = _state(block) ^ _state(rk[10])
    for rnd in range(9, -1, -1):
        st = np.array([np.roll(st[r], r) for r in range(4)], np.uint8)
        st = np.array([[_INV_SBOX[b] for b in row] for row in st], np.uint8)
        st ^= _state(rk[rnd])
        if rnd > 0:
            st = np.array(
                [_mix_single(st[:, c], _INV_MIX) for c in range(4)],
                np.uint8).T
    return _unstate(st)


# ---- bit <-> byte helpers (air-interface payloads are MSB-first bits) -----


def bits_to_bytes(bits: np.ndarray) -> bytes:
    b = np.asarray(bits, dtype=np.int64)
    assert b.size % 8 == 0
    return bytes(int("".join(map(str, b[8 * i: 8 * i + 8])), 2)
                 for i in range(b.size // 8))


def bytes_to_bits(data: bytes) -> np.ndarray:
    out = np.zeros(8 * len(data), dtype=np.int64)
    for i, byte in enumerate(data):
        for k in range(8):
            out[8 * i + k] = (byte >> (7 - k)) & 1
    return out


def key_bits(key128: int) -> np.ndarray:
    """A 128-bit key as MSB-first bits (KeyUpdate / tag key storage)."""
    return np.array([(key128 >> k) & 1 for k in range(127, -1, -1)],
                    dtype=np.int64)


# ---- PRESENT-80 (ISO/IEC 29167-11 crypto suite) ----------------------------
# The ultralightweight block cipher tags with tiny gate budgets run
# (Bogdanov et al., CHES 2007): 64-bit block, 80-bit key, 31 rounds of
# addRoundKey -> 4-bit S-box layer -> bit permutation, plus a final key
# whitening.  Known-answer vectors from the paper's appendix are pinned in
# tests/test_present.py.

_PRESENT_SBOX = (0xC, 0x5, 0x6, 0xB, 0x9, 0x0, 0xA, 0xD,
                 0x3, 0xE, 0xF, 0x8, 0x4, 0x7, 0x1, 0x2)
_PRESENT_SBOX_INV = tuple(_PRESENT_SBOX.index(i) for i in range(16))
_MASK64 = (1 << 64) - 1
_MASK80 = (1 << 80) - 1
# pLayer: bit i of the state moves to position i*16 mod 63 (bit 63 fixed).
_PRESENT_P = tuple(63 if i == 63 else (i * 16) % 63 for i in range(64))
_PRESENT_P_INV = tuple(_PRESENT_P.index(i) for i in range(64))


def _present_round_keys(key: bytes):
    """K_1..K_32 from the 80-bit key register (rotate-61, S-box on the
    top nibble, round counter into bits 19..15)."""
    assert len(key) == 10, "PRESENT-80 key is 10 bytes"
    k = int.from_bytes(key, "big")
    rks = []
    for i in range(1, 33):
        rks.append(k >> 16)
        if i == 32:
            break
        k = ((k << 61) | (k >> 19)) & _MASK80
        k = (k & ~(0xF << 76)) | (_PRESENT_SBOX[(k >> 76) & 0xF] << 76)
        k ^= i << 15
    return rks


def _present_sbox_layer(state: int, box) -> int:
    out = 0
    for j in range(16):
        out |= box[(state >> (4 * j)) & 0xF] << (4 * j)
    return out


def _present_permute(state: int, table) -> int:
    out = 0
    for b in range(64):
        out |= ((state >> b) & 1) << table[b]
    return out


def present80_encrypt_block(key: bytes, block: bytes) -> bytes:
    assert len(block) == 8
    state = int.from_bytes(block, "big")
    rks = _present_round_keys(key)
    for i in range(31):
        state ^= rks[i]
        state = _present_sbox_layer(state, _PRESENT_SBOX)
        state = _present_permute(state, _PRESENT_P)
    return ((state ^ rks[31]) & _MASK64).to_bytes(8, "big")


def present80_decrypt_block(key: bytes, block: bytes) -> bytes:
    assert len(block) == 8
    state = int.from_bytes(block, "big") ^ _present_round_keys(key)[31]
    rks = _present_round_keys(key)
    for i in range(30, -1, -1):
        state = _present_permute(state, _PRESENT_P_INV)
        state = _present_sbox_layer(state, _PRESENT_SBOX_INV)
        state ^= rks[i]
    return (state & _MASK64).to_bytes(8, "big")


# ---- TAM1 (ISO/IEC 29167-10 Tag Authentication Method 1) ------------------

CSI_AES128 = 0x00            # crypto suite indicator: ISO 29167-10 AES-128
CSI_PRESENT80 = 0x01         # ISO 29167-11 PRESENT-80 (numbering mirrors
#                              the ISO part order, framework-local)
TAM1_CHALLENGE_BITS = 96
TAM1_RESPONSE_BITS = 128
# PRESENT-80's 64-bit block splits as IChallenge(48) || TRnd(16).
PRESENT_TAM1_CHALLENGE_BITS = 48
PRESENT_TAM1_RESPONSE_BITS = 64


def suite_for_key(key: bytes) -> int:
    """Crypto suite implied by a key's length (16 -> AES-128,
    10 -> PRESENT-80) — how the reader CLI/API selects the CSI."""
    if len(key) == 16:
        return CSI_AES128
    if len(key) == 10:
        return CSI_PRESENT80
    raise ValueError(f"no suite with a {len(key)}-byte key")


def tam1_params(csi: int):
    """(challenge bits, response bits, TRnd bits) per suite."""
    if csi == CSI_AES128:
        return TAM1_CHALLENGE_BITS, TAM1_RESPONSE_BITS, 32
    assert csi == CSI_PRESENT80
    return (PRESENT_TAM1_CHALLENGE_BITS, PRESENT_TAM1_RESPONSE_BITS, 16)


def tam1_message(key_id: int, challenge: np.ndarray) -> np.ndarray:
    """The Authenticate/Challenge Message field for TAM1.

    Layout (ISO 29167-10/-11 TAM1 shape): AuthMethod(2)=00, Custom(1)=0,
    RFU(5)=0, KeyID(8), IChallenge — 96-bit challenge for the AES-128
    suite (112 bits total), 48-bit for PRESENT-80 (64 bits total); the
    challenge size IS the suite discriminator in the message.
    """
    c = np.asarray(challenge, dtype=np.int64)
    assert c.size in (TAM1_CHALLENGE_BITS,
                      PRESENT_TAM1_CHALLENGE_BITS) and 0 <= key_id < 256
    head = [0, 0, 0] + [0] * 5
    head += [(key_id >> k) & 1 for k in range(7, -1, -1)]
    return np.concatenate([np.array(head, dtype=np.int64), c])


def parse_tam1_message(msg: np.ndarray):
    """-> (key_id, challenge) or None when not a TAM1 message.  The
    challenge is 96 bits (AES-128) or 48 bits (PRESENT-80) by message
    size."""
    m = np.asarray(msg, dtype=np.int64)
    if m.size not in (112, 64) or np.any(m[:8] != 0):
        return None
    key_id = int("".join(map(str, m[8:16])), 2)
    return key_id, m[16:]


def tam1_response(key: bytes, challenge: np.ndarray,
                  trnd: np.ndarray) -> np.ndarray:
    """Tag side: encrypt the block IChallenge || TRnd under the suite the
    key length implies (AES-128: 96+32 bits; PRESENT-80: 48+16)."""
    c = np.asarray(challenge, dtype=np.int64)
    t = np.asarray(trnd, dtype=np.int64)
    block = bits_to_bytes(np.concatenate([c, t]))
    if suite_for_key(key) == CSI_AES128:
        assert c.size == 96 and t.size == 32
        return bytes_to_bits(aes128_encrypt_block(key, block))
    assert c.size == 48 and t.size == 16
    return bytes_to_bits(present80_encrypt_block(key, block))


def tam1_verify(key: bytes, challenge: np.ndarray,
                response: np.ndarray):
    """Reader side: decrypt and compare the embedded challenge.

    Returns ``(ok, trnd)``: ``ok`` iff the leading plaintext bits equal
    the challenge the reader transmitted (proof the tag holds ``key``);
    ``trnd`` is the tag's random filler (useful as a session salt).
    Suite by key length, block/challenge widths per ``tam1_params``.
    """
    cb, rb, _ = tam1_params(suite_for_key(key))
    r = np.asarray(response, dtype=np.int64)
    assert r.size == rb
    if suite_for_key(key) == CSI_AES128:
        plain = bytes_to_bits(aes128_decrypt_block(key, bits_to_bytes(r)))
    else:
        plain = bytes_to_bits(
            present80_decrypt_block(key, bits_to_bytes(r)))
    ok = bool(np.array_equal(plain[:cb],
                             np.asarray(challenge, dtype=np.int64)))
    return ok, plain[cb:]


# ---- TAM2 (authenticated *confidential* memory read) -----------------------
# ISO 29167-10's second method: the tag proves key possession AND returns
# memory encrypted in the same response, so the data never travels in
# clear.  Modeled construction: block 0 = AES_K(IChallenge || TRnd32)
# (identical to TAM1 - the authentication part), then the requested memory
# in 128-bit blocks under CBC with block 0 as the IV:
# c_i = AES_K(p_i XOR c_{i-1}).  The tag-random IV makes every read of the
# same words produce a different ciphertext (replay/traffic analysis
# resistance); the reader decrypts sequentially after verifying the
# challenge.

TAM2_BLOCK_BITS = 128


def tam2_message(key_id: int, challenge96: np.ndarray, membank,
                 wordptr: int, n_blocks: int) -> np.ndarray:
    """Authenticate Message field for TAM2: AuthMethod(2)=01, Custom(1)=0,
    RFU(5)=0, KeyID(8), IChallenge(96), MemBank(2), WordPtr(EBV-8),
    BlockCount(4) - each block is 128 bits = 8 words of tag memory."""
    c = np.asarray(challenge96, dtype=np.int64)
    assert c.size == TAM1_CHALLENGE_BITS and 0 <= key_id < 256
    assert 0 <= wordptr < 256 and 0 < n_blocks < 16
    head = [0, 1, 0] + [0] * 5
    head += [(key_id >> k) & 1 for k in range(7, -1, -1)]
    tail = list(membank)
    tail += [(wordptr >> k) & 1 for k in range(7, -1, -1)]
    tail += [(n_blocks >> k) & 1 for k in range(3, -1, -1)]
    return np.concatenate([np.array(head, dtype=np.int64), c,
                           np.array(tail, dtype=np.int64)])


def parse_tam2_message(msg: np.ndarray):
    """-> (key_id, challenge96, membank, wordptr, n_blocks) or None."""
    m = np.asarray(msg, dtype=np.int64)
    if m.size != 126 or m[0] != 0 or m[1] != 1 or np.any(m[2:8] != 0):
        return None
    key_id = int("".join(map(str, m[8:16])), 2)
    membank = (int(m[112]), int(m[113]))
    wordptr = int("".join(map(str, m[114:122])), 2)
    n_blocks = int("".join(map(str, m[122:126])), 2)
    return key_id, m[16:112], membank, wordptr, n_blocks


def tam2_response(key: bytes, challenge96: np.ndarray, trnd32: np.ndarray,
                  data_bits: np.ndarray) -> np.ndarray:
    """Tag side: auth block + CBC-encrypted memory (IV = auth block)."""
    data = np.asarray(data_bits, dtype=np.int64)
    assert data.size % TAM2_BLOCK_BITS == 0
    out = [tam1_response(key, challenge96, trnd32)]
    prev = bits_to_bytes(out[0])
    for i in range(data.size // TAM2_BLOCK_BITS):
        p = bits_to_bytes(data[128 * i: 128 * i + 128])
        c = aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(p, prev)))
        out.append(bytes_to_bits(c))
        prev = c
    return np.concatenate(out)


def tam2_verify(key: bytes, challenge96: np.ndarray, response: np.ndarray):
    """Reader side: verify the auth block, then CBC-decrypt the memory.

    Returns ``(ok, data_bits)`` - data is empty unless ``ok``.
    """
    r = np.asarray(response, dtype=np.int64)
    assert r.size % TAM2_BLOCK_BITS == 0 and r.size >= TAM2_BLOCK_BITS
    ok, _ = tam1_verify(key, challenge96, r[:128])
    if not ok:
        return False, np.zeros(0, dtype=np.int64)
    data = []
    prev = bits_to_bytes(r[:128])
    for i in range(1, r.size // TAM2_BLOCK_BITS):
        c = bits_to_bytes(r[128 * i: 128 * i + 128])
        p = aes128_decrypt_block(key, c)
        data.append(bytes_to_bits(bytes(a ^ b for a, b in zip(p, prev))))
        prev = c
    return True, np.concatenate(data)


# ---- AuthComm / SecureComm session crypto (Gen2 v2 6.3.2.12.3.14-15) ------
# Gen2 v2 defines two "in-process" encapsulation commands that carry an
# ordinary access command inside a cryptographically protected envelope:
# AuthComm authenticates the inner command (cleartext + MAC, so a rogue
# reader cannot forge e.g. a Write), SecureComm additionally encrypts the
# inner command and the secret part of the reply (confidentiality).  The
# session secret is what a successful TAM1 exchange leaves on both sides:
# (key, IChallenge, TRnd32) - the reader learns TRnd from the decrypted
# response (tam1_verify), the tag generated it.
#
# Modeled session construction (the spec delegates the actual cipher
# modes to the ISO 29167 crypto suite):
#   block(n)       = AES_K(IChallenge || (TRnd XOR n)),  n != 0, so no
#                    session block ever collides with the TAM1 response
#                    itself (the n = 0 case);
#   keystream      = block(n), n = dir<<31 | ctr+1   (CTR mode; dir 0 =
#                    reader->tag, 1 = tag->reader; ctr counts SecureComm
#                    exchanges within the session on both sides);
#   MAC(bits)      = first 32 bits of CBC-MAC under K with IV =
#                    block(dir<<31 | 1<<30 | ctr+1) over the 10*-padded
#                    message (the 1<<30 bit separates the MAC domain from
#                    the keystream domain).


def _session_block(key: bytes, challenge96: np.ndarray, trnd32: np.ndarray,
                   n: int) -> bytes:
    c = np.asarray(challenge96, dtype=np.int64)
    t = np.asarray(trnd32, dtype=np.int64).copy()
    assert c.size == 96 and t.size == 32 and n != 0
    for k in range(32):
        t[k] ^= (n >> (31 - k)) & 1
    return aes128_encrypt_block(key, bits_to_bytes(np.concatenate([c, t])))


def session_keystream(key: bytes, challenge96: np.ndarray,
                      trnd32: np.ndarray, ctr: int, n_bits: int,
                      direction: int = 0) -> np.ndarray:
    """``n_bits`` of session keystream for SecureComm exchange ``ctr``."""
    out = []
    i = 0
    while 128 * len(out) < n_bits:
        n = (direction << 31) | ((ctr + 1 + i) & 0x3FFFFFFF)
        out.append(bytes_to_bits(
            _session_block(key, challenge96, trnd32, n)))
        i += 1
    return np.concatenate(out)[:n_bits]


def session_mac(key: bytes, challenge96: np.ndarray, trnd32: np.ndarray,
                bits: np.ndarray, ctr: int = 0, direction: int = 0,
                n_mac: int = 32) -> np.ndarray:
    """Truncated CBC-MAC over ``bits`` under the session (AuthComm)."""
    b = np.asarray(bits, dtype=np.int64)
    pad = (-(b.size + 1)) % 128
    msg = np.concatenate([b, np.ones(1, np.int64),
                          np.zeros(pad, np.int64)])
    n = (direction << 31) | (1 << 30) | ((ctr + 1) & 0x3FFFFFFF)
    prev = _session_block(key, challenge96, trnd32, n)
    for i in range(msg.size // 128):
        p = bits_to_bytes(msg[128 * i: 128 * i + 128])
        prev = aes128_encrypt_block(
            key, bytes(a ^ x for a, x in zip(p, prev)))
    return bytes_to_bits(prev)[:n_mac]
