"""Behavioral Gen2 tag model: FM0 / Miller backscatter chip synthesis.

The reference has no simulator (its golden trace is a real USRP capture,
``README.md:43-53``, and the blob is missing in this mount) - this module is
the from-scratch replacement.  It produces the half-bit ("chip") sequence a
tag backscatters for RN16 and EPC replies, consistent with what the decoder
demodulates (``tag_decoder_impl.cc:78-193``):

* preamble chips {1,1,0,1,0,0,1,0,0,0,1,1} (global_vars.h:136),
* FM0 baseband: inversion at every bit boundary, data-0 adds a mid-bit
  inversion; chips are backscatter states in {0,1},
* a dummy data-1 terminates each reply (RN16_BITS=17, EPC_BITS=129 include
  the dummy, global_vars.h:106-107),
* Miller-M: subcarrier with M half-cycles per half-bit and phase inversions
  per the Gen2 spec (new capability, config ``miller_m`` > 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import TAG_PREAMBLE_BITS_PATTERN, ReaderConfig
from ..protocol.crc import crc16_bits

PREAMBLE_CHIPS = np.array(TAG_PREAMBLE_BITS_PATTERN, dtype=np.int64)
C_LIGHT = 299_792_458.0


def fm0_chips(bits: np.ndarray, add_dummy: bool = True,
              trext: int = 0, pilot_bits: int = 12) -> np.ndarray:
    """[Pilot +] preamble + FM0 half-bit chips (0/1 backscatter states).

    Level continuity starts from the last preamble chip (1).  For each bit:
    first half inverts the previous level; data-1 holds it through the bit,
    data-0 inverts again mid-bit.  This is exactly the signal the reference
    decoder inverts: its per-bit statistic is the sign of
    (second-half(j) - first-half(j+1)) * conj(h_est), which equals the level
    of second-half(j) because of the guaranteed boundary inversion.

    TRext=1 prepends the pilot tone: zero bits, i.e. (1,0) chip pairs whose
    final low chip transitions into the preamble's leading high chip.
    """
    bits = np.asarray(bits, dtype=np.int64)
    if add_dummy:
        bits = np.concatenate([bits, np.array([1], dtype=np.int64)])
    chips = np.empty(2 * bits.size, dtype=np.int64)
    prev = int(PREAMBLE_CHIPS[-1])
    for i, b in enumerate(bits):
        first = 1 - prev
        second = first if b == 1 else 1 - first
        chips[2 * i] = first
        chips[2 * i + 1] = second
        prev = second
    pilot = (np.tile([1, 0], pilot_bits) if trext
             else np.zeros(0, dtype=np.int64))
    return np.concatenate([pilot, PREAMBLE_CHIPS, chips])


def miller_chips(bits: np.ndarray, m: int, add_dummy: bool = True,
                 trext: int = 0) -> np.ndarray:
    """Miller-M basis-band chips at the subcarrier half-cycle granularity.

    Miller baseband: phase inversion mid-bit for data-1; inversion at the
    boundary between two data-0s.  The M-subcarrier multiplies the baseband
    by a square wave with M cycles per bit.  Output chips are in {0,1} at
    2*M chips per bit; the preamble is the Gen2 Miller preamble
    (4 data-0-like spin-up bits then 010111).
    """
    assert m in (2, 4, 8)
    bits = np.asarray(bits, dtype=np.int64)
    if add_dummy:
        bits = np.concatenate([bits, np.array([1], dtype=np.int64)])
    # Gen2 Miller preamble data pattern: 4 (TRext=0) or 16 (TRext=1) data-0
    # spin-up symbols then 010111.
    n_spin = 16 if trext else 4
    pre_bits = np.array([0] * n_spin + [0, 1, 0, 1, 1, 1], dtype=np.int64)
    seq = np.concatenate([pre_bits, bits])
    # Baseband phase per bit (+1/-1), with Miller inversion rules.
    phase = np.empty(seq.size, dtype=np.int64)
    cur = 1
    prev_bit = 1
    for i, b in enumerate(seq):
        if i > 0 and b == 0 and prev_bit == 0:
            cur = -cur            # boundary inversion between consecutive 0s
        phase[i] = cur
        if b == 1:
            cur = -cur            # mid-bit inversion for data-1 ends the bit flipped
        prev_bit = b
    # Subcarrier: M cycles per bit = 2M half-cycles alternating +1/-1.
    sub = np.tile(np.array([1, -1], dtype=np.int64), m)
    chips_pm = (phase[:, None] * sub[None, :]).reshape(-1)
    # data-1 mid-bit inversion: flip the second half of each data-1 bit.
    half = m  # half-bit = m half-cycles
    chips_pm = chips_pm.reshape(seq.size, 2 * m)
    ones = seq == 1
    chips_pm[ones, half:] *= -1
    return ((chips_pm.reshape(-1) + 1) // 2).astype(np.int64)


@dataclasses.dataclass
class Tag:
    """One simulated tag: identity + per-round RN16 behavior + RF impairments.

    The reference's golden trace is a real capture, so its decoder had to
    cope with real impairments - notably tag BLF error (Gen2 allows several
    percent of link-frequency tolerance, the reason the reference
    re-estimates the symbol period per EPC frame,
    tag_decoder_impl.cc:151-169).  These fields synthesize them:

    * ``blf_offset``: fractional backscatter-link-frequency error; +0.01
      means the tag clocks 1% fast (chips 1% short).
    * ``cfo_hz``: residual carrier offset applied to the backscatter
      component (zero in a shared-LO monostatic reader; nonzero models
      bistatic LO offset / phase noise), rotating the reply's phase over
      the frame.
    * ``amp_ramp``: fractional amplitude change across one reply
      (settling/motion), e.g. 0.2 ends 20% stronger than it starts.
    * ``distance_m`` / ``velocity_mps``: tag geometry for the localization
      observables (runtime/ranging.py).  When ``distance_m`` is set, the
      round-trip propagation phase -4*pi*f*d(t)/c at the carrier rotates
      the backscatter coefficient per reply (d(t) = distance + v*t over the
      capture) - the physics behind commercial readers' per-read phase
      reports.  None (default) keeps the legacy fixed-phase behavior.
    """

    epc96: np.ndarray                       # 96 EPC bits
    pc16: Optional[np.ndarray] = None       # 16 PC bits (default standard 96-bit PC)
    backscatter: complex = 0.08 + 0.03j     # complex backscatter amplitude
    seed: int = 0
    blf_offset: float = 0.0
    cfo_hz: float = 0.0
    amp_ramp: float = 0.0
    distance_m: Optional[float] = None      # range for PDOA/Doppler phase
    velocity_mps: float = 0.0               # radial velocity (+ = receding)
    user_bank: Optional[np.ndarray] = None  # USER memory (default 8 words)
    # Security state (Gen2 6.3.2.1 RESERVED bank + 6.3.2.10 lock bits).
    kill_pwd: int = 0                       # 32-bit; 0 = kill disabled
    access_pwd: int = 0                     # 32-bit; 0 = Secured on Req_RN
    lock_state: Optional[np.ndarray] = None  # 10 bits, (lock, permalock) per
    #                                          LOCK_FIELDS field
    killed: bool = False                    # a killed tag never responds
    # Per-word USER-bank permalock bits (BlockPermalock, Gen2 6.3.2.12.3.9;
    # block granularity modeled as one 16-bit word).
    user_permalock: Optional[np.ndarray] = None
    # Gen2 v2 authentication keys: key_id -> 16-byte AES-128 key (ISO
    # 29167-10 crypto suite).  None/absent key_id = suite unsupported; the
    # tag stays silent on Authenticate (Gen2 v2 error behavior for an
    # unsupported CSI is modeled as no reply).
    aes_keys: Optional[dict] = None
    # Gen2 v2 Untraceable privacy state (6.3.2.12.3.13), set over the air
    # from the Secured state: EPC truncated to the first N words (None =
    # full), TID exposure, USER-bank hiding, reduced operating range.
    hide_epc_words: Optional[int] = None
    hide_tid: str = "none"            # "none" | "some" | "all"
    hide_user: bool = False
    reduced_range: bool = False
    # Untraceable U flag: when asserted the tag backscatters an XPC_W1
    # word between PC and EPC (PC XI bit set, Gen2 v2 6.3.2.1.2.4) so
    # readers can see the tag is in the untraceable state.
    u_flag: bool = False
    # AuthComm/SecureComm session register: (key, IChallenge, TRnd32)
    # left behind by the last successful TAM1 exchange (tam1_answer).
    session: Optional[tuple] = None

    def __post_init__(self):
        self.epc96 = np.asarray(self.epc96, dtype=np.int64)
        # Any whole-word EPC length (Gen2 6.3.2.1.2.2; the PC length field
        # is 5 bits -> up to 31 words).  The attribute keeps its historical
        # name; 96 bits (6 words) is the common case and the reference's
        # only supported length (EPC_BITS=129, global_vars.h:107).
        assert self.epc96.size % 16 == 0 and self.epc96.size <= 16 * 31
        if self.pc16 is None:
            # PC word: 5-bit EPC length in words, then zeros.
            n_words = self.epc96.size // 16
            pc = np.zeros(16, dtype=np.int64)
            pc[:5] = [(n_words >> (4 - k)) & 1 for k in range(5)]
            self.pc16 = pc
        if self.user_bank is None:
            self.user_bank = np.zeros(128, dtype=np.int64)
        if self.lock_state is None:
            self.lock_state = np.zeros(10, dtype=np.int64)
        if self.user_permalock is None:
            self.user_permalock = np.zeros(self.user_bank.size // 16,
                                           dtype=np.int64)
        self._rng = np.random.default_rng(self.seed)

    @classmethod
    def with_id(cls, tag_id: int, n_words: int = 6, **kw) -> "Tag":
        """Tag whose ID byte (the last byte of the EPC field - the
        reference reads it at frame bits[104:112] for its fixed 96-bit
        EPCs, tag_decoder_impl.cc:348-352) equals ``tag_id``.  ``n_words``
        sets the EPC length (default 6 words = 96 bits, the reference
        geometry; other lengths exercise PC-driven variable-length
        decode)."""
        epc = np.zeros(16 * n_words, dtype=np.int64)
        for k in range(8):
            epc[16 * n_words - 8 + k] = (tag_id >> (7 - k)) & 1
        return cls(epc96=epc, **kw)

    def visible_epc(self) -> np.ndarray:
        """EPC bits the tag exposes: truncated to the first
        ``hide_epc_words`` words when Untraceable hid the tail
        (Gen2 v2 6.3.2.12.3.13)."""
        if self.hide_epc_words is None:
            return self.epc96
        return self.epc96[: 16 * self.hide_epc_words]

    def xpc_w1_bits(self) -> Optional[np.ndarray]:
        """XPC_W1 word (Gen2 v2 6.3.2.1.2.4), backscattered between PC
        and EPC when any XPC bit is asserted (modeled bits: 0 = XEB
        (XPC_W2, never set), 1 = U untraceable flag; rest zero)."""
        if not self.u_flag:
            return None
        xpc = np.zeros(16, dtype=np.int64)
        xpc[1] = 1
        return xpc

    def _visible_pc(self) -> np.ndarray:
        """PC word with the length field tracking the *backscattered*
        payload: XPC word (if any) + exposed EPC, in 16-bit words (Gen2 v2
        6.3.2.1.2.2-4: the length field counts the words between PC and
        CRC, an untraceably-truncated tag reports a correspondingly
        smaller length, and the XI bit announces the XPC word)."""
        xi = self.u_flag
        if self.hide_epc_words is None and not xi:
            return self.pc16
        pc = self.pc16.copy()
        n_words = self.visible_epc().size // 16 + (1 if xi else 0)
        pc[:5] = [(n_words >> (4 - k)) & 1 for k in range(5)]
        if xi:
            pc[6] = 1                    # XI bit (PC address 16h)
        return pc

    def epc_frame_bits(self) -> np.ndarray:
        """EPC reply payload: PC + [XPC_W1] + (visible) EPC + CRC16 over
        everything before the CRC."""
        xpc = self.xpc_w1_bits()
        parts = [self._visible_pc()]
        if xpc is not None:
            parts.append(xpc)
        parts.append(self.visible_epc())
        body = np.concatenate(parts)
        return np.concatenate([body, crc16_bits(body)])

    def epc_bank_bits(self) -> np.ndarray:
        """EPC memory bank (bank 01) layout per Gen2 6.3.2.1: StoredCRC at
        0x00, PC at 0x10, EPC from 0x20 - the address space Select masks
        point into.  Reflects Untraceable hiding (hidden words are simply
        absent from the exposed bank).  The XPC word lives at 210h in the
        spec, far above the EPC field, and is not separately readable in
        this model - it rides the EPC reply only (xpc_w1_bits)."""
        body = np.concatenate([self._visible_pc(), self.visible_epc()])
        return np.concatenate([crc16_bits(body), body])

    def reserved_bank_bits(self) -> np.ndarray:
        """RESERVED bank (bank 00), Gen2 6.3.2.1: kill password at words
        0-1, access password at words 2-3 (MSB first)."""
        out = np.zeros(64, dtype=np.int64)
        for k in range(32):
            out[k] = (self.kill_pwd >> (31 - k)) & 1
            out[32 + k] = (self.access_pwd >> (31 - k)) & 1
        return out

    def tid_bank_bits(self) -> np.ndarray:
        """TID bank (bank 10): E2h class identifier + designer/model + a
        48-bit seed-derived serial (the unique, read-only identity used by
        TID-based singulation)."""
        rng = np.random.default_rng(0xE2 + self.seed)
        head = [1, 1, 1, 0, 0, 0, 1, 0]                     # 0xE2
        body = list(rng.integers(0, 2, 24))                 # designer+model
        serial = list(rng.integers(0, 2, 64))
        return np.array(head + body + serial, dtype=np.int64)

    def _lock(self, field: str) -> bool:
        from ..protocol.gen2 import LOCK_FIELDS

        return bool(self.lock_state[2 * LOCK_FIELDS.index(field)])

    def bank_bits(self, membank, secured: bool = False) -> Optional[np.ndarray]:
        """Memory contents for Read by bank code (00=RESERVED, 01=EPC,
        10=TID, 11=USER).  A password whose pwd-read/write lock bit is set
        is readable only in the Secured state (Gen2 6.3.2.10): locked
        password words read back as None (no reply)."""
        mb = tuple(membank)
        if mb == (0, 0):
            res = self.reserved_bank_bits()
            if not secured:
                if self._lock("kill"):
                    res[:32] = -1       # sentinel: Read must refuse
                if self._lock("access"):
                    res[32:] = -1
            return res
        if mb == (0, 1):
            return self.epc_bank_bits()
        if mb == (1, 0):
            tid = self.tid_bank_bits()
            # Untraceable TID hiding: "some" keeps the allocation-class +
            # designer/model words (first 2) readable, "all" hides the
            # bank entirely (-1 sentinel: Read must refuse).
            if self.hide_tid == "some":
                tid[32:] = -1
            elif self.hide_tid == "all":
                tid[:] = -1
            return tid
        if mb == (1, 1):
            if self.hide_user:
                return np.full_like(self.user_bank, -1)
            return self.user_bank
        return None

    def write_allowed(self, membank, secured: bool) -> bool:
        """Lock-bit gate for Write/BlockWrite (Gen2 6.3.2.10): a
        write-locked bank accepts writes only from the Secured state; TID
        is modeled permanently read-only (factory-locked, the common
        silicon behavior)."""
        mb = tuple(membank)
        if mb == (1, 0):
            return False
        field = {(0, 0): None, (0, 1): "epc", (1, 1): "user"}.get(mb)
        if mb == (0, 0):
            # Password writes: both halves share the bank; gate on the
            # union of the two password locks (word-resolved gating is
            # applied by the channel via the read path's sentinel).
            locked = self._lock("kill") or self._lock("access")
        elif field is None:
            return False
        else:
            locked = self._lock(field)
        return secured or not locked

    def apply_lock(self, payload: np.ndarray) -> bool:
        """Apply a Lock payload (10 mask + 10 action bits).  Fails (no
        reply) if any masked field is permalocked - its bits can never
        change again (Gen2 6.3.2.12.3.5)."""
        payload = np.asarray(payload, dtype=np.int64)
        mask, action = payload[:10], payload[10:]
        for i in range(10):
            if mask[i] and self.lock_state[2 * (i // 2) + 1]:
                if self.lock_state[i] != action[i]:
                    return False
        for i in range(10):
            if mask[i]:
                self.lock_state[i] = action[i]
        return True

    def write_word(self, membank, wordptr: int, bits16: np.ndarray,
                   secured: bool = False) -> bool:
        """Apply a (de-cover-coded) Write.  USER: any word.  EPC bank:
        words >= 2 (the EPC field; StoredCRC/PC are derived/read-only here
        - StoredCRC recomputes automatically because epc_bank_bits builds
        it on the fly, exactly the Gen2 recommissioning behavior).
        RESERVED: password words, subject to their pwd-write locks."""
        bits16 = np.asarray(bits16, dtype=np.int64)
        if not self.write_allowed(membank, secured):
            return False
        mb = tuple(membank)
        if mb == (0, 0):
            if wordptr >= 4:
                return False
            word = int("".join(map(str, bits16)), 2)
            shift = 16 * (1 - wordptr % 2)
            if wordptr < 2:
                self.kill_pwd = (self.kill_pwd
                                 & ~(0xFFFF << shift)) | (word << shift)
            else:
                self.access_pwd = (self.access_pwd
                                   & ~(0xFFFF << shift)) | (word << shift)
            return True
        if mb == (1, 1):
            if (16 * (wordptr + 1) <= self.user_bank.size
                    and not self.user_permalock[wordptr]):
                self.user_bank[16 * wordptr: 16 * (wordptr + 1)] = bits16
                return True
            return False
        if mb == (0, 1) and wordptr >= 2:
            off = 16 * (wordptr - 2)
            if off + 16 <= self.epc96.size:
                self.epc96[off: off + 16] = bits16
                return True
        return False

    def erase_words(self, membank, wordptr: int, wordcount: int,
                    secured: bool = False) -> bool:
        """BlockErase (Gen2 6.3.2.12.3.8): zero ``wordcount`` words from
        ``wordptr``.  Atomic: fails (no reply) unless every word is
        writable - lock-gated like Write, plus per-word USER permalocks."""
        mb = tuple(membank)
        if not self.write_allowed(membank, secured):
            return False
        if mb == (1, 1):
            if 16 * (wordptr + wordcount) > self.user_bank.size:
                return False
            if np.any(self.user_permalock[wordptr: wordptr + wordcount]):
                return False
            self.user_bank[16 * wordptr: 16 * (wordptr + wordcount)] = 0
            return True
        if mb == (0, 1):
            if wordptr < 2:          # StoredCRC/PC are derived/read-only
                return False
            off = 16 * (wordptr - 2)
            if off + 16 * wordcount > self.epc96.size:
                return False
            self.epc96[off: off + 16 * wordcount] = 0
            return True
        return False

    def permalock_status(self, membank, blockptr: int,
                         blockrange: int) -> Optional[np.ndarray]:
        """BlockPermalock Read/Lock=0: the permalock bits of ``blockrange``
        mask words from ``blockptr`` (16 one-word blocks per mask word;
        out-of-range blocks read 0).  USER bank only (the modeled
        block-permalockable bank)."""
        if tuple(membank) != (1, 1):
            return None
        out = np.zeros(16 * blockrange, dtype=np.int64)
        for k in range(16 * blockrange):
            w = 16 * blockptr + k
            if w < self.user_permalock.size:
                out[k] = self.user_permalock[w]
        return out

    def apply_block_permalock(self, membank, blockptr: int,
                              mask: np.ndarray) -> bool:
        """BlockPermalock Read/Lock=1: one-way permalock of masked blocks.
        Fails if any masked block is outside the bank."""
        if tuple(membank) != (1, 1):
            return False
        mask = np.asarray(mask, dtype=np.int64)
        for k in range(mask.size):
            if mask[k] and 16 * blockptr + k >= self.user_permalock.size:
                return False
        for k in range(mask.size):
            if mask[k]:
                self.user_permalock[16 * blockptr + k] = 1
        return True

    #: Backscatter amplitude scale in the reduced-range state (Untraceable
    #: Range=reduced): ~-12 dB of reply power, comfortably decodable at
    #: close range and lost at the far edge - the privacy intent.
    REDUCED_RANGE_SCALE = 0.25

    def apply_untraceable(self, u: int, epc_words: Optional[int], tid: str,
                          hide_user: int, range_: str) -> bool:
        """Apply an Untraceable command (Gen2 v2 6.3.2.12.3.13).  Fails
        (no reply) when the requested EPC exposure exceeds the stored EPC
        or the range profile is unsupported ("toggle" not modeled)."""
        if range_ == "toggle":
            return False
        if epc_words is not None:
            if 16 * epc_words > self.epc96.size:
                return False
            self.hide_epc_words = epc_words
        self.hide_tid = tid
        self.hide_user = bool(hide_user)
        self.reduced_range = range_ == "reduced"
        # U flag asserted -> the tag announces the untraceable state via
        # the XPC_W1 word in its EPC replies (PC XI bit set).
        self.u_flag = bool(u)
        return True

    def tam1_answer(self, csi: int, key_id: int,
                    challenge: np.ndarray) -> Optional[np.ndarray]:
        """TAM1 tag response: encrypt IChallenge || TRnd under the
        selected key — ISO 29167-10 AES-128 (96+32 bits) or ISO 29167-11
        PRESENT-80 (48+16).  None (tag stays silent) when the tag lacks
        the key, the key does not match the commanded crypto suite, or
        the challenge width is wrong for it."""
        from ..protocol import crypto

        if not self.aes_keys:
            return None
        key = self.aes_keys.get(key_id)
        if key is None or len(key) not in (16, 10):
            return None
        if csi != crypto.suite_for_key(bytes(key)):
            return None
        cb, _, tb = crypto.tam1_params(csi)
        challenge = np.asarray(challenge, np.int64)
        if challenge.size != cb:
            return None
        trnd = self._rng.integers(0, 2, size=tb).astype(np.int64)
        if csi == crypto.CSI_AES128:
            # The TAM1 exchange leaves a session secret on both sides
            # (the reader recovers TRnd by decrypting the response): the
            # tag's session register for AuthComm / SecureComm
            # encapsulation (AES-suite only - the envelopes' keystream
            # and MAC are built on AES blocks).
            self.session = (bytes(key), challenge, trnd)
        return crypto.tam1_response(bytes(key), challenge, trnd)

    def tam2_answer(self, csi: int, key_id: int, challenge96: np.ndarray,
                    membank, wordptr: int, n_blocks: int,
                    secured: bool = False) -> Optional[np.ndarray]:
        """TAM2: authenticated confidential memory read - auth block +
        CBC-encrypted memory words (protocol/crypto.py::tam2_response).
        Silent when keyless, out of range, or the words are hidden
        (Untraceable) / password-locked outside Secured."""
        from ..protocol.crypto import CSI_AES128, tam2_response

        if csi != CSI_AES128 or not self.aes_keys:
            return None
        key = self.aes_keys.get(key_id)
        if key is None:
            return None
        mem = self.bank_bits(membank, secured=secured)
        lo, hi = 16 * wordptr, 16 * wordptr + 128 * n_blocks
        if mem is None or hi > mem.size or np.any(mem[lo:hi] < 0):
            return None
        trnd = self._rng.integers(0, 2, size=32).astype(np.int64)
        return tam2_response(bytes(key), challenge96, trnd, mem[lo:hi])

    def install_key(self, csi: int, key_id: int,
                    enc_key128: np.ndarray) -> bool:
        """KeyUpdate: decrypt the new key under the *current* key for
        ``key_id`` and install it (ISO 29167-10 key provisioning).  False
        (no reply) when the tag lacks the suite or that key slot."""
        from ..protocol.crypto import (CSI_AES128, aes128_decrypt_block,
                                       bits_to_bytes)

        if csi != CSI_AES128 or not self.aes_keys:
            return False
        cur = self.aes_keys.get(key_id)
        if cur is None:
            return False
        self.aes_keys[key_id] = aes128_decrypt_block(
            bytes(cur), bits_to_bytes(enc_key128))
        return True

    def draw_rn16(self) -> np.ndarray:
        return self._rng.integers(0, 2, size=16).astype(np.int64)

    def draw_slot(self, q: int) -> int:
        return int(self._rng.integers(0, 2**q)) if q > 0 else 0

    def chip_us(self, cfg: ReaderConfig) -> float:
        """Effective backscatter chip duration under this tag's BLF error."""
        return cfg.tag_bit_us / (2 * cfg.miller_m) / (1.0 + self.blf_offset)

    def channel_phasor(self, cfg: ReaderConfig, t_s: float = 0.0,
                       freq_hz: float = None) -> complex:
        """Effective complex backscatter coefficient at capture time t_s.

        The monostatic round trip imposes phase -4*pi*f*d/c at the carrier
        (``cfg.freq_hz``) with d(t) = distance_m + velocity_mps * t - the
        observable runtime/ranging.py inverts.  The phase is held constant
        across one reply (motion rotates < 0.2 rad over a 3.4 ms EPC frame
        even at 1.5 m/s; model per-frame rotation via ``cfo_hz`` if needed).
        Magnitude is NOT path-loss scaled - the link budget is set directly
        through ``backscatter`` (times REDUCED_RANGE_SCALE in the
        Untraceable reduced-range state).  ``freq_hz`` overrides the
        config carrier (frequency-hopping channels retune mid-session)."""
        bs = complex(self.backscatter)
        if self.reduced_range:
            bs *= self.REDUCED_RANGE_SCALE
        if self.distance_m is None:
            return bs
        f = cfg.freq_hz if freq_hz is None else freq_hz
        d = self.distance_m + self.velocity_mps * t_s
        return complex(bs * np.exp(-4j * np.pi * f * d / C_LIGHT))


def superpose_reply(
    seg: np.ndarray,
    chips: np.ndarray,
    reply_offset_us: float,
    backscatter: complex,
    chip_us: float,
    sp_us: float,
    adc_rate: float,
    cfo_hz: float = 0.0,
    amp_ramp: float = 0.0,
) -> None:
    """Add one tag's backscatter chips onto a CW segment in place.

    Chip edges land at round(offset + k*chip_us) samples (the boundary
    convention all synthesizers share); ``cfo_hz`` rotates the backscatter
    phase linearly over the reply and ``amp_ramp`` scales its amplitude
    linearly from 1 to 1+amp_ramp.
    """
    d = chip_us * sp_us
    off = int(round(reply_offset_us * sp_us))
    bounds = np.round(off + d * np.arange(chips.size + 1)).astype(np.int64)
    ind = np.repeat(chips.astype(np.float32), np.diff(bounds))
    end = min(int(bounds[-1]), seg.size)
    if end <= off:
        return
    ind = ind[: end - off]
    wave = np.complex64(backscatter) * ind
    if amp_ramp or cfo_hz:
        s = np.arange(end - off, dtype=np.float64)
        total = max(int(bounds[-1]) - off, 1)
        scale = 1.0 + amp_ramp * (s / total)
        if cfo_hz:
            scale = scale * np.exp(2j * np.pi * cfo_hz * s / adc_rate)
        wave = (wave * scale).astype(np.complex64)
    seg[off:end] += wave


def tag_id_of_frame(frame: np.ndarray) -> int:
    """Reference-style tag id from an EPC reply frame (PC + EPC + CRC16):
    the last byte of the EPC field = frame[-24:-16] - equals the
    reference's bits[104:112] for its fixed 96-bit EPCs
    (tag_decoder_impl.cc:348-352), and generalizes to any PC length."""
    return int("".join(str(int(x)) for x in np.asarray(frame)[-24:-16]), 2)


def reply_chips(cfg: ReaderConfig, bits: np.ndarray) -> np.ndarray:
    """Chips for a tag reply under the config's encoding (FM0 or Miller-M)."""
    if cfg.miller_m == 1:
        return fm0_chips(bits, trext=cfg.trext, pilot_bits=cfg.pilot_tone_bits)
    return miller_chips(bits, cfg.miller_m, trext=cfg.trext)
