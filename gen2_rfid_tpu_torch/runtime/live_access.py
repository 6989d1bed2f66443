"""Gen2 access + security command sequences for the live reader.

Split out of runtime/live.py (round 4 decomposition).  Everything that
runs *after* a successful EPC read lives here: the Req_RN handle fetch,
Access/Lock/Write/BlockWrite/BlockErase/BlockPermalock/Read/Kill
(Gen2 6.3.2.12.3), the Gen2 v2 crypto set (Authenticate TAM1/TAM2,
Challenge/ReadBuffer, KeyUpdate, Untraceable, AuthComm/SecureComm —
ISO 29167-10/-11 suites), plus the round-start Select and broadcast
Challenge transmissions.  All replies are CRC-16-verified and must echo
the handle; Annex-I error replies are decoded and counted.
"""

from __future__ import annotations

import logging

import numpy as np

from ..protocol import gen2

_log = logging.getLogger("gen2_rfid_tpu.live")


class AccessOpsMixin:
    """Post-singulation command sequences (needs the host mixins'
    `_decode_window`, `self.enc`, `self.cfg`, `self.stats`)."""

    @staticmethod
    def _bank_code(name: str):
        return {"reserved": gen2.MEMBANK_RESERVED, "epc": gen2.MEMBANK_EPC,
                "tid": gen2.MEMBANK_TID, "user": gen2.MEMBANK_USER}[name]

    def _req_rn(self, channel, rn: np.ndarray):
        """One Req_RN exchange; returns the CRC-verified 16-bit reply RN
        (a handle from an Acknowledged tag, or a Write cover-code from an
        Open tag) or None."""
        cfg = self.cfg
        pre = 1 + cfg.effective_preamble_bits      # dummy-1 + preamble
        rr = gen2.req_rn_bits(rn)
        cw = float(cfg.t1_us + cfg.t2_us + (32 + pre) * cfg.tag_bit_us)
        rx = channel.exchange("req_rn", rr, self.enc.command(rr), cw)
        out = self._decode_window(rx, "acc:32")
        if out is None:
            return None
        if not np.array_equal(gen2._crc16_any(out[:16]), out[16:]):
            return None
        return out[:16]

    @property
    def _wants_access(self) -> bool:
        return any(x is not None for x in (
            self.access_read, self.access_write, self.access_pwd,
            self.lock, self.block_write, self.block_erase,
            self.block_permalock, self.kill_pwd, self.authenticate,
            self.challenge_auth, self.untraceable, self.key_update,
            self.authenticate_read, self.secure_read, self.secure_write,
            self.auth_comm_write))

    def _delayed_ok(self, out, handle) -> bool:
        """Verify a delayed success reply (Write/BlockWrite/Lock/final
        Kill): header-0 + handle echo + CRC-16 over header+handle."""
        return (out is not None and out[0] == 0
                and np.array_equal(out[1:17], handle)
                and np.array_equal(gen2._crc16_any(out[:17]), out[17:33]))

    def _record_error(self, out, handle) -> bool:
        """Check a decoded window (>= 41 bits) for an Annex-I error reply
        addressed to ``handle``; record it in ``error_counts``."""
        if out is None or len(out) < gen2.ERROR_REPLY_BITS:
            return False
        name, h, ok = gen2.parse_error_reply(out)
        if not (ok and np.array_equal(h, handle)):
            return False
        st = self.stats
        st.error_counts[name] = st.error_counts.get(name, 0) + 1
        _log.debug("TAG ERROR | %s", name)
        return True

    def _delayed_exchange(self, channel, kind, bits, handle) -> bool:
        """Transmit a delayed-reply access command; decode success
        (header-0 + handle + CRC) or an Annex-I error reply (header-1 +
        code + handle + CRC, 41 bits - the window covers both)."""
        cfg = self.cfg
        pre = 1 + cfg.effective_preamble_bits
        nb = gen2.ERROR_REPLY_BITS              # 41 >= the 33-bit success
        cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
        rx = channel.exchange(kind, bits, self.enc.command(bits), cw)
        out = self._decode_window(rx, f"acc:{nb}")
        if self._delayed_ok(out, handle):
            return True
        self._record_error(out, handle)
        return False

    def _tam1_session(self, channel, handle, key_id: int, key):
        """One TAM1 exchange establishing an AuthComm/SecureComm session.

        Returns (challenge96, trnd32) - the session secret both sides now
        hold (the tag stored its half in ``Tag.session``) - or None when
        the tag stayed silent or the crypto check failed."""
        from ..protocol import crypto

        cfg = self.cfg
        st = self.stats
        pre = 1 + cfg.effective_preamble_bits
        chal = self._auth_rng.integers(0, 2, 96).astype(np.int64)
        ab = gen2.authenticate_bits(
            handle, crypto.tam1_message(key_id, chal))
        nb = 1 + crypto.TAM1_RESPONSE_BITS + 32
        cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
        rx = channel.exchange("authenticate", ab, self.enc.command(ab), cw)
        out = self._decode_window(rx, f"acc:{nb}")
        if (out is None or out[0] != 0
                or not np.array_equal(out[129:145], handle)
                or not np.array_equal(gen2._crc16_any(out[:145]),
                                      out[145:])):
            return None
        ok, trnd = crypto.tam1_verify(bytes(key), chal, out[1:129])
        if not ok:
            st.n_auth_fail += 1
            return None
        return chal, trnd

    def _pwd_step(self, channel, handle, half, kind: str):
        """One cover-coded password half (Access or Kill): Req_RN(handle)
        fetches the cover RN16, the half travels XOR'd with it.  Returns
        the decoded reply bits (None = tag silent)."""
        cfg = self.cfg
        cover = self._req_rn(channel, handle)
        if cover is None:
            return None
        cc = (np.asarray(half) + cover) % 2
        if kind == "access":
            bits = gen2.access_bits(handle, cc)
            nb = 32                                 # handle + CRC echo
        else:
            bits = gen2.kill_bits(handle, cc)
            nb = 32 if kind == "kill1" else 33      # final reply is delayed
        pre = 1 + cfg.effective_preamble_bits
        cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
        rx = channel.exchange("access" if kind == "access" else "kill",
                              bits, self.enc.command(bits), cw)
        return self._decode_window(rx, f"acc:{nb}")

    def _access_sequence(self, channel, rn16, tid: int) -> None:
        """Req_RN -> handle, then the configured access commands
        (Gen2 6.3.2.12.3) in spec order: Access (-> Secured), Lock, Write,
        BlockWrite, Read, Kill.  Every reply is CRC-16-verified and must
        echo the handle; passwords and Write data travel cover-coded."""
        cfg = self.cfg
        st = self.stats
        pre = 1 + cfg.effective_preamble_bits      # dummy-1 + preamble

        handle = self._req_rn(channel, rn16)
        if handle is None:
            return
        st.n_req_rn_ok += 1
        _log.debug("REQ_RN OK | handle=%s", "".join(map(str, handle)))

        if self.access_pwd is not None:
            hi, lo = gen2.pwd_halves(self.access_pwd)
            ok = True
            for half in (hi, lo):
                out = self._pwd_step(channel, handle, half, "access")
                if (out is None or not np.array_equal(out[:16], handle)
                        or not np.array_equal(gen2._crc16_any(out[:16]),
                                              out[16:])):
                    ok = False
                    break
            if not ok:
                return
            st.n_access_ok += 1
            _log.debug("ACCESS OK | tag %#x secured", tid)

        if self.authenticate is not None:
            # Gen2 v2 TAM1 (6.3.2.12.3.11): fresh challenge per tag,
            # immediate response, decrypt-and-compare.  The crypto suite
            # follows the key length: ISO 29167-10 AES-128 (16 bytes,
            # 96-bit challenge / 128-bit response) or ISO 29167-11
            # PRESENT-80 (10 bytes, 48 / 64).
            from ..protocol import crypto

            key_id, key = self.authenticate
            cb, rb, _ = crypto.tam1_params(
                crypto.suite_for_key(bytes(key)))
            chal = self._auth_rng.integers(0, 2, cb).astype(np.int64)
            ab = gen2.authenticate_bits(
                handle, crypto.tam1_message(key_id, chal),
                csi=crypto.suite_for_key(bytes(key)))
            nb = 1 + rb + 32
            cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
            rx = channel.exchange("authenticate", ab, self.enc.command(ab),
                                  cw)
            out = self._decode_window(rx, f"acc:{nb}")
            if (out is not None and out[0] == 0
                    and np.array_equal(out[1 + rb: 17 + rb], handle)
                    and np.array_equal(gen2._crc16_any(out[:17 + rb]),
                                       out[17 + rb:])):
                ok, _ = crypto.tam1_verify(bytes(key), chal,
                                           out[1: 1 + rb])
                if ok:
                    st.n_auth_ok += 1
                    _log.debug("AUTHENTICATE OK | tag %#x", tid)
                else:
                    st.n_auth_fail += 1
                    _log.debug("AUTHENTICATE CRYPTO FAIL | tag %#x", tid)

        if self.authenticate_read is not None:
            # TAM2 authenticated confidential read: one exchange proves
            # the key AND returns CBC-encrypted memory (never in clear).
            from ..protocol import crypto

            key_id, key, wordptr, n_blocks = self.authenticate_read[:4]
            bank = (self.authenticate_read[4]
                    if len(self.authenticate_read) > 4 else "user")
            chal = self._auth_rng.integers(0, 2, 96).astype(np.int64)
            ab = gen2.authenticate_bits(
                handle, crypto.tam2_message(key_id, chal,
                                            self._bank_code(bank),
                                            wordptr, n_blocks))
            resp_bits = 128 * (1 + n_blocks)
            nb = 1 + resp_bits + 32
            cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
            rx = channel.exchange("authenticate", ab, self.enc.command(ab),
                                  cw)
            out = self._decode_window(rx, f"acc:{nb}")
            if (out is not None and out[0] == 0
                    and np.array_equal(out[1 + resp_bits: 17 + resp_bits],
                                       handle)
                    and np.array_equal(gen2._crc16_any(out[: nb - 16]),
                                       out[nb - 16:])):
                ok, data = crypto.tam2_verify(bytes(key), chal,
                                              out[1: 1 + resp_bits])
                if ok:
                    st.n_tam2_ok += 1
                    st.secure_read_words[tid] = data
                    _log.debug("TAM2 SECURE READ OK | tag %#x words=%d",
                               tid, 8 * n_blocks)
                else:
                    st.n_auth_fail += 1

        if (self.secure_read is not None or self.secure_write is not None
                or self.auth_comm_write is not None):
            # Gen2 v2 AuthComm/SecureComm encapsulation: establish the
            # TAM1 session once, then run the configured encapsulated
            # commands under it (protocol/crypto.py session construction).
            from ..protocol import crypto

            first = (self.secure_read or self.secure_write
                     or self.auth_comm_write)
            key_id, key = first[0], bytes(first[1])
            sess = self._tam1_session(channel, handle, key_id, key)
            if sess is not None:
                chal, trnd = sess
                ctr = 0
                if self.auth_comm_write is not None:
                    wordptr, data = self.auth_comm_write[2:4]
                    bank = (self.auth_comm_write[4]
                            if len(self.auth_comm_write) > 4 else "user")
                    wb = gen2.write_bits(handle, np.asarray(data),
                                         membank=self._bank_code(bank),
                                         wordptr=wordptr)
                    mac = crypto.session_mac(key, chal, trnd, wb, ctr=ctr,
                                             direction=0)
                    ac = gen2.auth_comm_bits(handle, wb, mac)
                    ctr += 1
                    if self._delayed_exchange(channel, "auth_comm", ac,
                                              handle):
                        st.n_auth_comm_ok += 1
                        _log.debug("AUTHCOMM WRITE OK | tag %#x word %d",
                                   tid, wordptr)
                if self.secure_write is not None:
                    wordptr, data = self.secure_write[2:4]
                    bank = (self.secure_write[4]
                            if len(self.secure_write) > 4 else "user")
                    wb = gen2.write_bits(handle, np.asarray(data),
                                         membank=self._bank_code(bank),
                                         wordptr=wordptr)
                    ks = crypto.session_keystream(key, chal, trnd, ctr,
                                                  wb.size, direction=0)
                    sc = gen2.secure_comm_bits(handle, (wb + ks) % 2)
                    ctr += 1
                    if self._delayed_exchange(channel, "secure_comm", sc,
                                              handle):
                        st.n_secure_write_ok += 1
                        _log.debug("SECURECOMM WRITE OK | tag %#x word %d",
                                   tid, wordptr)
                if self.secure_read is not None:
                    wordptr, wc = self.secure_read[2:4]
                    bank = (self.secure_read[4]
                            if len(self.secure_read) > 4 else "user")
                    rb = gen2.read_bits(handle,
                                        membank=self._bank_code(bank),
                                        wordptr=wordptr, wordcount=wc)
                    ks = crypto.session_keystream(key, chal, trnd, ctr,
                                                  rb.size, direction=0)
                    sc = gen2.secure_comm_bits(handle, (rb + ks) % 2)
                    nb = 1 + 16 * wc + 16 + 16
                    cw = float(cfg.t1_us + cfg.t2_us
                               + (nb + pre) * cfg.tag_bit_us)
                    rx = channel.exchange("secure_comm", sc,
                                          self.enc.command(sc), cw)
                    out = self._decode_window(rx, f"acc:{nb}")
                    if (out is not None and out[0] == 0
                            and np.array_equal(
                                out[1 + 16 * wc: 17 + 16 * wc], handle)
                            and np.array_equal(
                                gen2._crc16_any(out[: nb - 16]),
                                out[nb - 16:])):
                        ks2 = crypto.session_keystream(
                            key, chal, trnd, ctr, 16 * wc, direction=1)
                        st.secure_read_words[tid] = (
                            out[1: 1 + 16 * wc] + ks2) % 2
                        st.n_secure_read_ok += 1
                        _log.debug("SECURECOMM READ OK | tag %#x words=%d",
                                   tid, wc)
                    else:
                        # Rejected inner commands answer with a cleartext
                        # Annex-I error reply (the envelope protects data,
                        # not the failure class).
                        self._record_error(out, handle)
                    ctr += 1

        if self.challenge_auth is not None and self._challenge is not None:
            # Fetch the Challenge-precomputed response (6.3.2.12.3.12) and
            # verify it against the broadcast challenge.
            from ..protocol import crypto

            _, key = self.challenge_auth
            _, resp_b, _ = crypto.tam1_params(
                crypto.suite_for_key(bytes(key)))
            rb = gen2.readbuffer_bits(handle, bitcount=resp_b)
            nb = 1 + resp_b + 32
            cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
            rx = channel.exchange("readbuffer", rb, self.enc.command(rb), cw)
            out = self._decode_window(rx, f"acc:{nb}")
            if (out is not None and out[0] == 0
                    and np.array_equal(out[1 + resp_b: 17 + resp_b], handle)
                    and np.array_equal(gen2._crc16_any(out[:17 + resp_b]),
                                       out[17 + resp_b:])):
                ok, _ = crypto.tam1_verify(bytes(key), self._challenge,
                                           out[1: 1 + resp_b])
                if ok:
                    st.n_buffer_auth_ok += 1
                    _log.debug("READBUFFER AUTH OK | tag %#x", tid)
                else:
                    st.n_auth_fail += 1

        if self.key_update is not None:
            # Over-the-air key provisioning: new key encrypted under the
            # current key (ISO 29167-10; nothing travels in clear).
            from ..protocol import crypto

            key_id, old_key, new_key = self.key_update
            enc = crypto.bytes_to_bits(
                crypto.aes128_encrypt_block(bytes(old_key), bytes(new_key)))
            kb = gen2.keyupdate_bits(handle, key_id, enc)
            if self._delayed_exchange(channel, "keyupdate", kb, handle):
                st.n_keyupdate_ok += 1
                _log.debug("KEYUPDATE OK | tag %#x key %d", tid, key_id)

        if self.untraceable is not None:
            ub = gen2.untraceable_bits(handle, **self.untraceable)
            if self._delayed_exchange(channel, "untraceable", ub, handle):
                st.n_untraceable_ok += 1
                _log.debug("UNTRACEABLE OK | tag %#x", tid)

        if self.lock is not None:
            lb = gen2.lock_bits(handle, self.lock)
            if self._delayed_exchange(channel, "lock", lb, handle):
                st.n_lock_ok += 1
                _log.debug("LOCK OK | tag %#x", tid)

        if self.access_write is not None:
            wordptr, data = self.access_write[:2]
            bank = self.access_write[2] if len(self.access_write) > 2 else "user"
            cover = self._req_rn(channel, handle)   # fresh RN16 cover-code
            if cover is not None:
                wb = gen2.write_bits(
                    handle, (np.asarray(data) + cover) % 2,
                    membank=self._bank_code(bank), wordptr=wordptr)
                if self._delayed_exchange(channel, "write", wb, handle):
                    st.n_write_ok += 1
                    _log.debug("WRITE OK | tag %#x word %d", tid, wordptr)

        if self.block_write is not None:
            wordptr, data = self.block_write[:2]
            bank = self.block_write[2] if len(self.block_write) > 2 else "user"
            bw = gen2.blockwrite_bits(handle, np.asarray(data),
                                      membank=self._bank_code(bank),
                                      wordptr=wordptr)
            if self._delayed_exchange(channel, "blockwrite", bw, handle):
                st.n_blockwrite_ok += 1
                _log.debug("BLOCKWRITE OK | tag %#x words=%d", tid,
                           len(data) // 16)

        if self.block_erase is not None:
            wordptr, wordcount = self.block_erase[:2]
            bank = self.block_erase[2] if len(self.block_erase) > 2 else "user"
            eb = gen2.blockerase_bits(handle, membank=self._bank_code(bank),
                                      wordptr=wordptr, wordcount=wordcount)
            if self._delayed_exchange(channel, "blockerase", eb, handle):
                st.n_blockerase_ok += 1
                _log.debug("BLOCKERASE OK | tag %#x words=%d", tid, wordcount)

        if self.block_permalock is not None:
            blockptr, mask = self.block_permalock[:2]
            if mask is None:
                # Read/Lock=0: fetch the permalock-status bits (one mask
                # word = 16 one-word blocks).
                nb = 1 + 16 + 32
                pb = gen2.blockpermalock_bits(handle, blockptr=blockptr)
                cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
                rx = channel.exchange("blockpermalock", pb,
                                      self.enc.command(pb), cw)
                out = self._decode_window(rx, f"acc:{nb}")
                if (out is not None and out[0] == 0
                        and np.array_equal(out[17:33], handle)
                        and np.array_equal(gen2._crc16_any(out[:33]),
                                           out[33:])):
                    st.permalock_status[tid] = np.asarray(out[1:17])
                else:
                    self._record_error(out, handle)
            else:
                mask = np.asarray(mask, dtype=np.int64)
                pb = gen2.blockpermalock_bits(
                    handle, read_lock=1, blockptr=blockptr,
                    blockrange=mask.size // 16, mask=mask)
                if self._delayed_exchange(channel, "blockpermalock", pb,
                                          handle):
                    st.n_blockpermalock_ok += 1
                    _log.debug("BLOCKPERMALOCK OK | tag %#x", tid)

        if self.access_read is not None:
            wordptr, wordcount = self.access_read[:2]
            bank = self.access_read[2] if len(self.access_read) > 2 else "epc"
            nb = 1 + 16 * wordcount + 32           # header+data+handle+CRC
            rd = gen2.read_bits(handle, membank=self._bank_code(bank),
                                wordptr=wordptr, wordcount=wordcount)
            cw = float(cfg.t1_us + cfg.t2_us + (nb + pre) * cfg.tag_bit_us)
            rx = channel.exchange("read", rd, self.enc.command(rd), cw)
            out = self._decode_window(rx, f"acc:{nb}")
            if out is not None:
                data = out[1: 1 + 16 * wordcount]
                hecho = out[1 + 16 * wordcount: 17 + 16 * wordcount]
                crc = out[nb - 16:]
                if (out[0] == 0 and np.array_equal(hecho, handle)
                        and np.array_equal(
                            gen2._crc16_any(out[: nb - 16]), crc)):
                    st.n_read_ok += 1
                    st.read_words[tid] = np.asarray(data)
                    _log.debug("READ OK | tag %#x words=%d", tid, wordcount)
                else:
                    # Annex-I error reply (41 bits <= any Read window).
                    self._record_error(out, handle)

        if self.kill_pwd is not None:
            hi, lo = gen2.pwd_halves(self.kill_pwd)
            out = self._pwd_step(channel, handle, hi, "kill1")
            if (out is not None and np.array_equal(out[:16], handle)
                    and np.array_equal(gen2._crc16_any(out[:16]), out[16:])):
                out = self._pwd_step(channel, handle, lo, "kill2")
                if self._delayed_ok(out, handle):
                    st.n_kill_ok += 1
                    _log.debug("KILL OK | tag %#x dead", tid)

    def _send_select(self, channel) -> None:
        """Transmit the configured Select (no reply expected; tags apply
        the SL action, Gen2 6.3.2.12.1.1)."""
        if self.select_mask is None:
            return
        mask, pointer = self.select_mask
        target = (gen2.SELECT_TARGET_SL if self.select_target == "sl"
                  else gen2.SELECT_TARGET_S[int(self.select_target[1])])
        sb = gen2.select_bits(np.asarray(mask), pointer,
                              membank=self._bank_code(self.select_bank),
                              target=target, action=self.select_action,
                              truncate=int(self.select_truncate))
        channel.exchange("select", sb, self.enc.select(sb),
                         float(self.cfg.cw_us))
        _log.debug("SELECT | ptr=%#x len=%d tgt=%s act=%d", pointer,
                   len(mask), self.select_target, self.select_action)

    def _send_challenge(self, channel) -> None:
        """Broadcast the Gen2 v2 Challenge (6.3.2.12.3.10): tags holding
        the key precompute their TAM1 response for later ReadBuffer
        retrieval.  Re-sent after every power-down (the ResponseBuffer does
        not survive power loss)."""
        if self.challenge_auth is None:
            return
        from ..protocol import crypto

        key_id, key = self.challenge_auth
        n_chal = crypto.tam1_params(crypto.suite_for_key(bytes(key)))[0]
        self._challenge = self._auth_rng.integers(
            0, 2, n_chal).astype(np.int64)
        cb = gen2.challenge_bits(
            crypto.tam1_message(key_id, self._challenge),
            csi=crypto.suite_for_key(bytes(key)))
        channel.exchange("challenge", cb, self.enc.command(cb),
                         float(self.cfg.cw_us))
        _log.debug("CHALLENGE | key_id=%d", key_id)
