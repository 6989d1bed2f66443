"""GS1 EPC Tag Data Standard (TDS) binary encoding/decoding.

New capability with no reference analogue: the reference reports a decoded
EPC only as a raw bit pattern plus an 8-bit "tag id" (EPC bits[104:112],
``tag_decoder_impl.cc:348-352``).  Production RFID deployments carry GS1
identities (SGTIN, SSCC, ...) in the EPC bank, and reader middleware is
expected to surface them as EPC URIs (the LLRP / ALE reporting surface).
This module converts between the EPC-bank bit pattern and the TDS pure
identity (``urn:epc:id:...``) / tag (``urn:epc:tag:...``) URIs.

Implemented schemes (GS1 TDS 1.13, header values from TDS table 14-1):

=========  ======  ===========================================
header     bits    scheme
=========  ======  ===========================================
``0x30``   96      SGTIN-96  (serialized trade item)
``0x36``   198     SGTIN-198 (alphanumeric serial)
``0x31``   96      SSCC-96   (logistic unit)
``0x32``   96      SGLN-96   (physical location)
``0x33``   96      GRAI-96   (returnable asset)
``0x34``   96      GIAI-96   (individual asset)
``0x35``   96      GID-96    (general identifier, no GS1 key)
``0x2C``   96      GDTI-96   (document type)
``0x3E``   174     GDTI-174  (alphanumeric document serial)
``0x2D``   96      GSRN-96   (service relation, recipient)
``0x2E``   96      GSRNP-96  (service relation, provider)
``0x3F``   96      SGCN-96   (coupon; serial keeps leading zeros)
``0x2F``   96      USDoD-96  (DoD construct: CAGE/DODAAC + serial)
=========  ======  ===========================================

Pure Python on purpose: identity parsing is a per-read reporting surface
(tens of strings per capture), not device compute; the hot decode path
stays selection algebra in ``dsp/``/``runtime/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# Partition tables: partition value -> (company-prefix bits, cp digits,
# reference bits, reference digits).  One table per key family (TDS 1.13
# tables 14-2 .. 14-20); SGTIN and GRAI share the 44-bit split, SGLN's
# second field is 41-bit-total, etc.
_PART_SGTIN = {
    0: (40, 12, 4, 1), 1: (37, 11, 7, 2), 2: (34, 10, 10, 3),
    3: (30, 9, 14, 4), 4: (27, 8, 17, 5), 5: (24, 7, 20, 6),
    6: (20, 6, 24, 7),
}
_PART_SSCC = {
    0: (40, 12, 18, 5), 1: (37, 11, 21, 6), 2: (34, 10, 24, 7),
    3: (30, 9, 27, 8), 4: (27, 8, 30, 9), 5: (24, 7, 34, 10),
    6: (20, 6, 38, 11),
}
_PART_SGLN = {
    0: (40, 12, 1, 0), 1: (37, 11, 4, 1), 2: (34, 10, 7, 2),
    3: (30, 9, 11, 3), 4: (27, 8, 14, 4), 5: (24, 7, 17, 5),
    6: (20, 6, 21, 6),
}
_PART_GRAI = {
    0: (40, 12, 4, 0), 1: (37, 11, 7, 1), 2: (34, 10, 10, 2),
    3: (30, 9, 14, 3), 4: (27, 8, 17, 4), 5: (24, 7, 20, 5),
    6: (20, 6, 24, 6),
}
_PART_GIAI = {
    0: (40, 12, 42, 13), 1: (37, 11, 45, 14), 2: (34, 10, 48, 15),
    3: (30, 9, 52, 16), 4: (27, 8, 55, 17), 5: (24, 7, 58, 18),
    6: (20, 6, 62, 19),
}

# GDTI / SGCN share SGLN's 12-digit company-prefix+reference split
# (TDS tables 14-6, 14-11, 14-12): document type / coupon reference bits
# 1, 4, 7, 11, 14, 17, 21 for partitions 0-6.
_PART_GDTI = _PART_SGLN
# GSRN's service reference completes 17 digits like SSCC's serial
# reference (TDS tables 14-8, 14-9).
_PART_GSRN = _PART_SSCC

#: header -> (scheme, total bits, partition table, serial bits, uri id)
_SCHEMES = {
    0x30: ("sgtin-96", 96, _PART_SGTIN, 38, "sgtin"),
    0x36: ("sgtin-198", 198, _PART_SGTIN, 140, "sgtin"),
    0x31: ("sscc-96", 96, _PART_SSCC, 0, "sscc"),
    0x32: ("sgln-96", 96, _PART_SGLN, 41, "sgln"),
    0x33: ("grai-96", 96, _PART_GRAI, 38, "grai"),
    0x34: ("giai-96", 96, _PART_GIAI, 0, "giai"),
    0x2C: ("gdti-96", 96, _PART_GDTI, 41, "gdti"),
    0x3E: ("gdti-174", 174, _PART_GDTI, 119, "gdti"),
    0x2D: ("gsrn-96", 96, _PART_GSRN, 0, "gsrn"),
    0x2E: ("gsrnp-96", 96, _PART_GSRN, 0, "gsrnp"),
    0x3F: ("sgcn-96", 96, _PART_GDTI, 41, "sgcn"),
}


def _bits_to_int(bits: Sequence[int], a: int, b: int) -> int:
    v = 0
    for i in range(a, b):
        v = (v << 1) | int(bits[i])
    return v


def _int_to_bits(v: int, n: int) -> List[int]:
    if v < 0 or v >= (1 << n):
        raise ValueError(f"value {v} does not fit in {n} bits")
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _string_serial_decode(bits: Sequence[int], a: int, b: int) -> Optional[str]:
    """SGTIN-198 alphanumeric serial: 7-bit ISO 646 chars, zero-padded
    (TDS 14.4.2).  Returns None on a malformed (non-contiguous) pad."""
    chars = []
    ended = False
    for i in range(a, b - 6, 7):
        c = _bits_to_int(bits, i, i + 7)
        if c == 0:
            ended = True
            continue
        if ended or not (0x21 <= c <= 0x7A):
            return None
        chars.append(chr(c))
    return "".join(chars)


def _string_serial_encode(s: str, n_bits: int) -> List[int]:
    if len(s) * 7 > n_bits:
        raise ValueError("serial string too long")
    bits: List[int] = []
    for ch in s:
        c = ord(ch)
        if not (0x21 <= c <= 0x7A):
            raise ValueError(f"character {ch!r} outside ISO 646 subset")
        bits += _int_to_bits(c, 7)
    return bits + [0] * (n_bits - len(bits))


def _uri_escape(s: str) -> str:
    """Percent-escape the TDS reserved characters for URI serial fields."""
    out = []
    for ch in s:
        if ch in '"%&/<>?#':
            out.append("%{:02X}".format(ord(ch)))
        else:
            out.append(ch)
    return "".join(out)


def _epc_hex(bits: List[int]) -> str:
    nhex = (len(bits) + 3) // 4
    return "".join(
        "{:X}".format(_bits_to_int(bits, 4 * i, min(4 * i + 4, len(bits))))
        for i in range(nhex)
    )


def decode_epc(epc_bits) -> Dict[str, object]:
    """Decode an EPC-bank bit pattern to its TDS identity.

    epc_bits: 1-D array/list of 0/1 MSB-first (the EPC field as stored in
    the tag's EPC bank and as decoded off the air — PC/XPC/CRC excluded;
    see ``protocol.gen2.parse_epc_frame_full``).

    Returns a dict with at least ``scheme`` and ``hex``; known headers add
    the parsed fields plus ``uri`` (pure identity) and ``tag_uri``.
    Unknown headers or malformed field values return
    ``{"scheme": "unknown", "hex": ...}`` — never raises on tag data.
    """
    bits = [int(b) for b in np.asarray(epc_bits).reshape(-1)]
    as_hex = _epc_hex(bits)
    out: Dict[str, object] = {"scheme": "unknown", "hex": as_hex}
    if len(bits) < 8:
        return out
    header = _bits_to_int(bits, 0, 8)
    if header == 0x35 and len(bits) >= 96:
        return _decode_gid(bits, as_hex)
    if header == 0x2F and len(bits) >= 96:
        return _decode_usdod(bits, as_hex, out)
    if header not in _SCHEMES:
        return out
    scheme, total, table, ser_bits, uri_id = _SCHEMES[header]
    if len(bits) < total:
        return out
    filt = _bits_to_int(bits, 8, 11)
    part = _bits_to_int(bits, 11, 14)
    if part not in table:
        return out
    cp_bits, cp_dig, ref_bits, ref_dig = table[part]
    pos = 14
    cp = _bits_to_int(bits, pos, pos + cp_bits)
    pos += cp_bits
    ref = _bits_to_int(bits, pos, pos + ref_bits)
    pos += ref_bits
    if cp >= 10 ** cp_dig or (ref_dig and ref >= 10 ** ref_dig):
        return out
    cp_s = str(cp).zfill(cp_dig)
    # GIAI's individual asset reference is a variable-length integer (no
    # leading-zero padding, TDS 14.5.5); the other keys are fixed-width.
    ref_s = str(ref) if scheme == "giai-96" else str(ref).zfill(ref_dig)
    fields: Dict[str, object] = {
        "scheme": scheme, "hex": as_hex, "filter": filt, "partition": part,
        "company_prefix": cp_s,
    }
    if scheme in ("sgtin-96", "sgtin-198"):
        if scheme == "sgtin-96":
            serial = _bits_to_int(bits, pos, pos + ser_bits)
            ser_s = str(serial)
        else:
            s = _string_serial_decode(bits, pos, pos + ser_bits)
            if s is None or not s:
                return out
            ser_s = _uri_escape(s)
        fields.update(item_reference=ref_s, serial=ser_s)
        body = f"{cp_s}.{ref_s}.{ser_s}"
    elif scheme == "sscc-96":
        # 24 trailing reserved bits must be zero (TDS 14.5.2).
        if _bits_to_int(bits, pos, pos + 24) != 0:
            return out
        fields.update(serial_reference=ref_s)
        body = f"{cp_s}.{ref_s}"
    elif scheme == "sgln-96":
        serial = _bits_to_int(bits, pos, pos + ser_bits)
        fields.update(location_reference=ref_s, extension=str(serial))
        body = f"{cp_s}.{ref_s}.{serial}"
    elif scheme == "grai-96":
        serial = _bits_to_int(bits, pos, pos + ser_bits)
        fields.update(asset_type=ref_s, serial=str(serial))
        body = f"{cp_s}.{ref_s}.{serial}"
    elif scheme == "gdti-96":
        serial = _bits_to_int(bits, pos, pos + ser_bits)
        fields.update(document_type=ref_s, serial=str(serial))
        body = f"{cp_s}.{ref_s}.{serial}"
    elif scheme == "gdti-174":
        s = _string_serial_decode(bits, pos, pos + ser_bits)
        if s is None or not s:
            return out
        ser_s = _uri_escape(s)
        fields.update(document_type=ref_s, serial=ser_s)
        body = f"{cp_s}.{ref_s}.{ser_s}"
    elif scheme in ("gsrn-96", "gsrnp-96"):
        # 24 trailing reserved bits must be zero (TDS 14.5.7-8).
        if _bits_to_int(bits, pos, pos + 24) != 0:
            return out
        fields.update(service_reference=ref_s)
        body = f"{cp_s}.{ref_s}"
    elif scheme == "sgcn-96":
        # Coupon serial keeps leading zeros: encoded as the digit string
        # prefixed with "1" read as an integer (TDS 14.4.5 / 14.5.10), so
        # a valid value is >= 10^len(serial) and its decimal form starts
        # with '1'.
        v = _bits_to_int(bits, pos, pos + ser_bits)
        vs = str(v)
        if v < 10 or vs[0] != "1" or len(vs) > 13:
            return out
        ser_s = vs[1:]
        fields.update(coupon_reference=ref_s, serial=ser_s)
        body = f"{cp_s}.{ref_s}.{ser_s}"
    else:  # giai-96
        fields.update(asset_reference=ref_s)
        body = f"{cp_s}.{ref_s}"
    fields["uri"] = f"urn:epc:id:{uri_id}:{body}"
    fields["tag_uri"] = f"urn:epc:tag:{scheme}:{filt}.{body}"
    return fields


def _decode_usdod(bits: List[int], as_hex: str,
                  fallback: Dict[str, object]) -> Dict[str, object]:
    """USDoD-96 (DoD Tag Data construct, TDS table 14-1 header 0x2F):
    8-bit header, 4-bit filter, 48-bit CAGE/DODAAC (six ASCII chars,
    leading space padding), 36-bit numeric serial."""
    filt = _bits_to_int(bits, 8, 12)
    chars = []
    for i in range(12, 60, 8):
        c = _bits_to_int(bits, i, i + 8)
        if c == 0x20:
            if chars:
                return fallback  # space only as leading pad
            continue
        if not (0x21 <= c <= 0x7E):
            return fallback
        chars.append(chr(c))
    cage = "".join(chars)
    if not cage:
        return fallback
    ser = _bits_to_int(bits, 60, 96)
    return {
        "scheme": "usdod-96", "hex": as_hex, "filter": filt,
        "cage": cage, "serial": ser,
        "uri": f"urn:epc:id:usdod:{cage}.{ser}",
        "tag_uri": f"urn:epc:tag:usdod-96:{filt}.{cage}.{ser}",
    }


def _decode_gid(bits: List[int], as_hex: str) -> Dict[str, object]:
    """GID-96 has no filter/partition structure (TDS 14.5.9)."""
    man = _bits_to_int(bits, 8, 36)
    cls = _bits_to_int(bits, 36, 60)
    ser = _bits_to_int(bits, 60, 96)
    return {
        "scheme": "gid-96", "hex": as_hex,
        "manager": man, "object_class": cls, "serial": ser,
        "uri": f"urn:epc:id:gid:{man}.{cls}.{ser}",
        "tag_uri": f"urn:epc:tag:gid-96:{man}.{cls}.{ser}",
    }


def _encode_keyed(header: int, filt: int, part: int, cp: int, ref: int,
                  serial) -> np.ndarray:
    scheme, total, table, ser_bits, _ = _SCHEMES[header]
    cp_bits, cp_dig, ref_bits, ref_dig = table[part]
    if cp >= 10 ** cp_dig:
        raise ValueError("company prefix too long for partition")
    if ref_dig and ref >= 10 ** ref_dig:
        raise ValueError("reference too long for partition")
    bits = (_int_to_bits(header, 8) + _int_to_bits(filt, 3)
            + _int_to_bits(part, 3) + _int_to_bits(cp, cp_bits)
            + _int_to_bits(ref, ref_bits))
    if scheme in ("sgtin-198", "gdti-174"):
        bits += _string_serial_encode(str(serial), ser_bits)
    elif scheme in ("sscc-96", "gsrn-96", "gsrnp-96"):
        bits += [0] * 24
    elif scheme == "sgcn-96":
        s = str(serial)
        if not s.isdigit() or len(s) > 12:
            raise ValueError("SGCN serial: 1-12 digits (leading zeros kept)")
        bits += _int_to_bits(int("1" + s), ser_bits)
    elif ser_bits:
        bits += _int_to_bits(int(serial), ser_bits)
    assert len(bits) == total, (len(bits), total)
    if total % 16:
        # EPC banks hold whole 16-bit words; TDS pads the last word with
        # zeros (198 -> 208 bits on tag).
        bits = bits + [0] * (16 - total % 16)
    return np.asarray(bits, np.int64)


def _cp_partition(company_prefix: str) -> int:
    """Partition value for a 6-12 digit GS1 company prefix (TDS table
    14-2 family); a length outside the table is a caller error and raises
    ValueError like the adjacent reference-length checks (not KeyError)."""
    if not 6 <= len(company_prefix) <= 12:
        raise ValueError(
            f"company prefix must be 6-12 digits, got {len(company_prefix)}")
    return 12 - len(company_prefix)


def encode_sgtin96(company_prefix: str, item_reference: str, serial: int,
                   filter_value: int = 1) -> np.ndarray:
    """SGTIN-96 EPC bits from GS1 fields.  ``company_prefix`` and
    ``item_reference`` are *strings* (leading zeros are significant; their
    lengths select the partition: cp digits + ref digits == 13)."""
    part = _cp_partition(company_prefix)
    if len(item_reference) != 13 - len(company_prefix):
        raise ValueError("company prefix + item reference must be 13 digits")
    return _encode_keyed(0x30, filter_value, part, int(company_prefix),
                         int(item_reference), serial)


def encode_sgtin198(company_prefix: str, item_reference: str, serial: str,
                    filter_value: int = 1) -> np.ndarray:
    """SGTIN-198 (alphanumeric serial, up to 20 ISO 646 chars); returns the
    13 on-tag words (208 bits, zero-padded last word)."""
    part = _cp_partition(company_prefix)
    return _encode_keyed(0x36, filter_value, part, int(company_prefix),
                         int(item_reference), serial)


def encode_sscc96(company_prefix: str, serial_reference: str,
                  filter_value: int = 0) -> np.ndarray:
    part = _cp_partition(company_prefix)
    if len(serial_reference) != 17 - len(company_prefix):
        raise ValueError("company prefix + serial reference must be 17 digits")
    return _encode_keyed(0x31, filter_value, part, int(company_prefix),
                         int(serial_reference), None)


def encode_sgln96(company_prefix: str, location_reference: str,
                  extension: int, filter_value: int = 0) -> np.ndarray:
    part = _cp_partition(company_prefix)
    if len(location_reference) != 12 - len(company_prefix):
        raise ValueError("company prefix + location ref must be 12 digits")
    return _encode_keyed(0x32, filter_value, part, int(company_prefix),
                         int(location_reference), extension)


def encode_grai96(company_prefix: str, asset_type: str, serial: int,
                  filter_value: int = 0) -> np.ndarray:
    part = _cp_partition(company_prefix)
    if len(asset_type) != 12 - len(company_prefix):
        raise ValueError("company prefix + asset type must be 12 digits")
    return _encode_keyed(0x33, filter_value, part, int(company_prefix),
                         int(asset_type), serial)


def encode_giai96(company_prefix: str, asset_reference: str,
                  filter_value: int = 0) -> np.ndarray:
    part = _cp_partition(company_prefix)
    return _encode_keyed(0x34, filter_value, part, int(company_prefix),
                         int(asset_reference), None)


def encode_gid96(manager: int, object_class: int, serial: int) -> np.ndarray:
    bits = (_int_to_bits(0x35, 8) + _int_to_bits(manager, 28)
            + _int_to_bits(object_class, 24) + _int_to_bits(serial, 36))
    return np.asarray(bits, np.int64)


def _part12(company_prefix: str, reference: str, what: str) -> int:
    part = _cp_partition(company_prefix)
    if len(reference) != 12 - len(company_prefix):
        raise ValueError(f"company prefix + {what} must be 12 digits")
    return part


def encode_gdti96(company_prefix: str, document_type: str, serial: int,
                  filter_value: int = 0) -> np.ndarray:
    part = _part12(company_prefix, document_type, "document type")
    return _encode_keyed(0x2C, filter_value, part, int(company_prefix),
                         int(document_type), serial)


def encode_gdti174(company_prefix: str, document_type: str, serial: str,
                   filter_value: int = 0) -> np.ndarray:
    """GDTI-174 (alphanumeric serial, up to 17 ISO 646 chars); returns the
    11 on-tag words (176 bits, zero-padded last word)."""
    part = _part12(company_prefix, document_type, "document type")
    return _encode_keyed(0x3E, filter_value, part, int(company_prefix),
                         int(document_type), serial)


def encode_gsrn96(company_prefix: str, service_reference: str,
                  filter_value: int = 0, provider: bool = False) -> np.ndarray:
    """GSRN-96 (recipient) / GSRNP-96 (``provider=True``)."""
    part = _cp_partition(company_prefix)
    if len(service_reference) != 17 - len(company_prefix):
        raise ValueError("company prefix + service reference must be 17 digits")
    return _encode_keyed(0x2E if provider else 0x2D, filter_value, part,
                         int(company_prefix), int(service_reference), None)


def encode_sgcn96(company_prefix: str, coupon_reference: str, serial: str,
                  filter_value: int = 0) -> np.ndarray:
    """SGCN-96: ``serial`` is a digit *string* — leading zeros are part of
    the coupon identity and survive the round trip."""
    part = _part12(company_prefix, coupon_reference, "coupon reference")
    return _encode_keyed(0x3F, filter_value, part, int(company_prefix),
                         int(coupon_reference), serial)


def encode_usdod96(cage: str, serial: int,
                   filter_value: int = 0) -> np.ndarray:
    """USDoD-96: 5/6-char CAGE or DODAAC, space-padded on the left."""
    if not (1 <= len(cage) <= 6):
        raise ValueError("CAGE/DODAAC is 1-6 characters")
    padded = cage.rjust(6)
    bits = _int_to_bits(0x2F, 8) + _int_to_bits(filter_value, 4)
    for ch in padded:
        c = ord(ch)
        if ch != " " and not (0x21 <= c <= 0x7E):
            raise ValueError(f"character {ch!r} outside ASCII subset")
        bits += _int_to_bits(c, 8)
    bits += _int_to_bits(serial, 36)
    return np.asarray(bits, np.int64)
