"""DNS wire-format qname decoding, a copy of `netobserv_tpu/utils/dnsnames.py`
(lines 1-26). The datapath copies the raw length-prefixed label sequence;
the host renders it dotted."""

from __future__ import annotations


def decode_qname(raw: bytes) -> str:
    """Decode a (possibly truncated) DNS qname into dotted form.

    Compression pointers (0xC0) terminate decoding — the tail lives elsewhere
    in the original packet, which we no longer have."""
    labels = []
    i = 0
    while i < len(raw):
        n = raw[i]
        if n == 0:
            break
        if n & 0xC0:
            break  # compression pointer or malformed
        label = raw[i + 1:i + 1 + n]
        if not label:
            break
        labels.append(label.decode("ascii", "replace"))
        i += 1 + n
    return ".".join(labels)
