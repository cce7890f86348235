"""The packed flow-key word layout.

Counterpart of `netobserv_tpu/model/columnar.py` (`KEY_WORDS`,
`pack_key_words`, `unpack_key_words`), kept as numpy copies; the key's
dtype is `model/binfmt.FLOW_KEY_DTYPE`. A 40-byte flow key packs into
KEY_WORDS little-endian uint32 words: 4 src-address words, 4 dst-address
words, a ports word (src << 16 | dst) and a proto word (proto << 16 |
icmp_type << 8 | icmp_code).
"""

from __future__ import annotations

import numpy as np

from netobserv_tpu_torch.model.binfmt import FLOW_KEY_DTYPE

KEY_WORDS = 10


def pack_key_words(key_arr: np.ndarray) -> np.ndarray:
    """Pack a structured FLOW_KEY array (N,) into uint32 words (N, KEY_WORDS)."""
    n = len(key_arr)
    out = np.zeros((n, KEY_WORDS), dtype=np.uint32)
    if n == 0:
        return out
    out[:, 0:4] = np.ascontiguousarray(key_arr["src_ip"]).view(
        np.uint32).reshape(n, 4)
    out[:, 4:8] = np.ascontiguousarray(key_arr["dst_ip"]).view(
        np.uint32).reshape(n, 4)
    out[:, 8] = (key_arr["src_port"].astype(np.uint32) << np.uint32(16)) | \
        key_arr["dst_port"].astype(np.uint32)
    out[:, 9] = (key_arr["proto"].astype(np.uint32) << np.uint32(16)) | \
        (key_arr["icmp_type"].astype(np.uint32) << np.uint32(8)) | \
        key_arr["icmp_code"].astype(np.uint32)
    return out


def unpack_key_words(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_key_words — back to a structured FLOW_KEY array."""
    words = np.asarray(words, dtype=np.uint32)
    n = len(words)
    out = np.zeros(n, dtype=FLOW_KEY_DTYPE)
    if n == 0:
        return out
    out["src_ip"] = np.ascontiguousarray(words[:, 0:4]).view(
        np.uint8).reshape(n, 16)
    out["dst_ip"] = np.ascontiguousarray(words[:, 4:8]).view(
        np.uint8).reshape(n, 16)
    out["src_port"] = (words[:, 8] >> np.uint32(16)).astype(np.uint16)
    out["dst_port"] = (words[:, 8] & np.uint32(0xFFFF)).astype(np.uint16)
    out["proto"] = ((words[:, 9] >> np.uint32(16))
                    & np.uint32(0xFF)).astype(np.uint8)
    out["icmp_type"] = ((words[:, 9] >> np.uint32(8))
                        & np.uint32(0xFF)).astype(np.uint8)
    out["icmp_code"] = (words[:, 9] & np.uint32(0xFF)).astype(np.uint8)
    return out
