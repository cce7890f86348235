"""The one per-tensor wire codec: zlib-when-smaller payloads with a
bounded, bomb-proof inflate.

A copy of `netobserv_tpu/utils/tensorcodec.py`. The federation delta frame
(`federation/delta.py`) ships its table tensors through it, so the port's
frames carry the reference's tensor bytes. Tensor payloads are always
little-endian (explicit ``<`` numpy dtypes) regardless of host order; the
dtype-code table below is part of the wire format and may only grow,
never renumber.
"""

from __future__ import annotations

import zlib

import numpy as np

CODEC_RAW = 0
CODEC_ZLIB = 1

#: wire dtype codes (the delta frame's and the archive segment's)
DTYPE_TO_CODE = {"<f4": 1, "<i4": 2, "<u4": 3}
CODE_TO_DTYPE = {v: k for k, v in DTYPE_TO_CODE.items()}

#: hard per-tensor size ceiling (decoded bytes). Production tables top out
#: around cm_depth*cm_width*4 ≈ 1 MiB; this bounds what a hostile/corrupt
#: payload can make a decoder allocate BEFORE any shape validation — both
#: via a declared-huge shape and via a zlib bomb (decompression is capped
#: at the declared size, never "whatever the stream inflates to").
MAX_TENSOR_BYTES = 1 << 27  # 128 MiB


class TensorCodecError(ValueError):
    """Malformed tensor payload (decode-time validation failure); the
    delta codec re-raises it as its own frame error type."""


def declared_nbytes(name: str, shape: tuple, dtype: str) -> int:
    """Byte size a declared (shape, dtype) wants, validated against the
    MAX_TENSOR_BYTES cap (negative/overflowing shapes reject too)."""
    n_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
    expected = n_elems * np.dtype(dtype).itemsize
    if not 0 <= expected <= MAX_TENSOR_BYTES:
        raise TensorCodecError(
            f"tensor {name!r}: declared shape {tuple(shape)} wants "
            f"{expected} bytes (cap {MAX_TENSOR_BYTES})")
    return expected


def encode_payload(raw: bytes, codec: int) -> tuple[int, bytes]:
    """Encode one tensor's raw little-endian bytes under `codec`.

    ``CODEC_ZLIB`` deflates but keeps RAW whenever deflate does not shrink
    the payload (the returned codec code records which actually shipped —
    the "zlib-when-smaller" rule both wire formats pin)."""
    if codec == CODEC_ZLIB:
        packed = zlib.compress(raw, 1)
        if len(packed) < len(raw):
            return CODEC_ZLIB, packed
        return CODEC_RAW, raw
    if codec == CODEC_RAW:
        return CODEC_RAW, raw
    raise TensorCodecError(f"unknown codec {codec}")


def decode_payload(name: str, codec: int, data: bytes,
                   expected: int) -> bytes:
    """Decode one tensor payload back to exactly `expected` raw bytes.

    The zlib path is a BOUNDED inflate: it never allocates past the
    declared size, and the stream must end exactly there (bomb/corruption
    guard). RAW payloads must match the declared size exactly."""
    if codec == CODEC_ZLIB:
        d = zlib.decompressobj()
        try:
            raw = d.decompress(data, expected)
        except zlib.error as exc:
            raise TensorCodecError(
                f"tensor {name!r}: bad zlib stream: {exc}") from exc
        if len(raw) != expected or not d.eof or d.unconsumed_tail:
            raise TensorCodecError(
                f"tensor {name!r}: zlib payload inflates to "
                f"{len(raw)}B (eof={d.eof}), declared {expected}B")
        return raw
    if codec == CODEC_RAW:
        if len(data) != expected:
            raise TensorCodecError(
                f"tensor {name!r}: payload is {len(data)}B, declared "
                f"{expected}B")
        return data
    raise TensorCodecError(f"tensor {name!r}: unknown codec {codec}")
