"""TLS metadata decoding (reference analog: `pkg/model/tls_types.go`).

A copy of `netobserv_tpu/model/tls_types.py` (lines 1-66)."""

from __future__ import annotations

# TLS record-type bits set by the passive TLS tracker (one bit per content type
# seen on the connection).
TLS_TYPE_CHANGE_CIPHER_SPEC = 0x01
TLS_TYPE_ALERT = 0x02
TLS_TYPE_HANDSHAKE = 0x04
TLS_TYPE_APPLICATION_DATA = 0x08
TLS_TYPE_HEARTBEAT = 0x10

_VERSION_NAMES = {
    0x0300: "SSLv3",
    0x0301: "TLS1.0",
    0x0302: "TLS1.1",
    0x0303: "TLS1.2",
    0x0304: "TLS1.3",
}

# a small subset of IANA cipher-suite names; unknown suites render as hex
_CIPHER_NAMES = {
    0x1301: "TLS_AES_128_GCM_SHA256",
    0x1302: "TLS_AES_256_GCM_SHA384",
    0x1303: "TLS_CHACHA20_POLY1305_SHA256",
    0xC02B: "TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256",
    0xC02C: "TLS_ECDHE_ECDSA_WITH_AES_256_GCM_SHA384",
    0xC02F: "TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256",
    0xC030: "TLS_ECDHE_RSA_WITH_AES_256_GCM_SHA384",
}

_GROUP_NAMES = {
    0x0017: "secp256r1",
    0x0018: "secp384r1",
    0x0019: "secp521r1",
    0x001D: "x25519",
    0x001E: "x448",
    0x0100: "ffdhe2048",
    0x11EC: "X25519MLKEM768",
}


def tls_version_name(version: int) -> str:
    return _VERSION_NAMES.get(version, f"0x{version:04x}" if version else "")


def cipher_suite_name(suite: int) -> str:
    return _CIPHER_NAMES.get(suite, f"0x{suite:04x}" if suite else "")


def key_share_name(group: int) -> str:
    return _GROUP_NAMES.get(group, f"0x{group:04x}" if group else "")


def tls_types_names(bits: int) -> list[str]:
    names = []
    for bit, name in (
        (TLS_TYPE_CHANGE_CIPHER_SPEC, "ChangeCipherSpec"),
        (TLS_TYPE_ALERT, "Alert"),
        (TLS_TYPE_HANDSHAKE, "Handshake"),
        (TLS_TYPE_APPLICATION_DATA, "ApplicationData"),
        (TLS_TYPE_HEARTBEAT, "Heartbeat"),
    ):
        if bits & bit:
            names.append(name)
    return names
