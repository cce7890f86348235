"""Small network formatting helpers (reference analog: `pkg/utils/utils.go`).

A copy of `netobserv_tpu/utils/net.py` (lines 1-17)."""

from __future__ import annotations

from netobserv_tpu_torch.model.flow import ip_from_16


def format_addr_port(raw16: bytes, port: int) -> str:
    """Render a 16-byte address + port: v4 as a.b.c.d:p, v6 as [..]:p."""
    addr = ip_from_16(raw16)
    if ":" in addr:
        return f"[{addr}]:{port}"
    return f"{addr}:{port}"


def format_mac(raw: bytes) -> str:
    return ":".join(f"{b:02X}" for b in raw[:6])
