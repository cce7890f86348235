"""OVN network-event cookie decoding.

Reference analog: `pkg/utils/networkevents/network_events.go` — the psample
user cookie carries an OVN observability sample (version, action, and the
sampled object's attributes); decoded here into the map shape the FLP
ecosystem expects. Layout (OVN observability samples v1):

    byte 0: version (1)
    byte 1: action (0 allow, 1 drop, 2 pass, 3 redirect)
    byte 2: actor type (0 acl, 1 nat, ...)
    byte 3: direction (0 ingress / 1 egress) + flags
    bytes 4..7: object id (little-endian u32)

A copy of `netobserv_tpu/utils/networkevents.py` (lines 1-41).
"""

from __future__ import annotations

ACTIONS = {0: "allow", 1: "drop", 2: "pass", 3: "redirect"}
ACTOR_TYPES = {0: "acl", 1: "nat", 2: "lb"}
DIRECTIONS = {0: "ingress", 1: "egress"}


def decode_cookie(cookie: bytes) -> dict:
    """Decode one network-event cookie into a string map; unknown layouts are
    surfaced raw so nothing is silently dropped."""
    if len(cookie) < 8 or cookie[0] != 1:
        return {"raw": cookie.hex()}
    action = cookie[1]
    actor = cookie[2]
    direction = cookie[3] & 0x01
    obj_id = int.from_bytes(cookie[4:8], "little")
    return {
        "Feature": "acl",  # FLP consumers match on this key
        "Action": ACTIONS.get(action, str(action)),
        "Type": ACTOR_TYPES.get(actor, str(actor)),
        "Direction": DIRECTIONS.get(direction, str(direction)),
        "Name": str(obj_id),
    }


def is_drop_event(cookie: bytes) -> bool:
    return len(cookie) >= 8 and cookie[0] == 1 and cookie[1] == 1
