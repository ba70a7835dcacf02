"""D3MH member framing: a host copy of the part of
``dct3d_tpu.parallel.multihost`` that the turbo profile needs
(tests/test_torch_host.py pins it to the original).

A container is a sequence of members, each a 16-byte header (magic, then
uint32 LE ``(member type << 24) | frame count``, then uint64 LE payload
length) and its payload.  The member type lets decode route each member;
decoders skip types they do not know.
"""

from __future__ import annotations

import struct

MEMBER_MAGIC = b"D3MH"

MEMBER_TEMPORAL = 0
MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE = 1, 2, 3
#: seekable index of the preceding stream member (not read by the port yet)
MEMBER_INDEX = 4
_MAX_MEMBER_FRAMES = (1 << 24) - 1


def _member(payload: bytes, frames: int, mtype: int = MEMBER_TEMPORAL) -> bytes:
    if frames > _MAX_MEMBER_FRAMES:
        raise ValueError(f"member frame count {frames} exceeds 2^24-1")
    return (
        MEMBER_MAGIC
        + struct.pack("<IQ", (mtype << 24) | frames, len(payload))
        + payload
    )


def split_members(data: bytes) -> list[tuple[int, bytes, int]]:
    """Parse a container into [(frame_count, payload, member_type), ...]."""
    out = []
    pos = 0
    while pos < len(data):
        if data[pos : pos + 4] != MEMBER_MAGIC:
            raise ValueError("not a multi-host container (missing D3MH magic)")
        tagged, length = struct.unpack_from("<IQ", data, pos + 4)
        pos += 16
        out.append((tagged & _MAX_MEMBER_FRAMES, data[pos : pos + length],
                    tagged >> 24))
        pos += length
    return out
