"""Bytes that one launch of a graph kernel of the program needs, and the
peak they are held against.

A kernel's roofline share is the least time its launches could take,
these bytes over the card's memory rate, over the device time the trace
gives them. The counts are lower bounds of what the inputs of a launch
need, each input byte read once, whatever the kernel reads again. For
``msbfs_extend`` (one MS-BFS extension over the 0/1 block tiles): the
tiles under a source stripe that holds a frontier bit (B x B int8 each,
with their two int32 coordinates), and the frontier words it tests,
``g_in x B x ceil(L / 64)`` uint64. The output words are left out: which
of them a launch writes depends on what it reaches.

Graph operations are byte-bound by orders of magnitude (one compare per
byte read), so only bytes set the bound.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
WORD_LANES = 64


def extend_bytes(active_tiles: int, tile: int, g_in: int,
                 lanes: int) -> int:
    """Bytes one ``msbfs_extend`` launch needs (module docstring)."""
    words = -(-int(lanes) // WORD_LANES)
    return (int(active_tiles) * (tile * tile + 8)
            + int(g_in) * tile * words * 8)


def roofline_share(total_bytes: float, device_s: float) -> float | None:
    """Least time over device time, in percent (None without launches)."""
    if device_s <= 0 or total_bytes <= 0:
        return None
    return 100.0 * (total_bytes / HBM_BYTES_PER_S) / device_s
