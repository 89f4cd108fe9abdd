"""Physical-address units shared by the counters and MAC bindings.

Addresses are in units of 16 B segments, so a PA advances by
``block_bytes // 16`` between consecutive wide blocks.
"""

SEGMENT_BYTES = 16

__all__ = ["SEGMENT_BYTES"]
