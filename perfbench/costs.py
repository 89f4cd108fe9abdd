"""The yardstick: the card's published peaks and the work a cell requires.

Every count here is computed from a configuration file's numbers and the
shapes a tick or a step used, never from what the program allocates or
launches, so it reads the same work whatever implements it.  The counts
that depend on an architecture (model FLOPs, the bytes of a KV page) are
its family's, in ``perfbench/families/``; what is here holds for all.

Peaks (NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit):

* ``BF16_FLOPS`` 989e12: the tensor-core bf16 rate, the denominator of
  every ``mfu`` metric;
* ``HBM_BYTES_PER_S`` 3.35e12;
* ``INT_OPS_PER_S`` 67e12: the data sheet gives no 32-bit integer rate,
  so the float32 rate outside the tensor cores stands in for it.  This
  is an assumed peak, named as such wherever a share is reported
  against it.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

# One AES-128 block evaluation (16 bytes of keystream): 9 rounds of 16
# bytes x 7 operations, the last round's 16 x 2, the first AddRoundKey's
# 16.
AES_OPS = 1056
SEGMENT_BYTES = 16
PAGE_MAC_BYTES = 8


def bound_s(nbytes: float, ops: float) -> tuple:
    """``(seconds, "bytes" | "operations")``: the least time the card
    takes to move ``nbytes`` through HBM and do ``ops`` integer
    operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def crossing_ops(nbytes: float, block_bytes: int) -> float:
    """SeDA's integer work over ``nbytes`` of one crossing: per
    protection block one AES evaluation for the B-AES base pad and one
    for the MAC finalizer, the segment XORs and the NH pairs."""
    segments = block_bytes // SEGMENT_BYTES
    blocks = nbytes / block_bytes
    return blocks * (2 * AES_OPS + 16 * segments + 16)


def page_crossing_work(page: int, block_bytes: int, pages_read: int,
                       pages_written: int) -> tuple:
    """``(bytes, ops)`` a tick's crossings require: the ciphertext
    (``page`` bytes a page, the family's ``page_bytes``) and page MACs
    of the pages read and of the pages written."""
    pages = pages_read + pages_written
    nbytes = pages * (page + PAGE_MAC_BYTES)
    return nbytes, crossing_ops(pages * page, block_bytes)


def adamw_bytes(n_params: int, param_bytes: int, grad_bytes: int,
                moment_bytes: int) -> int:
    """Each parameter, gradient and both moments read once; each
    parameter and both moments written once."""
    return n_params * (2 * param_bytes + grad_bytes + 4 * moment_bytes)


def weights_crossing_work(plain_bytes: int, block_bytes: int) -> tuple:
    """``(bytes, ops)`` of one unprotect and one protect of the weights:
    ciphertext in and plaintext out, plaintext in and ciphertext out,
    and the crossing operations each way.  The block MACs fold into one
    tag per layer on the chip, so no tag traffic is counted."""
    return 4 * plain_bytes, 2 * crossing_ops(plain_bytes, block_bytes)
