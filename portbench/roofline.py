"""The yardstick of the rooflines: the card's peaks and the bytes that a
chunk's work needs.

A roofline share is the least time the card could take for the work,
the bytes it needs over the card's memory bandwidth, divided by the
device time of every operation that the traced chunks ran, whatever its
name.  The bytes count each input byte read once and each output byte
written once, from the cell's sizes and from counts of what the chunk
did (replicas whose best tree improved, moves applied, reslices), so
that the count does not depend on how the program implements the work.
The work moves words and does little arithmetic, so bandwidth bounds it.
"""

__all__ = ['HBM_BYTES_PER_S', 'hbm_bytes_per_s', 'im_chunk_bytes',
           'fw_chunk_bytes']

# Published memory bandwidth by the name ``torch.cuda.get_device_name``
# gives (NVIDIA's data sheet, SXM part, at its full power limit).
HBM_BYTES_PER_S = {
    'NVIDIA H100 80GB HBM3': 3.35e12,
}

_WORD = 4            # int32 and float32
_DRAW_BYTES = 12     # a proposal's leaf, side bit and uniform, a word each


def hbm_bytes_per_s(device_name: str):
    """The card's published bandwidth, or None for a card not listed."""
    return HBM_BYTES_PER_S.get(device_name)


def im_chunk_bytes(b: int, n: int, w: int, p: int, k: int,
                   improved: int) -> int:
    """Bytes an infinite-memory chunk of ``k`` iterations of ``p`` walks
    on ``b`` replicas of ``n`` nodes and ``w`` index words needs: every
    replica's state (children, parent, log2 cost and the index words of
    each node) read and written once, the best tree (children, parent,
    index words) of each of the ``improved`` replicas written once, the
    draws of every proposal and the ``k`` betas read once."""
    state = 2 * b * n * (4 + w) * _WORD
    best = improved * n * (3 + w) * _WORD
    return state + best + k * p * b * _DRAW_BYTES + k * _WORD


def fw_chunk_bytes(b: int, n: int, w: int, p: int, k: int, applied: int,
                   reslices: int) -> int:
    """Bytes a finite-width chunk of ``k`` iterations of ``p`` walks on
    ``b`` replicas needs: each proposal reads the rows (children, parent,
    log2 cost, width and index words) of the five nodes of an uncle swap
    and its draws; each of the ``applied`` moves writes two rows; each of
    the ``reslices`` reslice steps reads every replica's index words,
    writes its slice words and its nodes' log2 costs, and reads a jitter
    word per index bit."""
    row = (5 + w) * _WORD
    proposals = k * p * b
    walks = proposals * (5 * row + _DRAW_BYTES) + applied * 2 * row
    reslice = reslices * b * (n * w * _WORD + w * _WORD + n * _WORD +
                              32 * w * _WORD)
    return walks + reslice + k * _WORD
