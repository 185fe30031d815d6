"""Edge-list generators, one module a ``generator`` named in a
configuration file:

- ``edges(config, seed, device) -> (src, dst)``: every tuple at once, on
  the device, for a cell on one card;
- ``edge_chunks(config, seed, device)``: an iterator of ``(src, dst)``
  chunks, the same on every rank that calls it with the same seed, for a
  cell across cards, whose ranks stream the tuples into the port's
  multi-card ingest and into the split reference. The chunks of one seed
  are not ``edges``' tuples: a configuration's graph is drawn one way or
  the other.
"""

import hashlib

CHUNK_TUPLES = 1 << 26  # tuples a chunk: 0.5 GiB of int32 ids a chunk and side at most


def chunk_seed(seed: int, k: int) -> int:
    """The seed of chunk ``k`` of ``seed``'s stream, in [0, 2^63)."""
    digest = hashlib.sha256(f"{seed}:chunk:{k}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def chunk_sizes(total: int) -> list:
    """The tuples of each chunk: ``CHUNK_TUPLES`` each, the rest in the
    last."""
    return [min(CHUNK_TUPLES, total - lo) for lo in range(0, total, CHUNK_TUPLES)]
