"""Device-side ops: pair table, packing, and the merge kernels.

The execution model (SURVEY.md §7): semantics on the host (regex
pre-split, UTF-8, specials, trims), arithmetic on the device.  Pieces
are packed column-major into ``[L, B]`` int32 tiles (minor dimension =
batch, so ops vectorize across pieces) and the tiktoken merge loop runs as
a vectorized kernel against an exact (left_id, right_id) -> merged_id
hash table.
"""

from .pair_table import PairTable
from .packing import PackedBatch, pack_pieces

__all__ = ["PairTable", "PackedBatch", "pack_pieces"]
