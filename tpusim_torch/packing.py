"""Packed int64 ordering keys shared by the device reductions and their
numpy mirrors: the analytics top-k (scan.analytics_reduce and
obs.analytics.host_reduce) and the gang packer's rank key (scan.gang_select
and its oracle gang.oracle.select_oracle).

One definition keeps each device reduction bit-equal to its mirror: the same
source line evaluates over numpy arrays and torch tensors alike (shifts,
masks, a clip and a multiply by the 0/1 mask). An invalid lane encodes as
-1, strictly below every valid key (valid keys are nonnegative), so a
first-occurrence argmax or a descending top-k over the keys never picks one
while a valid lane is left.

Top-k keys are unique per index, and a HIGHER key means a better score,
then a LOWER index: a descending top-k of the keys equals a stable
descending sort over (score, first occurrence).
"""

from __future__ import annotations

# score in the high bits; the low TIE_BITS hold the inverted index, so
# node counts stay below 2^TIE_BITS
TIE_BITS = 32
TIE_MASK = (1 << TIE_BITS) - 1

# Rank-key layout: zone-mate count, then rack-mate count, then the clipped
# scan score; a first-occurrence argmax resolves the remaining ties.
GANG_ZONE_SHIFT = 52
GANG_RACK_SHIFT = 32
GANG_SCORE_MASK = (1 << 32) - 1


def encode_topk_keys(score, index, valid):
    """(score << TIE_BITS) | (TIE_MASK - index) where `valid`, else -1:
    int64 numpy arrays or torch tensors alike (`score` in [0, 2^31),
    `index` in [0, TIE_MASK], `valid` bool)."""
    key = (score << TIE_BITS) | (TIE_MASK - index)
    return valid * key - ~valid * 1


def decode_topk_key(key):
    """Inverse of `encode_topk_keys` for a valid key: (score, index)."""
    return key >> TIE_BITS, TIE_MASK - (key & TIE_MASK)


def encode_gang_rank(zone_bonus, rack_bonus, score, ok):
    """(zone mates << 52) + (rack mates << 32) + clip(score, 0, 2^32 - 1)
    where `ok`, else -1: int64 numpy arrays or torch tensors alike (the
    bonuses small nonnegative counts, < 2^11 zone and < 2^20 rack; `ok`
    bool)."""
    rank = ((zone_bonus << GANG_ZONE_SHIFT) + (rack_bonus << GANG_RACK_SHIFT)
            + score.clip(0, GANG_SCORE_MASK))
    return ok * rank - ~ok * 1
