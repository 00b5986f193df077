"""The gang packer's int64 rank key, shared by the device solve
(scan.gang_select) and its numpy oracle (gang.oracle.select_oracle).

One definition keeps the two bit-equal: the same source line evaluates over
numpy arrays and torch tensors alike (shifts, a clip and a multiply by the
0/1 mask). An infeasible node encodes as -1, strictly below every valid key
(valid keys are nonnegative), so a first-occurrence argmax over the keys
never picks one unless no node is valid.
"""

from __future__ import annotations

# Rank-key layout: zone-mate count, then rack-mate count, then the clipped
# scan score; a first-occurrence argmax resolves the remaining ties.
GANG_ZONE_SHIFT = 52
GANG_RACK_SHIFT = 32
GANG_SCORE_MASK = (1 << 32) - 1


def encode_gang_rank(zone_bonus, rack_bonus, score, ok):
    """(zone mates << 52) + (rack mates << 32) + clip(score, 0, 2^32 - 1)
    where `ok`, else -1: int64 numpy arrays or torch tensors alike (the
    bonuses small nonnegative counts, < 2^11 zone and < 2^20 rack; `ok`
    bool)."""
    rank = ((zone_bonus << GANG_ZONE_SHIFT) + (rack_bonus << GANG_RACK_SHIFT)
            + score.clip(0, GANG_SCORE_MASK))
    return ok * rank - ~ok * 1
