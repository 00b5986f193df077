"""The streaming twin's placement chain fold. The WAL, checkpoints and
recovery are not ported yet."""

from __future__ import annotations

import hashlib


def chain_fold(prev_hex: str, placement_hex: str) -> str:
    """One step of the resumable placement chain: unlike a running sha256,
    the fold state is itself a hex digest, so a checkpoint can carry it and
    a recovered session can go on folding where the dead one stopped."""
    return hashlib.sha256((prev_hex + placement_hex).encode()).hexdigest()
