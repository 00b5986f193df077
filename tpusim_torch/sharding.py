"""Padding a scenario's node axis, the single-device part of node sharding.

A what-if batch stacks scenarios of different node counts, so each is padded
to the common count with nodes that can never be chosen: bit 62 of their
condition bits fails the condition stage, and the reason histogram decodes
only the bits below the reason width, so a padded node shows in no FitError
text (count mode masks it out, scan._evaluate). The node-sharded route over
several cards grows this module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpusim_torch.scan import (
    CARRY_AXES,
    PAD_FILLS,
    PAD_SENTINEL,
    STATICS_AXES,
    Carry,
    Statics,
)


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pad_node_tree(tree, axes_map, pad: int):
    """`tree` (host numpy arrays) with `pad` nodes appended on every node
    axis: condition bits the sentinel, every other field its PAD_FILLS
    value (0)."""
    fields = {}
    for name, arr in tree._asdict().items():
        spec = axes_map[name]
        arr = np.asarray(arr)
        if "node" not in spec:
            fields[name] = arr
            continue
        if name == "cond_fail_bits":
            fields[name] = np.concatenate(
                [arr, np.full(pad, PAD_SENTINEL, dtype=np.int64)])
            continue
        widths = [(0, 0)] * arr.ndim
        widths[spec.index("node")] = (0, pad)
        fields[name] = np.pad(arr, widths,
                              constant_values=PAD_FILLS.get(name, 0))
    return type(tree)(**fields)


def pad_node_axis(statics: Statics, carry: Carry, n_shards: int
                  ) -> Tuple[Statics, Carry, int]:
    """Pad the node axis of host trees up to a multiple of `n_shards` (the
    what-if unifier passes the batch's node count, so every scenario pads
    to it). Returns the padded trees and the real node count."""
    n = np.asarray(statics.alloc_cpu).shape[0]
    pad = _pad_to(n, n_shards) - n
    if pad == 0:
        return statics, carry, n
    return (_pad_node_tree(statics, STATICS_AXES, pad),
            _pad_node_tree(carry, CARRY_AXES, pad), n)
