"""Carry fleet state across from the JAX package's host arrays.

The system has no weights; its state is the fleet.  ``fleet_from_numpy``
turns the numpy leaves of the reference's host ``FleetState`` (as
``repro.core.bulk.FleetState.pack`` builds them: a ``(1, W')`` uint32 mask
and a ``(1, C')`` int32 table, both padded to 128 lanes, and a ``(2,)``
uint32 state) into this package's host ``FleetState``.  Only numpy crosses
over; nothing of the JAX package is imported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bulk import FleetState
from repro_torch.core.memento_torch import mask_words, table_width


def fleet_from_numpy(packed, table, state, capacity: int) -> FleetState:
    """Reference host fleet leaves -> host ``FleetState`` for ``capacity``
    (lane padding dropped; ``.to(device)`` makes the device twin)."""
    packed = np.asarray(packed, dtype=np.uint32).reshape(-1)
    table = np.asarray(table, dtype=np.int32).reshape(-1)
    state = np.asarray(state, dtype=np.uint32).reshape(-1)
    words, slots = mask_words(capacity), table_width(capacity)
    if packed.size < words or table.size < slots or state.size != 2:
        raise ValueError(
            f"fleet arrays too small for capacity {capacity}: mask "
            f"{packed.size} words (< {words}?), table {table.size} slots "
            f"(< {slots}?), state {state.size} (!= 2?)"
        )
    if packed[words:].any():
        raise ValueError(f"removed bits set past capacity {capacity}")
    return FleetState(
        packed=packed[:words].copy(), table=table[:slots].copy(),
        state=state.copy(), capacity=capacity,
    )
