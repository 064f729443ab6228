"""Fixed-shape locality state of the micro layer (Eq 10 history), port of
``repro/core/micro_state.py``'s data layout.

The port carries the rings on the device (``micro_torch.DeviceRings``);
``LocalityState`` is the host form one region's rings are exported to,
field for field the reference's, so the two can be compared:

  mids    (S, keep)     int32   model id per history entry, EMPTY pad
  slots   (S, keep)     int32   slot the entry was noted at
  embeds  (S, keep, E)  float32 input embedding (zero row = no embedding)
  norms   (S, keep)     float32 L2 norm of the embedding (0 = none)
  uid     (S, keep)     int64   per-entry id (synthesized on export)
  count   (S,)          int32   valid entries per server

Rows are newest-first (index 0 is the most recent entry).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# unused ring slots; distinct from NO_MODEL (-1), which is a legal noted id
EMPTY = -2


@dataclasses.dataclass
class LocalityState:
    """Per-region recent-task history as fixed-shape arrays."""

    mids: np.ndarray
    slots: np.ndarray
    embeds: np.ndarray
    norms: np.ndarray
    uid: np.ndarray
    count: np.ndarray
