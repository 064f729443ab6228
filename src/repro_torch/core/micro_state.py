"""Fixed-shape locality state of the micro layer (Eq 10 history), port of
``repro/core/micro_state.py``'s data layout.

The fused route carries the rings of all regions on the device
(``micro_torch.DeviceRings``) and exports one region's rings to this host
form.  The per-region routes (``MicroAllocator(backend="numpy"|"pallas"|
"jax")``) keep each region's rings here, as the reference does: the host
walk pushes entries with :meth:`LocalityState.note` and scores them with
:meth:`LocalityState.column`, and the ``jax`` route uploads them to the
greedy kernel and writes them back.  Field for field the reference's:

  mids    (S, keep)     int32   model id per history entry, EMPTY pad
  slots   (S, keep)     int32   slot the entry was noted at
  embeds  (S, keep, E)  float32 input embedding (zero row = no embedding)
  norms   (S, keep)     float32 L2 norm of the embedding (0 = none)
  uid     (S, keep)     int64   per-entry id (the key of ``column``'s
                                per-slot contribution cache)
  count   (S,)          int32   valid entries per server

Rows are newest-first (index 0 is the most recent entry), so ``column``
sums the entries in the reference's order and its results are bitwise
the reference's.  Ring slots beyond ``count`` hold ``EMPTY`` / zeros.
``from_tracker`` / ``to_tracker`` convert exactly to and from the scalar
``LocalityTracker`` (``core/micro.py``), the history of the frozen
per-object oracle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

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

    @property
    def n_servers(self) -> int:
        return self.mids.shape[0]

    @property
    def keep(self) -> int:
        return self.mids.shape[1]

    @property
    def embed_dim(self) -> int:
        return self.embeds.shape[2]

    @classmethod
    def empty(cls, n_servers: int, keep: int = 4,
              embed_dim: int = 8) -> "LocalityState":
        return cls(
            mids=np.full((n_servers, keep), EMPTY, np.int32),
            slots=np.zeros((n_servers, keep), np.int32),
            embeds=np.zeros((n_servers, keep, embed_dim), np.float32),
            norms=np.zeros((n_servers, keep), np.float32),
            uid=np.zeros((n_servers, keep), np.int64),
            count=np.zeros(n_servers, np.int32))

    def grown(self, embed_dim: int) -> "LocalityState":
        """Same history, embedding channel zero-padded to ``embed_dim``
        (the dot products of existing entries are unchanged)."""
        if embed_dim <= self.embed_dim:
            return self
        emb = np.zeros((self.n_servers, self.keep, embed_dim), np.float32)
        emb[:, :, :self.embed_dim] = self.embeds
        return dataclasses.replace(self, embeds=emb)

    def note(self, s: int, mid: int, embed: Optional[np.ndarray],
             t: int, uid: int) -> None:
        """Push one entry at the head of server ``s``'s ring.  The norm is
        the embedding row's own ``np.linalg.norm``; ``embed=None`` stores a
        zero row and a zero norm."""
        self.mids[s, 1:] = self.mids[s, :-1]
        self.slots[s, 1:] = self.slots[s, :-1]
        self.embeds[s, 1:] = self.embeds[s, :-1]
        self.norms[s, 1:] = self.norms[s, :-1]
        self.uid[s, 1:] = self.uid[s, :-1]
        self.mids[s, 0] = mid
        self.slots[s, 0] = t
        if embed is not None:
            self.embeds[s, 0, :len(embed)] = embed
            self.embeds[s, 0, len(embed):] = 0.0
            self.norms[s, 0] = np.linalg.norm(embed)
        else:
            self.embeds[s, 0] = 0.0
            self.norms[s, 0] = 0.0
        self.uid[s, 0] = uid
        self.count[s] = min(int(self.count[s]) + 1, self.keep)

    def column(self, s: int, mids: np.ndarray, embeds: np.ndarray,
               norms: np.ndarray, has_embed: np.ndarray, t: int,
               cache: Optional[dict] = None) -> np.ndarray:
        """(N,) float64 Eq-10 locality of every task against server
        ``s``'s ring, entries summed newest first.  ``cache`` memoizes each
        entry's contribution vector within one slot, keyed by its
        ``uid``."""
        from repro_torch.core.micro import LOC_DECAY, W_EMBED, W_MODEL
        n = len(mids)
        c = int(self.count[s])
        if c == 0:
            return np.zeros(n)
        col = np.zeros(n)
        for k in range(c):
            key = int(self.uid[s, k])
            contrib = cache.get(key) if cache is not None else None
            if contrib is None:
                sim = W_MODEL * (mids == self.mids[s, k]).astype(np.float64)
                if self.norms[s, k] > 0.0 and has_embed.any():
                    denom = norms * self.norms[s, k]
                    ok = has_embed & (denom > 1e-9)
                    dots = embeds @ self.embeds[s, k, :embeds.shape[1]]
                    safe = np.where(ok, denom, 1.0)
                    sim = sim + np.where(
                        ok, W_EMBED * dots.astype(np.float64) / safe, 0.0)
                contrib = sim / math.exp(
                    LOC_DECAY * min(max(t - int(self.slots[s, k]), 0), 40))
                if cache is not None:
                    cache[key] = contrib
            col += contrib
        return col

    @classmethod
    def from_tracker(cls, tracker, ridx: int, n_servers: int,
                     embed_dim: int = 8) -> "LocalityState":
        """One region's history imported from a ``LocalityTracker`` (its
        newest-first lists become the rings, uids kept)."""
        keep = tracker.keep
        edim = embed_dim
        for (r, _s), lst in tracker.recent.items():
            if r != ridx:
                continue
            for rt in lst:
                if rt.embed is not None:
                    edim = max(edim, rt.embed.shape[0])
        st = cls.empty(n_servers, keep, edim)
        for (r, s), lst in tracker.recent.items():
            if r != ridx or not lst:
                continue
            for k, rt in enumerate(lst[:keep]):
                st.mids[s, k] = rt.mid
                st.slots[s, k] = rt.slot
                if rt.embed is not None:
                    st.embeds[s, k, :rt.embed.shape[0]] = rt.embed
                st.norms[s, k] = rt.norm
                st.uid[s, k] = rt.uid
            st.count[s] = min(len(lst), keep)
        return st

    def to_tracker(self, ridx: int, tracker=None):
        """This region's history exported into a ``LocalityTracker``
        (score-equivalent: zero-norm entries come back as ``embed=None``,
        which contributes the same)."""
        from repro_torch.core.micro import LocalityTracker, RecentTask
        from repro_torch.sim.state import MODEL_NAMES
        if tracker is None:
            tracker = LocalityTracker(keep=self.keep)
        for s in range(self.n_servers):
            c = int(self.count[s])
            if c == 0:
                continue
            lst = []
            for k in range(c):
                mid = int(self.mids[s, k])
                has = self.norms[s, k] > 0.0
                lst.append(RecentTask(
                    model=MODEL_NAMES[mid] if mid >= 0 else None,
                    embed=self.embeds[s, k].copy() if has else None,
                    slot=int(self.slots[s, k]), mid=mid,
                    norm=float(self.norms[s, k]),
                    uid=int(self.uid[s, k])))
            tracker.recent[(ridx, s)] = lst
        if self.uid.size:
            tracker._uid = max(tracker._uid, int(self.uid.max()))
        return tracker
