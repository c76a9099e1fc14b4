"""Flight recorder: a bounded ring of recent dispatch records for
post-mortem.

Counterpart of ``repro.obs.recorder``, standard library only; dumps go to the
same ``REPRO_FLIGHT_DIR``.

The serving engine appends one small dict per notable event (dispatch,
shed, dispatch error) as it runs — cheap enough to leave on always.  When
something goes wrong (a :class:`~repro_torch.serve.engine.QueueFullError`, an
exception inside a dispatch) the engine calls :meth:`FlightRecorder.dump`
and keeps the result as ``engine.last_incident``: the last N records
leading up to the failure, with timestamps from the engine's own clock —
"what was the engine doing right before this?" answered without having
had tracing enabled.  Set ``REPRO_FLIGHT_DIR`` to also write each
incident dump as a JSON file.
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of ``{"t", "kind", ...}`` records (oldest dropped)."""

    def __init__(self, capacity: int = 256, clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumps = 0

    def record(self, kind: str, **fields) -> None:
        rec = {"t": self.clock(), "kind": kind, **fields}
        with self._lock:
            self._ring.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dumps(self) -> int:
        """How many incident dumps have been taken."""
        return self._dumps

    def dump(self, reason: str = "") -> dict:
        """Snapshot the ring for a post-mortem: ``{"reason", "dumped_at",
        "n", "records"}``.  With ``REPRO_FLIGHT_DIR`` set, also writes
        ``flight_<pid>_<seq>.json`` there (failures to write are
        swallowed — the in-memory dump is the source of truth)."""
        with self._lock:
            self._dumps += 1
            seq = self._dumps
            records = list(self._ring)
        doc = {
            "reason": reason,
            "dumped_at": self.clock(),
            "n": len(records),
            "records": records,
        }
        out_dir = os.environ.get("REPRO_FLIGHT_DIR")
        if out_dir:
            try:
                path = pathlib.Path(out_dir)
                path.mkdir(parents=True, exist_ok=True)
                fname = path / f"flight_{os.getpid()}_{seq}.json"
                with open(fname, "w") as fh:
                    json.dump(doc, fh, indent=1)
                    fh.write("\n")
                doc["path"] = str(fname)
            except OSError:
                pass
        return doc
