"""Readers of the program's spans: each call record's ``timings`` (the
port's ``Retriever.last_timings``, copied after every device call) holds
host seconds per span path (``<stage>/<child>``, repeated children
summed; ``serve/queue_wait`` the sum of the call's real queries' waits).
A program without the span reads None."""
from __future__ import annotations

from typing import Dict, Optional


def mean_ms(layers: Dict, path: str) -> Optional[float]:
    """Mean milliseconds of ``path`` a device call, over the window's calls
    that record it."""
    if layers.get("kind") != "serve":
        return None
    got = [c["timings"][path] for c in layers["calls"]
           if path in c["timings"]]
    return 1e3 * sum(got) / len(got) if got else None


def per_query_ms(layers: Dict, path: str) -> Optional[float]:
    """Milliseconds of ``path`` a real query: its sum over the window's
    calls that record it over their real queries."""
    if layers.get("kind") != "serve":
        return None
    got = [(c["timings"][path], c["real"]) for c in layers["calls"]
           if path in c["timings"]]
    real = sum(r for _, r in got)
    return 1e3 * sum(t for t, _ in got) / real if real else None
