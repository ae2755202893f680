"""The run ledger's content digest — the port of `digest` from
`wittgenstein_tpu/obs/ledger.py` (the manifests and the JSONL ledger
wait for the port's host plane, ROADMAP.md A14).  Spec digests, compile
keys and grid digests go through it, so they equal the JAX package's
for the same object."""

from __future__ import annotations

import hashlib
import json


def digest(obj) -> str:
    """Short stable content digest of any JSON-serializable object
    (canonical key order; non-serializable leaves stringified;
    wittgenstein_tpu/obs/ledger.py:41-48)."""
    payload = json.dumps(obj, sort_keys=True, default=str,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]
