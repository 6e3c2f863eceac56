"""Cross-pod federated operations of the port: the compression schemes a
pod's update may take (``fed_update_bits`` sizes an upload with them).
The single-pod train step (``dist/stepfns.py``) needs no collective; the
reference's in-graph collectives (``fedavg_pods``, ``fedbuff_pods``,
``compress_deltas``) come with the federated steps (ROADMAP Queue 1 item
10)."""
from __future__ import annotations

SCHEMES = ("none", "int8", "topk", "int8+topk")


def check_scheme(scheme) -> str:
    """Normalise/validate a compression scheme name (None -> "none")."""
    scheme = scheme or "none"
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown compression scheme {scheme!r}; have {SCHEMES}"
        )
    return scheme
