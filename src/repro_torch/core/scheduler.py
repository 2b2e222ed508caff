"""Victim policy for mid-decode page exhaustion — the one piece of the
reference's scheduler module the single-server path runs. The rank-aware
cluster router (Algorithm 1) and its baselines are not ported yet
(ROADMAP.md queue 1, cluster / placement / faults)."""
from __future__ import annotations


def select_victim(states, exclude=()):
    """Victim policy for mid-decode page exhaustion: among the running
    rows, preempt the least-recently-advanced request (LRU by last token
    time — the row that has waited longest is the one whose batch slot is
    cheapest to take, matching S-LoRA's preemptive scheduling), breaking
    ties SLO-aware: prefer victims without a time-per-token SLO, then the
    loosest SLO (most slack), then the lowest rid for determinism.
    `states` are candidate RequestStates; `exclude` are states that must
    not be chosen (e.g. the row whose growth triggered the hunt). Returns
    None when no candidate remains."""
    skip = set(id(s) for s in exclude)
    cands = [s for s in states if s is not None and id(s) not in skip]
    if not cands:
        return None

    def key(st):
        last = st.token_times_ms[-1] if st.token_times_ms else (
            st.first_token_ms if st.first_token_ms is not None
            else st.req.arrival_ms)
        slack = st.req.slo_tpt_ms if st.req.slo_tpt_ms is not None \
            else float("inf")
        return (last, -slack, st.req.rid)

    return min(cands, key=key)
