"""Finish-reason vocabulary of the port's serving stack: the single
source of truth.

A copy of ``apex_tpu/serving/reasons.py``: every terminal
``Request.finish_reason`` the stack can assign, as a named constant,
and the frozensets that the terminal invariants gate on.  The
scheduler and the server name these constants, never string literals
(``tests/test_torch_overload.py`` scans the package for strays).

The module imports nothing, so any layer can name a reason without an
import cycle.
"""

# healthy terminals — the request ran to its natural end
EOS = "eos"                      # sampled the eos id
LENGTH = "length"                # hit max_new_tokens

# server-side failure terminals
CAPACITY = "capacity"            # could never fit the KV pool
TIMEOUT = "timeout"              # deadline expired
NONFINITE = "nonfinite"          # non-finite logits isolated
REJECTED = "rejected"            # bounded waiting queue was full
SHED = "shed"                    # overload policy dropped it
BREAKER_OPEN = "breaker_open"    # circuit breaker refused submit
DRAINING = "draining"            # submitted into a draining server
CANCELLED = "cancelled"          # client disconnected / cancel(uid)
HANDOFF = "handoff"              # exported to another replica's pool

# router-level terminals
REPLICA_FAILED = "replica_failed"  # replica died mid-stream

#: reasons that end a request without anything having gone wrong
HEALTHY_REASONS = frozenset({EOS, LENGTH})

#: every terminal a single server can assign (the exactly-one-terminal
#: invariant gates membership)
TERMINAL_REASONS = HEALTHY_REASONS | frozenset({
    CAPACITY, TIMEOUT, NONFINITE, REJECTED, SHED, BREAKER_OPEN,
    DRAINING, CANCELLED,
})

#: the router's superset: replica failover and cross-replica hand-off
#: add their own terminals
ROUTER_TERMINAL_REASONS = TERMINAL_REASONS | frozenset({
    REPLICA_FAILED, HANDOFF,
})

#: the full vocabulary
ALL_REASONS = ROUTER_TERMINAL_REASONS
