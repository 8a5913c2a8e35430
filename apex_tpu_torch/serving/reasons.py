"""Finish-reason vocabulary of the port's serving slice.

A copy of the constants of ``apex_tpu/serving/reasons.py`` that this
slice assigns; the rest (shed, timeout, breaker, draining, cancel,
hand-off, replica failover) arrive with the features that set them.
"""

# healthy terminals — the request ran to its natural end
EOS = "eos"                      # sampled the eos id
LENGTH = "length"                # hit max_new_tokens

# server-side failure terminals
CAPACITY = "capacity"            # could never fit the KV pool
NONFINITE = "nonfinite"          # non-finite logits isolated
REJECTED = "rejected"            # bounded waiting queue was full
