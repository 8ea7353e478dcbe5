"""Serving-plane policy: tiered placement (``placement``). The executor,
batcher and exporter of the JAX package's ``raft_tpu.serving`` are not
ported yet."""
