"""Launchers of the port: ``serve`` (batched prefill + greedy decode) and
``train`` (the journaled, checkpointed trainer)."""
