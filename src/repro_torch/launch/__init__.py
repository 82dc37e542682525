"""Launchers of the port: ``serve`` (batched prefill + greedy decode),
``train`` (the journaled, checkpointed trainer), ``mesh`` (the production
and smoke meshes), ``dryrun`` (per-device roofline inputs of every cell on
no device) and ``perf`` (the dry run's experiment registry)."""
