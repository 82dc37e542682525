"""The log and the stores of a configuration's deployment, built through
the port's own constructors (``launch/train.py`` deploys them so)."""

from __future__ import annotations

from dataclasses import replace


def model_config(config: dict, overrides: dict = None):
    """The port's ModelConfig named by the configuration file, with the
    file's ``model`` keys (the configuration as it is run) set on it."""
    from repro_torch.configs import get_config
    cfg = get_config(config["port_config"])
    return replace(cfg, **{**config["model"], **(overrides or {})})


class Deployment:
    """A replica set of the log (primary + backups), the replicated object
    stores and the log-backed checkpoint manager over them."""

    def __init__(self, config: dict, device):
        from repro_torch.checkpoint import (CheckpointConfig,
                                            CheckpointManager, ObjectStore,
                                            ReplicatedStore)
        from repro_torch.core.replication import build_replica_set
        d = config["deployment"]
        log, store = d["log"], d["store"]
        self.rs = build_replica_set(
            mode=log["mode"], capacity=int(log["capacity"]),
            n_backups=int(log["n_backups"]),
            write_quorum=int(log["write_quorum"]), device=device)
        self.stores = [ObjectStore(f"s{i}") for i in range(store["replicas"])]
        self.mgr = CheckpointManager(
            ReplicatedStore(self.stores, write_quorum=store["write_quorum"]),
            self.rs.log, CheckpointConfig(force_freq=d["checkpoint"]
                                          ["force_freq"]))

    def images(self):
        """(name, durable image as bytes) of every durable copy of the log:
        the primary's device and each backup's."""
        out = [(self.rs.primary_id, self.rs.primary_dev)]
        out += [(s.server_id, s.device) for s in self.rs.servers]
        return [(name, dev.to_numpy()["durable"].tobytes())
                for name, dev in out]

    def close(self) -> None:
        try:
            self.mgr.close()
        finally:
            self.rs.shutdown()
