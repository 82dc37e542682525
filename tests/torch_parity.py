"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: moving a device image between the two, and reading both
packages' state as plain values to compare with ==."""

import numpy as np

from repro.core.pmem import DeviceStats, PMEMDevice as JaxPMEM
from repro_torch.core.pmem import PMEMDevice as TorchPMEM


def stats(dev) -> dict:
    return dict(dev.stats.__dict__)


def durable(dev) -> bytes:
    """The durable image (what survives power loss for sure)."""
    if isinstance(dev, TorchPMEM):
        return dev.to_numpy()["durable"].tobytes()
    return dev._durable.tobytes()


def to_port(jdev: JaxPMEM) -> TorchPMEM:
    """A port device holding a JAX-package device's image and counters."""
    strict = jdev.mode == "strict"
    tdev = TorchPMEM.from_numpy(
        jdev._durable, mode=jdev.mode,
        overlay=jdev._overlay if strict else None,
        dirty=jdev._dirty if strict else None,
        resident=jdev._resident, stats=stats(jdev))
    assert tdev.dirty_units() == jdev.dirty_units()
    return tdev


def to_jax(tdev: TorchPMEM) -> JaxPMEM:
    """A JAX-package device holding a port device's image and counters."""
    state = tdev.to_numpy()
    jdev = JaxPMEM(tdev.size, mode=tdev.mode)
    jdev._durable[:] = state["durable"]
    jdev._resident[:] = state["resident"]
    if tdev.mode == "strict":
        jdev._overlay[:] = state["overlay"]
        jdev._dirty[:] = state["dirty"]
        jdev._dirty_count = int(np.count_nonzero(state["dirty"]))
    jdev.stats = DeviceStats(**state["stats"])
    return jdev


def payload_for(i: int, size: int) -> bytes:
    rng = np.random.default_rng(i * 7919 + size)
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def rec_shape(log) -> dict:
    """Volatile layout fingerprint: lsn -> (off, size, extent, pad, state)."""
    return {l: (r.off, r.size, r.extent, r.pad, r.state)
            for l, r in sorted(log._recs.items())}
