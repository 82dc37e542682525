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


# --------------------------------------------------------------------- #
# running one scenario on both packages, and waiting on states
# --------------------------------------------------------------------- #
import threading
import time

import repro.core as jcore
import repro_torch.core as tcore


def dev_kw(core) -> dict:
    """The port's entry points take ``device`` (the card by default)."""
    return {"device": "cpu"} if core is tcore else {}


def on_both(scenario, *args, **kwargs):
    """Run ``scenario(core, *args)`` on both packages: (port, jax)."""
    return (scenario(tcore, *args, **kwargs),
            scenario(jcore, *args, **kwargs))


def wait_until(cond, what: str, timeout: float = 30.0) -> None:
    """Poll ``cond`` until it holds; fail the test after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def hold_writes(transport, until, passed: int = 0, what: str = "release"):
    """Let ``transport``'s lane deliver its next ``passed`` writes, then
    hold the following ones on the lane until ``until()`` holds; from then
    on every write goes through.  A held write is a round that cannot
    retire, which the reference's tests make with a long injected delay.
    -> the count of writes the lane has taken (a list of one int)."""
    real = transport.write_imm_staged
    served = [0]
    released = threading.Event()

    def write(staged):
        served[0] += 1
        if served[0] > passed and not released.is_set():
            wait_until(until, what)
            released.set()
        return real(staged)
    transport.write_imm_staged = write
    return served


def hold_until_fenced(transport, passed: int = 0):
    """Hold ``transport``'s writes (after ``passed``) until its backup
    fences the primary: each held write then fails on the wire, as a
    write does whose backup dies with it in flight."""
    return hold_writes(
        transport, lambda: transport.server.is_fenced(transport.primary_id),
        passed, "the backup's fence")


def lane_acked_all(log, transport) -> bool:
    """Has ``transport`` acked every round now in flight?"""
    for e in list(log._inflight):
        h = getattr(e, "handle", None)
        rnd = getattr(h, "round", None)
        if rnd is None or transport not in [t for t, _ in
                                            rnd.salvage().acked]:
            return False
    return True
