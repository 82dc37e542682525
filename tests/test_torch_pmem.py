"""The port's PMEM device against the JAX package's, on the CPU.

The same random write / persist / read / dma_read / crash / corrupt
sequences, made with numpy from a seed, drive both devices; the durable
images, the visible bytes, DeviceStats and every returned vns must be
identical.  Crashes and media errors draw from caller-supplied numpy
generators, so a seeded schedule must keep the same units in both.
"""

import numpy as np
import pytest
import torch

from repro.core.pmem import PMEMDevice as JaxPMEM
from repro_torch.core.pmem import ATOM, CACHE_LINE, DeviceStats, PMEMDevice

from torch_parity import durable, stats, to_jax, to_port

SIZE = 4096


def random_ops(seed, n_ops=150):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = str(rng.choice(["write", "write", "write", "persist", "read",
                               "dma_read", "crash", "corrupt"]))
        off = int(rng.integers(0, SIZE - 1))
        n = int(rng.integers(0, min(200, SIZE - off)))
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        ops.append((kind, off, n, data, int(rng.integers(0, 2 ** 31))))
    return ops


def drive_both(seed, mode):
    jdev, tdev = JaxPMEM(SIZE, mode=mode), PMEMDevice(SIZE, mode=mode)
    for kind, off, n, data, sub in random_ops(seed):
        if kind == "write":
            assert tdev.write(off, data) == jdev.write(off, data)
        elif kind == "persist":
            assert tdev.persist(off, n) == jdev.persist(off, n)
        elif kind == "read":
            assert tdev.read(off, n) == jdev.read(off, n)
        elif kind == "dma_read":
            assert tdev.dma_read(off, n) == jdev.dma_read(off, n)
        elif kind == "corrupt" and n > 0:
            jdev.corrupt(off, n, np.random.default_rng(sub), nbits=3)
            tdev.corrupt(off, n, np.random.default_rng(sub), nbits=3)
        elif kind == "crash":
            keep = (sub % 5) / 4.0
            js = jdev.crash(np.random.default_rng(sub), keep_probability=keep)
            ts = tdev.crash(np.random.default_rng(sub), keep_probability=keep)
            assert durable(ts) == durable(js)
            assert ts.read(0, SIZE) == js.read(0, SIZE)
        assert tdev.dirty_units() == jdev.dirty_units()
    return jdev, tdev


@pytest.mark.parametrize("mode", ["strict", "fast"])
@pytest.mark.parametrize("seed", range(6))
def test_random_sequences_match_jax_device(seed, mode):
    jdev, tdev = drive_both(seed, mode)
    assert tdev.read(0, SIZE) == jdev.read(0, SIZE)
    assert durable(tdev) == durable(jdev)
    assert stats(tdev) == stats(jdev)
    np.testing.assert_array_equal(tdev.to_numpy()["resident"], jdev._resident)
    # a final crash keeps the same units under the same seed
    for keep in (0.0, 0.3, 1.0):
        js = jdev.crash(np.random.default_rng(seed), keep_probability=keep)
        ts = tdev.crash(np.random.default_rng(seed), keep_probability=keep)
        assert durable(ts) == durable(js)


def test_state_lives_in_cpu_torch_tensors():
    dev = PMEMDevice(SIZE, mode="strict")
    for t, dtype, n in ((dev._durable, torch.uint8, SIZE),
                        (dev._overlay, torch.uint8, SIZE),
                        (dev._dirty, torch.bool, SIZE // ATOM),
                        (dev._resident, torch.bool, SIZE // CACHE_LINE)):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert t.dtype == dtype and t.numel() == n


def test_fast_view_is_a_writable_window_on_the_image():
    dev = PMEMDevice(SIZE, mode="fast")
    v = dev.view(100, 8)
    v[:] = b"ABCDEFGH"
    assert dev.read(100, 8) == b"ABCDEFGH"
    assert PMEMDevice(SIZE, mode="strict").view(0, 8) is None


def test_read_tensor_matches_read():
    jdev, tdev = drive_both(11, "strict")
    for off, n in ((0, SIZE), (3, 77), (SIZE - 9, 9), (5, 0)):
        t = tdev.read_tensor(off, n)
        assert t.dtype == torch.uint8 and t.numel() == n
        assert t.numpy().tobytes() == jdev.read(off, n)


@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_numpy_round_trip_moves_image_and_counters(mode):
    jdev, tdev = drive_both(5, mode)
    back = PMEMDevice.from_numpy(**tdev.to_numpy(), mode=mode)
    assert back.read(0, SIZE) == tdev.read(0, SIZE)
    assert durable(back) == durable(tdev)
    assert stats(back) == stats(tdev)
    assert back.dirty_units() == tdev.dirty_units()
    # JAX -> port and port -> JAX, then the same further operations agree
    t2, j2 = to_port(jdev), to_jax(tdev)
    for a, b in ((t2, jdev), (j2, tdev)):
        assert a.write(17, b"xyz") == b.write(17, b"xyz")
        assert a.persist(0, 64) == b.persist(0, 64)
        assert a.dma_read(0, 256) == b.dma_read(0, 256)
        assert stats(a) == stats(b)
        s_a = a.crash(np.random.default_rng(9), keep_probability=0.5)
        s_b = b.crash(np.random.default_rng(9), keep_probability=0.5)
        assert durable(s_a) == durable(s_b)


def test_from_numpy_rejects_volatile_state_in_fast_mode():
    with pytest.raises(ValueError):
        PMEMDevice.from_numpy(np.zeros(64, np.uint8), mode="fast",
                              dirty=np.ones(8, bool))
    dev = PMEMDevice.from_numpy(np.zeros(64, np.uint8), mode="fast",
                                stats=dict(writes=3))
    assert dev.stats == DeviceStats(writes=3)


def test_out_of_bounds_access_raises():
    dev = PMEMDevice(64, mode="strict")
    for call in (lambda: dev.write(60, b"12345"), lambda: dev.read(-1, 2),
                 lambda: dev.persist(0, 65), lambda: dev.read_tensor(63, 2)):
        with pytest.raises(ValueError):
            call()
