"""The port on the card: the CUDA kernel against its plain version, and the
log's path through it.  Every test here needs an NVIDIA card and skips
elsewhere; on the GPU machine run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Log, LogConfig, PMEMDevice, device_size
from repro_torch.kernels.checksum import checksum, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,lanes", [(5, 1), (5, 7), (5, 259), (3, 4096),
                                        (2, 4097), (2, 32769), (64, 5000)])
def test_kernel_matches_plain_version(cuda_device, rows, lanes):
    rng = np.random.default_rng(rows * 100003 + lanes)
    mat = rng.integers(0, 2 ** 32, size=(rows, lanes), dtype=np.uint32)
    mat[0, lanes // 2:] = 0                       # a zero-padded row
    t = torch.from_numpy(mat.view(np.int32)).to(cuda_device)
    before = checksum.LAUNCHES
    got = ops.tensor_checksum_batch(t)
    assert checksum.LAUNCHES == before + 1        # the whole matrix, one launch
    assert got.device == t.device
    assert torch.equal(got.cpu(), ref.checksum_lanes_2d(t.cpu()))
    assert torch.equal(got, ref.checksum_lanes_2d(t))


def test_all_ones_and_single_tensors(cuda_device):
    ones = torch.full((2, 9000), -1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.tensor_checksum_batch(ones).cpu(),
                       ref.checksum_lanes_2d(ones.cpu()))
    for x in (torch.randn(1001, 3, dtype=torch.bfloat16, device=cuda_device),
              torch.arange(4099, dtype=torch.uint8, device=cuda_device),
              torch.arange(48, dtype=torch.uint8, device=cuda_device)[1:41],
              torch.arange(48, dtype=torch.uint8, device=cuda_device)[1:]):
        assert int(ops.tensor_checksum(x)) == \
            int(ref.tensor_checksum(x.cpu()))


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        checksum.checksum_rows_cuda(torch.zeros((2, 2), dtype=torch.int64,
                                                device=cuda_device))
    with pytest.raises(ValueError):
        checksum.checksum_rows_cuda(
            torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)[:, ::2])


@pytest.mark.parametrize("mode", ["fast", "strict"])
def test_log_on_the_card_writes_the_cpu_image(cuda_device, mode):
    cap = 1 << 16
    waves = [[bytes([w * 7 + i]) * (200 + 97 * i) for i in range(5)]
             for w in range(8)]
    images, logs = [], []
    for device in (cuda_device, "cpu"):
        dev = PMEMDevice(device_size(cap), mode=mode)
        wal = Log.create(dev, LogConfig(capacity=cap, phash_threshold=256),
                         device=device)
        for wave in waves[:4]:
            wal.append_batch(wave)
        for p in waves[4]:
            wal.append(p)
        images.append(dev.read(0, dev.size))
        logs.append(dev)
    assert images[0] == images[1]
    before = checksum.LAUNCHES
    relog = Log.open(logs[0], LogConfig(capacity=cap), device=cuda_device)
    got = [p for _, p in relog.iter_records()]
    assert checksum.LAUNCHES == before + 2        # scan + replay, one each
    assert got == [p for w in waves[:5] for p in w]
