"""The port's integrity hash against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
package's hash (its jnp oracle, and its Pallas kernel in interpret mode
as tests/test_kernels.py runs it) and through the port's plain torch
version and device routing.  It is an integer hash: every comparison is
exact equality.  The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py (skipped where there is
no card) and by chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.checksum import ops as jops
from repro.kernels.checksum import ref as jref
from repro.kernels.checksum.checksum import tensor_checksum_pallas
from repro_torch.kernels.checksum import checksum as tkernel
from repro_torch.kernels.checksum import ops as tops
from repro_torch.kernels.checksum import ref as tref

R = 2654435761


def exact_hash(lanes) -> int:
    """Σ x_i · r^i mod 2^32 with Python integers (no overflow at all)."""
    h, w = 0, 1
    for x in lanes:
        h = (h + int(x) * w) & 0xFFFFFFFF
        w = (w * R) & 0xFFFFFFFF
    return h


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> CPU tensor with the same bytes."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("shape", [(128,), (1000,), (256, 128), (7, 33, 5),
                                   (2, 3, 4, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
def test_tensor_checksum_matches_jax(shape, dtype):
    rng = np.random.default_rng(hash((shape, dtype)) % 2**32)
    jx = jnp.asarray(rng.normal(size=shape) * 10).astype(dtype)
    x = to_torch(np.asarray(jx))
    want = int(jref.tensor_checksum(jx))
    assert want == int(tensor_checksum_pallas(jx, interpret=True))
    assert int(tref.tensor_checksum(x)) == want
    assert int(tops.tensor_checksum(x)) == want


@pytest.mark.parametrize("nbytes", [1, 2, 3, 4, 5, 4095, 16385])
def test_as_lanes_pads_and_is_little_endian(nbytes):
    rng = np.random.default_rng(nbytes)
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
    lanes = tref.as_lanes(torch.from_numpy(raw))
    want = np.asarray(jref.as_lanes(jnp.asarray(raw)), np.uint32)
    np.testing.assert_array_equal(lanes.numpy(), want.astype(np.int64))
    assert int(tops.tensor_checksum(torch.from_numpy(raw))) == \
        exact_hash(want)


def test_checksum_detects_single_bit_flip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32)
    base = int(tops.tensor_checksum(torch.from_numpy(x)))
    assert base == int(jref.tensor_checksum(jnp.asarray(x)))
    for byte in [0, 999, len(x.tobytes()) - 1]:
        raw = bytearray(x.tobytes())
        raw[byte] ^= 0x10
        y = np.frombuffer(bytes(raw), np.float32).copy()
        got = int(tops.tensor_checksum(torch.from_numpy(y)))
        assert got != base
        assert got == int(jref.tensor_checksum(jnp.asarray(y)))


def test_checksum_detects_torn_8byte_unit():
    rng = np.random.default_rng(1)
    x = rng.normal(size=2048).astype(np.float32)
    base = int(tops.tensor_checksum(torch.from_numpy(x)))
    raw = bytearray(x.tobytes())
    raw[512:520] = b"\0" * 8
    y = np.frombuffer(bytes(raw), np.float32).copy()
    got = int(tops.tensor_checksum(torch.from_numpy(y)))
    assert got != base
    assert got == int(jref.tensor_checksum(jnp.asarray(y)))


@pytest.mark.parametrize("lanes", [1, 7, 259, 4096, 5000])
def test_checksum_batch_matches_jax(lanes):
    rng = np.random.default_rng(lanes)
    mat = rng.integers(0, 2 ** 32, size=(5, lanes), dtype=np.uint32)
    mat[2, lanes // 2:] = 0                  # a zero-padded row
    want = np.asarray(jops.tensor_checksum_batch(mat), np.uint32)
    pallas = np.asarray(jops.tensor_checksum_batch(mat, use_pallas=True),
                        np.uint32)
    np.testing.assert_array_equal(pallas, want)
    for t in (torch.from_numpy(mat), torch.from_numpy(mat.view(np.int32))):
        got = tops.tensor_checksum_batch(t)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # each row equals the hash of its unpadded lanes
    half = torch.from_numpy(mat[2, :lanes // 2].copy())
    assert int(tops.tensor_checksum_batch(torch.from_numpy(mat))[2]) == \
        int(tref.checksum_lanes(half))


@pytest.mark.parametrize("lanes", [1, 4096, 4097, 9000])
def test_all_ones_lanes_do_not_overflow(lanes):
    """0xFFFFFFFF · r^i exceeds int64: the plain version must split the
    product and still give the exact value mod 2^32."""
    mat = np.full((3, lanes), 0xFFFFFFFF, dtype=np.uint32)
    want = exact_hash(mat[0]) if lanes <= 4097 else \
        int(np.asarray(jops.tensor_checksum_batch(mat), np.uint32)[0])
    got = tops.tensor_checksum_batch(torch.from_numpy(mat))
    assert got.tolist() == [want] * 3
    assert want == int(np.asarray(jops.tensor_checksum_batch(mat),
                                  np.uint32)[0])


def test_empty_inputs():
    assert tops.tensor_checksum_batch(
        torch.zeros((3, 0), dtype=torch.int32)).tolist() == [0, 0, 0]
    assert int(tops.tensor_checksum(torch.zeros(0, dtype=torch.uint8))) == 0


def test_routing_refuses_other_devices_and_the_kernel_refuses_cpu():
    with pytest.raises(ValueError):
        tops.tensor_checksum(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        tops.tensor_checksum_batch(torch.zeros((2, 2), dtype=torch.int32,
                                               device="meta"))
    with pytest.raises(ValueError):
        tops.tensor_checksum_batch(torch.zeros(4, dtype=torch.int32))
    # the kernel wrapper takes CUDA tensors only: no silent CPU route
    with pytest.raises(ValueError):
        tkernel.checksum_rows_cuda(torch.zeros((2, 2), dtype=torch.int32))


def constant_tables(src: str) -> dict:
    """Every ``__constant__`` array of a CUDA source: name -> values."""
    return {name: [int(v.rstrip("u"), 16)
                   for v in re.findall(r"0x[0-9A-Fa-f]+u", body)]
            for name, body in re.findall(
                r"__constant__\s+\w+\s+(\w+)\[\d+\]\s*=\s*\{([^}]*)\}",
                src)}


def test_kernel_weight_table_is_r_to_the_powers_of_two():
    """The constant tables of the kernels' sources: the hash's one table
    kRPow2 holds r^(2^k), the short-row kernel's lane weights r^l (a 5-bit
    square-and-multiply over its first five entries) and its step r^32
    (its sixth) come out right, and the SSD sources hold no table."""
    tables = constant_tables(Path(tkernel.SOURCE).read_text())
    assert list(tables) == ["kRPow2"]
    table = tables["kRPow2"]
    assert table == [pow(R, 1 << k, 1 << 32) for k in range(32)]
    # bits of a lane index above 27 multiply by 1: any index is exact
    assert all(v == 1 for v in table[28:])
    for lane in range(32):
        w = 1
        for k in range(5):
            w = w * (table[k] if (lane >> k) & 1 else 1) & 0xFFFFFFFF
        assert w == pow(R, lane, 1 << 32)
    assert table[5] == pow(R, 32, 1 << 32)
    from repro_torch.kernels.ssd_scan import ssd_scan
    for src in (ssd_scan.SOURCE, ssd_scan.TC_SOURCE):
        assert "__constant__" not in Path(src).read_text()


def short_row_hash(row) -> int:
    """The short-row kernel's arithmetic in Python integers: lane l of the
    warp takes elements l, l + 32, ... weighted from r^l by steps of r^32,
    and the 32 lanes' sums are added."""
    total = 0
    r32 = pow(R, 32, 1 << 32)
    for lane in range(32):
        w, acc = pow(R, lane, 1 << 32), 0
        for i in range(lane, len(row), 32):
            acc = (acc + int(row[i]) * w) & 0xFFFFFFFF
            w = w * r32 & 0xFFFFFFFF
        total = (total + acc) & 0xFFFFFFFF
    return total


@pytest.mark.parametrize("lanes", [1, 31, 33, 259, 4096])
def test_short_row_weights_give_the_hash(lanes):
    rng = np.random.default_rng(lanes + 5)
    row = rng.integers(0, 2 ** 32, size=lanes, dtype=np.uint32)
    assert short_row_hash(row) == exact_hash(row) == \
        int(tops.tensor_checksum_batch(torch.from_numpy(row[None]))[0])


@pytest.mark.parametrize("lanes,want", [
    (0, "short_rows"), (1, "short_rows"), (259, "short_rows"),
    (4096, "short_rows"), (4097, "long_rows"), (32769, "long_rows"),
    (262147, "long_rows")])
def test_route_by_row_length(lanes, want):
    """1 KiB records (259 lanes with the seed) take one warp a row; 1 MiB
    records, checkpoint shards and single tensors the block-chunk kernel."""
    assert tkernel.route(lanes) == want


def test_short_row_limit_is_the_sources():
    src = Path(tkernel.SOURCE).read_text()
    assert int(re.search(r"constexpr int kRowLanes = (\d+);", src).group(1)) \
        == tkernel.ROW_LANES >= 4096


@pytest.mark.parametrize("lo,hi", [(0, 10), (1, 41), (3, 48)])
def test_as_words_pads_and_realigns(lo, hi):
    x = torch.arange(64, dtype=torch.uint8)[lo:hi]
    w = tref.as_words(x)
    assert w.dtype == torch.int32 and w.numel() == (hi - lo + 3) // 4
    assert int(tref.checksum_lanes_2d(w.view(1, -1))[0]) == \
        exact_hash(np.frombuffer(x.numpy().tobytes().ljust(4 * w.numel(),
                                                          b"\0"), "<u4"))
