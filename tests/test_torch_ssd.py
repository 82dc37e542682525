"""The port's SSD scan (plain version, through ``ops``) against the JAX
package's: its reference, its Pallas kernel in interpret mode and its
token-by-token oracle, on the same numpy-seeded inputs.

Tolerances are those of tests/test_kernels.py: 1e-4 in fp32, 5e-2 in
bf16.  The mamba2-130m head shapes (N=128, Q=256) draw dt and A as the
model initialises them: with the tests' dt range the chunk's cumulative
decay nears -200, where the JAX reference and the port's plain version
are each 3e-4 to 1e-3 (about 1e-4 of |y|) from a float64 recurrence, so
1e-4 between two fp32 versions does not hold there.  tests/test_torch_cuda.py
holds the CUDA kernel to a float64 recurrence at that range.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan.ssd_scan import ssd_pallas
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)

# tests/test_kernels.py's SSD shapes (B, S, H, P, G, N, chunk)
KERNEL_SHAPES = [
    (2, 64, 4, 32, 2, 16, 16),
    (1, 128, 2, 64, 1, 32, 32),
    (1, 96, 6, 16, 3, 8, 16),       # H=6 over G=3 groups
    (2, 64, 4, 32, 4, 16, 64),      # G == H (no grouping)
]
MAMBA2_SHAPE = (1, 512, 24, 64, 1, 128, 256)


def inputs(B, S, H, P, G, N, seed, mixer=False):
    """numpy inputs: tests/test_kernels.py's draw, or (``mixer``) dt and A
    as mamba2-130m initialises them (dt in [1e-3, 0.1], exp(A_log) in
    [1, 16])."""
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.normal(size=(B, S, H, P)).astype(f)
    if mixer:
        dt = rng.uniform(1e-3, 0.1, size=(B, S, H)).astype(f)
        A_log = np.log(rng.uniform(1.0, 16.0, size=(H,))).astype(f)
    else:
        dt = rng.uniform(0.05, 0.9, size=(B, S, H)).astype(f)
        A_log = rng.uniform(-1.0, 0.5, size=(H,)).astype(f)
    Bm = rng.normal(size=(B, S, G, N)).astype(f)
    Cm = rng.normal(size=(B, S, G, N)).astype(f)
    return xh, dt, A_log, Bm, Cm


def to_jax(args, dtype=jnp.float32):
    xh, dt, A_log, Bm, Cm = args
    return (jnp.asarray(xh, dtype), jnp.asarray(dt), jnp.asarray(A_log),
            jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype))


def to_torch(args, dtype=torch.float32):
    xh, dt, A_log, Bm, Cm = (torch.from_numpy(a) for a in args)
    return xh.to(dtype), dt, A_log, Bm.to(dtype), Cm.to(dtype)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


CASES = [(s, False) for s in KERNEL_SHAPES] + [(MAMBA2_SHAPE, True)]
IDS = [f"{'x'.join(map(str, s))}{'-mixer' if m else ''}" for s, m in CASES]


@pytest.mark.parametrize("shape,mixer", CASES, ids=IDS)
def test_plain_ssd_matches_jax_reference(shape, mixer):
    *dims, chunk = shape
    args = inputs(*dims, seed=dims[1] + dims[2], mixer=mixer)
    y, st = ops.ssd(*to_torch(args), chunk=chunk)
    y_j, st_j = jref.ssd_reference(*to_jax(args), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert tuple(st.shape) == (dims[0], dims[2], dims[3], dims[5])
    assert_close(y, y_j, F32_TOL)
    assert_close(st, st_j, F32_TOL)


@pytest.mark.parametrize("shape,mixer", CASES, ids=IDS)
def test_plain_ssd_matches_pallas_interpret(shape, mixer):
    *dims, chunk = shape
    args = inputs(*dims, seed=dims[1] * dims[2], mixer=mixer)
    y, st = ops.ssd(*to_torch(args), chunk=chunk)
    y_k, st_k = ssd_pallas(*to_jax(args), chunk=chunk, interpret=True)
    assert_close(y, y_k, F32_TOL)
    assert_close(st, st_k, F32_TOL)


@pytest.mark.parametrize("shape", KERNEL_SHAPES,
                         ids=["x".join(map(str, s)) for s in KERNEL_SHAPES])
def test_plain_ssd_matches_sequential_oracles(shape):
    *dims, chunk = shape
    args = inputs(*dims, seed=7 * dims[1] + dims[2])
    y, st = ref.ssd_reference(*to_torch(args), chunk=chunk)
    y_seq, st_seq = ref.ssd_sequential_oracle(*to_torch(args))
    y_jseq, st_jseq = jref.ssd_sequential_oracle(*to_jax(args))
    assert_close(y, y_seq, F32_TOL)
    assert_close(st, st_seq, F32_TOL)
    assert_close(y_seq, y_jseq, F32_TOL)
    assert_close(st_seq, st_jseq, F32_TOL)


def test_sequential_oracle_in_float64():
    """Given float64 inputs the oracle computes in float64: it matches a
    numpy float64 recurrence to rounding, and the fp32 oracle at 1e-4."""
    B, S, H, P, G, N = 1, 24, 4, 8, 2, 8
    args = inputs(B, S, H, P, G, N, seed=13)
    y, st = ref.ssd_sequential_oracle(*(torch.from_numpy(a).double()
                                        for a in args))
    assert y.dtype == st.dtype == torch.float64
    xh, dt, A_log, Bm, Cm = (a.astype(np.float64) for a in args)
    rep = H // G
    Bh, Ch = Bm.repeat(rep, axis=2), Cm.repeat(rep, axis=2)
    h = np.zeros((B, H, P, N))
    for t in range(S):
        h = h * np.exp(-np.exp(A_log) * dt[:, t])[..., None, None] + \
            (xh[:, t] * dt[:, t, :, None])[..., None] * Bh[:, t, :, None, :]
        np.testing.assert_allclose(y[:, t].numpy(),
                                   np.einsum("bhpn,bhn->bhp", h, Ch[:, t]),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.numpy(), h, rtol=1e-12, atol=1e-12)
    y32, st32 = ref.ssd_sequential_oracle(*to_torch(args))
    assert_close(y32, y, F32_TOL)
    assert_close(st32, st, F32_TOL)


def test_fp32_chunked_scans_drift_at_long_decays():
    """At mamba2-130m's head shapes with tests/test_kernels.py's dt draw
    (cumulative decays near -200), the port's plain version and the JAX
    reference are each 3e-4 to 1e-3 from the float64 recurrence — beyond
    1e-4, which is why the head-shape cases draw dt and A as the model
    does — while within 2e-4 of 1 + |y|."""
    *dims, chunk = MAMBA2_SHAPE
    args = inputs(*dims, seed=dims[1] + dims[2])
    exact, _ = ref.ssd_sequential_oracle(*(torch.from_numpy(a).double()
                                           for a in args))
    y, _ = ops.ssd(*to_torch(args), chunk=chunk)
    y_j, _ = jref.ssd_reference(*to_jax(args), chunk=chunk)
    for got in (y.double(), torch.from_numpy(np.array(y_j)).double()):
        err = (got - exact).abs()
        assert 3e-4 <= float(err.max()) <= 1e-3
        assert float((err / (1 + exact.abs())).max()) <= 2e-4


@pytest.mark.parametrize("shape,mixer",
                         [((1, 64, 2, 32, 1, 16, 16), False),
                          (MAMBA2_SHAPE, True)], ids=["small", "mamba2"])
def test_plain_ssd_bf16_matches_jax(shape, mixer):
    *dims, chunk = shape
    args = inputs(*dims, seed=5, mixer=mixer)
    y, st = ops.ssd(*to_torch(args, torch.bfloat16), chunk=chunk)
    y_j, st_j = jref.ssd_reference(*to_jax(args, jnp.bfloat16), chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert_close(y, y_j, BF16_TOL)
    assert_close(st, st_j, BF16_TOL)
    y_k, _ = ssd_pallas(*to_jax(args, jnp.bfloat16), chunk=chunk,
                        interpret=True)
    assert_close(y, y_k, BF16_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_matches_jax_decode_reference(G):
    B, H, P, N = 2, 4, 16, 8
    rng = np.random.default_rng(G)
    f = np.float32
    xh = rng.normal(size=(B, 1, H, P)).astype(f)
    dt = rng.uniform(0.05, 0.9, size=(B, 1, H)).astype(f)
    A_log = rng.uniform(-1.0, 0.5, size=(H,)).astype(f)
    Bm = rng.normal(size=(B, 1, G, N)).astype(f)
    Cm = rng.normal(size=(B, 1, G, N)).astype(f)
    state = rng.normal(size=(B, H, P, N)).astype(f)
    y, st = ops.ssd_decode(*(torch.from_numpy(a) for a in
                             (xh, dt, A_log, Bm, Cm, state)))
    y_j, st_j = jref.ssd_decode_reference(*(jnp.asarray(a) for a in
                                            (xh, dt, A_log, Bm, Cm, state)))
    assert_close(y, y_j, F32_TOL)
    assert_close(st, st_j, F32_TOL)


def test_chunked_state_seeds_decode():
    """Prefill's final state, then one decode step, equals the sequential
    recurrence over the prompt plus that token."""
    args = inputs(1, 33, 4, 16, 2, 8, seed=11)
    xh, dt, A_log, Bm, Cm = to_torch(args)
    _, st = ops.ssd(xh[:, :32], dt[:, :32], A_log, Bm[:, :32], Cm[:, :32],
                    chunk=16)
    y1, st1 = ops.ssd_decode(xh[:, 32:], dt[:, 32:], A_log, Bm[:, 32:],
                             Cm[:, 32:], st)
    y_seq, st_seq = ref.ssd_sequential_oracle(xh, dt, A_log, Bm, Cm)
    assert_close(y1[:, 0], y_seq[:, 32], F32_TOL)
    assert_close(st1, st_seq, F32_TOL)


def test_routes_by_device_and_refuses_bad_chunks():
    args = to_torch(inputs(1, 64, 4, 16, 2, 8, seed=3))
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd(*args, chunk=48)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no SSD route"):
        ops.ssd(*meta, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):    # the kernel's own check
        from repro_torch.kernels.ssd_scan import ssd_scan
        ssd_scan.ssd_cuda(*args, chunk=16)


def test_kernel_libraries_are_named_by_source_and_flags(tmp_path, monkeypatch):
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.ssd_scan import ssd_scan
    a, b = nvcc.library_path(checksum.SOURCE), nvcc.library_path(ssd_scan.SOURCE)
    assert a != b and a.parent == b.parent == nvcc.BUILD_DIR
    assert a.name.startswith("libarcadia_checksum-")
    assert b.name.startswith("libarcadia_ssd_scan-")
    src = tmp_path / "ssd_scan.cu"
    src.write_bytes(ssd_scan.SOURCE.read_bytes() + b"\n// edited\n")
    assert nvcc.library_path(src) != b               # an edit rebuilds
    monkeypatch.setattr(nvcc, "NVCC_FLAGS", nvcc.NVCC_FLAGS + ["-G"])
    assert nvcc.library_path(ssd_scan.SOURCE) != b   # so do other flags


def test_build_failure_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import nvcc

    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(nvcc, "_nvcc", missing)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for s in srcs:
        s.write_text(f"// {s.name}\n")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            nvcc.build(s)
    assert not any((tmp_path / "build").glob("*.so"))


# ------------- the tensor-core route: its design and its router ------------- #

# per (batch, head, chunk) block of y: max|got - want| / max|want|.  The
# tensor-core kernel rounds B' = B·dt·exp(cum_Q - cum), the score tile and
# h_prev to bf16 (2^-9 of each term) besides y itself; summed over up to
# Q = 256 terms of either sign the errors reach 2^-8 to 2^-7 of a block's
# largest |y| (0.0056 to 0.0077 below); 2^-6 leaves a factor of two
BLOCK_TOL = 2.0 ** -6


@pytest.mark.parametrize("shape", KERNEL_SHAPES,
                         ids=["x".join(map(str, s)) for s in KERNEL_SHAPES])
def test_three_pass_mirror_matches_jax_and_pallas(shape):
    """The kernel's design in plain PyTorch (three passes, rounding where
    the kernel rounds) against the JAX package's reference and its Pallas
    kernel in interpret mode, in bf16: within tests/test_kernels.py's 5e-2
    and within BLOCK_TOL per block."""
    *dims, chunk = shape
    args = inputs(*dims, seed=dims[1] + 3 * dims[2])
    y, st = ref.ssd_three_pass_reference(*to_torch(args, torch.bfloat16),
                                         chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    wants = (jref.ssd_reference(*to_jax(args, jnp.bfloat16), chunk=chunk),
             ssd_pallas(*to_jax(args, jnp.bfloat16), chunk=chunk,
                        interpret=True))
    for y_w, st_w in wants:
        assert_close(y, y_w, BF16_TOL)
        assert_close(st, st_w, BF16_TOL)
        assert ref.chunk_block_rel_err(y, torch.from_numpy(f32(y_w)),
                                       chunk) <= BLOCK_TOL


def test_three_pass_mirror_near_float64_at_mamba2_widths():
    """At mamba2-130m's head widths (N = 128, Q = 256), dt and A drawn as
    the model initialises them: the mirror, like the plain version, is
    within BLOCK_TOL per block of the float64 recurrence on the same bf16
    values, and within 5e-2 elementwise (y and state)."""
    *dims, chunk = MAMBA2_SHAPE
    args = to_torch(inputs(*dims, seed=17, mixer=True), torch.bfloat16)
    y, st = ref.ssd_three_pass_reference(*args, chunk=chunk)
    y_plain, _ = ref.ssd_reference(*args, chunk=chunk)
    y_exact, st_exact = ref.ssd_sequential_oracle(*(a.double() for a in args))
    assert ref.chunk_block_rel_err(y, y_exact, chunk) <= BLOCK_TOL
    assert ref.chunk_block_rel_err(y_plain, y_exact, chunk) <= BLOCK_TOL
    torch.testing.assert_close(y.double(), y_exact, **BF16_TOL)
    torch.testing.assert_close(st.double(), st_exact, **BF16_TOL)


def test_block_check_fails_planted_faults():
    """The card's per-block check can fail a wrong scan: with the mirror
    in the kernel's place at mamba2's widths, the second half of the
    sequence scanned alone (the state not carried in) and A_log + ln 2
    (decays twice as fast) each miss the plain version by more than
    8 × BLOCK_TOL in some block (about 0.5 and 0.4 of a block's largest
    |y|), while the mirror itself stays within BLOCK_TOL."""
    B, S, H, P, G, N, Q = 1, 1024, 24, 64, 1, 128, 256
    xh, dt, A_log, Bm, Cm = to_torch(inputs(B, S, H, P, G, N, seed=23,
                                            mixer=True), torch.bfloat16)
    y_plain, _ = ref.ssd_reference(xh, dt, A_log, Bm, Cm, chunk=Q)
    y, _ = ref.ssd_three_pass_reference(xh, dt, A_log, Bm, Cm, chunk=Q)
    assert ref.chunk_block_rel_err(y, y_plain, Q) <= BLOCK_TOL
    h = S // 2
    y_half, _ = ref.ssd_three_pass_reference(xh[:, h:], dt[:, h:], A_log,
                                             Bm[:, h:], Cm[:, h:], chunk=Q)
    assert ref.chunk_block_rel_err(y_half, y_plain[:, h:], Q) > 8 * BLOCK_TOL
    y_fast, _ = ref.ssd_three_pass_reference(xh, dt, A_log + np.log(2.0), Bm,
                                             Cm, chunk=Q)
    assert ref.chunk_block_rel_err(y_fast, y_plain, Q) > 8 * BLOCK_TOL


def mixer_views(B, S, H, P, G, N, dtype=torch.bfloat16, pad=0, skip=0):
    """xh, Bm and Cm as models/layers.py's ssm_mixer passes them: views of
    one [B, S, H·P + 2·G·N] conv output; ``pad`` widens its rows and
    ``skip`` starts the views that many elements in."""
    width = H * P + 2 * G * N
    conv = torch.zeros(B, S, width + pad + skip, dtype=dtype)[..., skip:]
    xi, Bm, Cm = torch.split(conv[..., :width], [H * P, G * N, G * N], dim=-1)
    return (xi.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
            Cm.reshape(B, S, G, N))


def contiguous(B, S, H, P, G, N, dtype=torch.bfloat16):
    return (torch.zeros(B, S, H, P, dtype=dtype),
            torch.zeros(B, S, G, N, dtype=dtype),
            torch.zeros(B, S, G, N, dtype=dtype))


ROUTE_CASES = {
    # mamba2-130m's serving widths, contiguous and as the mixer's views
    "mamba2 bf16": (contiguous(1, 512, 24, 64, 1, 128), 256, "tensor_cores"),
    "mamba2 bf16 mixer views": (mixer_views(2, 512, 24, 64, 1, 128), 256,
                                "tensor_cores"),
    "mamba2 fp32": (contiguous(1, 512, 24, 64, 1, 128, torch.float32), 256,
                    "cuda_cores"),
    "mamba2 fp32 mixer views": (mixer_views(1, 512, 24, 64, 1, 128,
                                            torch.float32), 256, "cuda_cores"),
    # a token stride that is not a multiple of 8 elements, a view that
    # starts 8 bytes into its storage: not 16-byte aligned for cp.async
    "views, token stride 1793": (mixer_views(1, 512, 24, 64, 1, 128, pad=1),
                                 256, "cuda_cores"),
    "views, 8-byte offset": (mixer_views(1, 512, 24, 64, 1, 128, skip=4), 256,
                             "cuda_cores"),
    "grouped H6 G3": (contiguous(1, 256, 6, 32, 3, 32), 64, "tensor_cores"),
    "P 96 N 48": (contiguous(1, 128, 2, 96, 1, 48), 128, "tensor_cores"),
    "P 16 N 256": (contiguous(1, 128, 2, 16, 1, 256), 64, "tensor_cores"),
    "P 40": (contiguous(1, 128, 2, 40, 1, 32), 64, "cuda_cores"),
    "P 144": (contiguous(1, 128, 2, 144, 1, 32), 64, "cuda_cores"),
    "N 8": (contiguous(1, 128, 2, 32, 1, 8), 64, "cuda_cores"),
    "N 272": (contiguous(1, 128, 2, 32, 1, 272), 64, "cuda_cores"),
    "chunk 32": (contiguous(1, 128, 2, 64, 1, 128), 32, "cuda_cores"),
    "S 100 under a chunk of 256": (contiguous(1, 100, 2, 64, 1, 128), 256,
                                   "cuda_cores"),
    "S 128 under a chunk of 256": (contiguous(1, 128, 2, 64, 1, 128), 256,
                                   "tensor_cores"),
    "reduced mamba2 (P 16, N 32, chunk 32)": (contiguous(2, 64, 4, 16, 2, 32),
                                              32, "cuda_cores"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES), ids=list(ROUTE_CASES))
def test_route_by_dtype_shape_and_layout(case):
    (xh, Bm, Cm), chunk, want = ROUTE_CASES[case]
    assert ssd_kernel.route(xh, Bm, Cm, chunk) == want


def test_route_refuses_mixed_dtypes_to_the_tensor_cores():
    xh, Bm, Cm = contiguous(1, 256, 4, 64, 1, 128)
    assert ssd_kernel.route(xh, Bm.float(), Cm, 256) == "cuda_cores"
    assert ssd_kernel.route(xh, Bm, Cm.float(), 256) == "cuda_cores"


def test_tensor_core_plan_fits_and_matches_the_source():
    """Every (P, N) the router sends to the tensor cores fits the 227 KB a
    block may use at chunks up to 2048, and the wrapper's constants are
    the source's."""
    src = ssd_kernel.TC_SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kTile"], consts["kPad"], consts["kMaxP"],
            consts["kMaxN"], consts["kMaxSmem"], consts["kMaxGridYZ"]) == \
        (ssd_kernel.ROW_TILE, ssd_kernel.PAD, ssd_kernel.MAX_P,
         ssd_kernel.MAX_N, ssd_kernel.MAX_SMEM, ssd_kernel.MAX_GRID_YZ)
    for P in range(16, ssd_kernel.MAX_P + 1, 16):
        for N in range(16, ssd_kernel.MAX_N + 1, 16):
            for Q in (64, 256, 2048):
                state, scan, rows = ssd_kernel.tc_plan(P, N, Q)
                assert max(state, scan) <= ssd_kernel.MAX_SMEM, (P, N, Q)
                assert rows in (64, 128) and Q % rows == 0
    # mamba2-130m: 56,448 and 108,544 bytes, chunk-output blocks of 128
    # rows, two of them an SM
    assert ssd_kernel.tc_plan(64, 128, 256) == (56448, 108544, 128)
    # the widest head and state at a chunk of 2048: 64-row blocks fit
    assert ssd_kernel.tc_plan(128, 256, 2048)[2] == 64
