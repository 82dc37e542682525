"""The port on the card: the CUDA kernels against their plain versions, and
the log's path through the checksum kernel.  Every test here needs an NVIDIA card and skips
elsewhere; on the GPU machine run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Log, LogConfig, PMEMDevice, device_size
from repro_torch.kernels.checksum import checksum, ops, ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan

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


# ------------------------------ SSD scan ------------------------------- #

def ssd_inputs(B, S, H, P, G, N, dtype, seed, device, mixer=False):
    """The SSD inputs of tests/test_kernels.py, or (``mixer``) with dt and
    A drawn as mamba2-130m initialises them (dt in [1e-3, 0.1], A = exp(A_log)
    in [1, 16]).  At N=128, Q=256 the tests' dt range puts the chunk's
    cumulative decay near -200, where every fp32 chunked version (the JAX
    package's reference too) is 3e-4 to 1e-3 from a float64 recurrence;
    test_ssd_kernel_as_close_to_float64_as_plain holds the kernel there."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device=device, dtype=dt)
    dt = rng.uniform(1e-3, 0.1, size=(B, S, H)) if mixer else \
        rng.uniform(0.05, 0.9, size=(B, S, H))
    A_log = np.log(rng.uniform(1.0, 16.0, size=(H,))) if mixer else \
        rng.uniform(-1.0, 0.5, size=(H,))
    return (t(rng.normal(size=(B, S, H, P)), dtype), t(dt), t(A_log),
            t(rng.normal(size=(B, S, G, N)), dtype),
            t(rng.normal(size=(B, S, G, N)), dtype))


@pytest.fixture
def fp32_exact():
    """fp32 products on the card in full fp32 (no TF32) for the plain side."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = saved


# the shapes of tests/test_kernels.py (SSD), plus H=6 over G=3 groups, and
# mamba2-130m's head widths in one short chunk and in two full ones
SSD_SHAPES = [(2, 64, 4, 32, 2, 16, 16), (1, 128, 2, 64, 1, 32, 32),
              (2, 64, 4, 32, 4, 16, 64), (1, 96, 6, 16, 3, 8, 16),
              (1, 100, 24, 64, 1, 128, 256), (1, 512, 24, 64, 1, 128, 256)]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version(cuda_device, fp32_exact,
                                          B, S, H, P, G, N, chunk):
    args = ssd_inputs(B, S, H, P, G, N, torch.float32, S * H, cuda_device,
                      mixer=N == 128)
    before = ssd_scan.LAUNCHES
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    assert ssd_scan.LAUNCHES == before + 1
    y_ref, st_ref = ssd_ref.ssd_reference(*args, chunk=chunk)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, st_ref, atol=1e-4, rtol=1e-4)
    if S <= 128:
        y_seq, st_seq = ssd_ref.ssd_sequential_oracle(*args)
        torch.testing.assert_close(y, y_seq, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, st_seq, atol=1e-4, rtol=1e-4)


def err_from_exact(got, exact):
    """Worst |got - exact| / (1 + |exact|)."""
    return float(((got.double() - exact).abs() / (1 + exact.abs())).max())


@pytest.mark.parametrize("B,S,mixer", [(1, 100, False), (1, 512, False),
                                       (1, 512, True), (8, 4096, True)])
def test_ssd_kernel_as_close_to_float64_as_plain(cuda_device, fp32_exact,
                                                 B, S, mixer):
    """At mamba2-130m's head widths (H=24, P=64, N=128, Q=256), with the
    tests' dt draw (cumulative decays near -200, where both fp32 chunked
    versions lose about 1e-4 of |y|) and with the model's: the kernel is
    no further from the float64 recurrence than the plain version."""
    args = ssd_inputs(B, S, 24, 64, 1, 128, torch.float32, S + B, cuda_device,
                      mixer=mixer)
    exact = ssd_ref.ssd_sequential_oracle(*(a.double() for a in args))
    kernel = ssd_ops.ssd(*args, chunk=256)
    plain = ssd_ref.ssd_reference(*args, chunk=256)
    for k, p, e in zip(kernel, plain, exact):
        assert err_from_exact(k, e) <= err_from_exact(p, e)


def test_ssd_kernel_bf16(cuda_device, fp32_exact):
    args = ssd_inputs(1, 64, 2, 32, 1, 16, torch.bfloat16, 5, cuda_device)
    y, st = ssd_ops.ssd(*args, chunk=16)
    y_ref, st_ref = ssd_ref.ssd_reference(*args, chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, st_ref, atol=5e-2, rtol=5e-2)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda_device):
    xh, dt, A, Bm, Cm = ssd_inputs(1, 64, 4, 32, 2, 16, torch.float32, 0,
                                   cuda_device)
    with pytest.raises(ValueError):                   # chunk does not divide S
        ssd_scan.ssd_cuda(xh, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(TypeError):                    # mixed input dtypes
        ssd_scan.ssd_cuda(xh, dt, A, Bm.bfloat16(), Cm, chunk=16)
    with pytest.raises(ValueError):                   # not contiguous
        ssd_scan.ssd_cuda(xh.transpose(1, 2), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError):                   # a CPU tensor
        ssd_scan.ssd_cuda(xh.cpu(), dt, A, Bm, Cm, chunk=16)


# --------------------------- serving on the card --------------------------- #

def scan_dominated(params):
    """Conv weights at 1/sqrt(width), no D skip: each mixer's output is
    carried by its SSD scan (at the init's scale it is mostly the conv)."""
    from repro_torch.tree import tree_map
    out = tree_map(lambda t: t, params)
    ssm = out["blocks"]["l0"]["ssm"]
    ssm["conv_w"] = ssm["conv_w"] * 25.0
    ssm["D_skip"] = torch.zeros_like(ssm["D_skip"])
    return out


def test_serving_on_the_card_matches_the_cpu(cuda_device, fp32_exact):
    """Reduced mamba2-130m (2 layers, fp32): prefill through the kernel and
    4 decode steps on the card against the same on the CPU (plain)."""
    from dataclasses import replace

    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = replace(reduced_config("mamba2-130m"), n_layers=2)
    host = scan_dominated(M.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu"))
    card = tree_map(lambda t: t.to(cuda_device), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 68)))
    caches = {d: M.init_cache(cfg, 2, 68, device=d) for d in ("cpu", "cuda")}
    before = ssd_scan.LAUNCHES
    got, caches["cuda"] = M.serve_step(card, cfg, {"tokens": toks[:, :64]
                                                   .to(cuda_device)},
                                       caches["cuda"], 0)
    assert ssd_scan.LAUNCHES == before + cfg.n_layers
    want, caches["cpu"] = M.serve_step(host, cfg, {"tokens": toks[:, :64]},
                                       caches["cpu"], 0)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    for j in range(64, 68):
        got, caches["cuda"] = M.serve_step(
            card, cfg, {"tokens": toks[:, j:j + 1].to(cuda_device)},
            caches["cuda"], j)
        want, caches["cpu"] = M.serve_step(
            host, cfg, {"tokens": toks[:, j:j + 1]}, caches["cpu"], j)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))
    assert ssd_scan.LAUNCHES == before + cfg.n_layers   # decode: no kernel


def test_checkpoint_restores_onto_the_card(cuda_device):
    from repro_torch.checkpoint import (CheckpointManager, ObjectStore,
                                        ReplicatedStore)
    from repro_torch.configs import reduced_config
    from repro_torch.core import (ReplicaServer, ReplicationGroup,
                                  Transport)
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths

    cfg = reduced_config("mamba2-130m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    cap = 1 << 18
    servers = [ReplicaServer(PMEMDevice(device_size(cap)), server_id=b)
               for b in ("node1", "node2")]
    group = ReplicationGroup([Transport(s, primary_id="node0")
                              for s in servers], 2, local_is_durable=True)
    try:
        wal = Log.create(PMEMDevice(device_size(cap)),
                         LogConfig(capacity=cap, write_quorum=2,
                                   phash_threshold=256), repl=group)
        store = ReplicatedStore([ObjectStore(f"s{i}") for i in range(3)], 2)
        before = checksum.LAUNCHES
        mgr = CheckpointManager(store, wal)
        mgr.save(5, params, sync=True)
        assert checksum.LAUNCHES > before           # the manifest was hashed
        template = M.init_params(cfg, torch.Generator(device="cuda"))
        step, got, _ = mgr.restore(template)
        mgr.close()
    finally:
        group.shutdown()
    assert step == 5
    for (name, a), (_, b) in zip(leaf_paths(params), leaf_paths(got)):
        assert b.device.type == "cuda" and b.dtype == a.dtype, name
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name


# ---------------------------- flash attention ---------------------------- #

def attn_inputs(B, H, KV, S, D, dtype, seed, device):
    """q [B,H,S,D], k and v [B,KV,S,D] from numpy's normal draw."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(device=device, dtype=dtype)
                 for shape in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # tests/test_kernels.py
# per output row, |kernel - plain| over the row's largest |plain|: in bf16
# both outputs round to bf16 (2^-7 of that value) and the plain version
# rounds p too (2^-9); fp32 differs only in the order of the sums
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def check_flash(q, k, v, **kw):
    """One launch of the kernel, held within tol·(1 + |plain|) of the plain
    version on the same inputs, and row by row within FLASH_ROW_TOL of the
    row's largest value (outputs of randn inputs are about 0.05, so the
    elementwise bf16 tolerance alone is as large as they are)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    before = fa.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == before + 1
    want = fa_ref.attention_reference(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    row_err = ((got.float() - want.float()).abs().amax(-1)
               / want.float().abs().amax(-1).clamp_min(1e-30)).max()
    assert float(row_err) <= FLASH_ROW_TOL[q.dtype], float(row_err)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_kernel_head_dims(cuda_device, fp32_exact, D):
    check_flash(*attn_inputs(2, 4, 2, 192, D, torch.float32, D, cuda_device),
                causal=True, cap=50.0)


@pytest.mark.parametrize("B,H,KV,S,D", [(2, 4, 2, 256, 64), (1, 8, 8, 128, 128),
                                        (2, 2, 1, 512, 32), (1, 4, 2, 384, 64)])
def test_flash_kernel_causal_shapes_of_the_tpu_tests(cuda_device, fp32_exact,
                                                     B, H, KV, S, D):
    check_flash(*attn_inputs(B, H, KV, S, D, torch.float32, B * S,
                             cuda_device), causal=True)


@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True, window=128),
                                dict(causal=True, cap=50.0),
                                dict(causal=True, window=64, cap=30.0),
                                dict(causal=True, window=16),
                                dict(causal=False, window=40, cap=20.0)],
                         ids=["full", "window128", "cap50", "window64-cap30",
                              "window-below-a-tile", "noncausal-window"])
def test_flash_kernel_mask_variants(cuda_device, fp32_exact, kw):
    """The variants of tests/test_kernels.py, a window of 16 (narrower than
    a 64-row tile: the first tile some rows visit is wholly masked for
    them) and a window without causality."""
    check_flash(*attn_inputs(1, 4, 2, 256, 64, torch.float32, 7, cuda_device),
                **kw)


@pytest.mark.parametrize("S", [1, 63, 65, 200, 1000])
def test_flash_kernel_ragged_lengths(cuda_device, fp32_exact, S):
    check_flash(*attn_inputs(1, 4, 2, S, 64, torch.float32, S, cuda_device),
                causal=True, window=100)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 4), (14, 2)],
                         ids=["gqa1", "gqa2", "gqa7"])
def test_flash_kernel_gqa_ratios(cuda_device, fp32_exact, H, KV):
    check_flash(*attn_inputs(2, H, KV, 160, 128, torch.float32, H, cuda_device),
                causal=True)


def test_flash_kernel_bf16(cuda_device):
    check_flash(*attn_inputs(1, 2, 2, 256, 64, torch.bfloat16, 3, cuda_device),
                causal=True)
    check_flash(*attn_inputs(1, 16, 8, 640, 256, torch.bfloat16, 4,
                             cuda_device), causal=True, window=256, cap=50.0)


def test_flash_kernel_counts_each_launch_and_reads_strided_views(cuda_device,
                                                                 fp32_exact):
    """The layer's [B,S,H,D] projections go in as permuted views, without a
    copy, and the result matches the contiguous inputs'."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v = attn_inputs(2, 8, 4, 96, 64, torch.float32, 11, cuda_device)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    before = fa.LAUNCHES
    a = fa.flash_attention_cuda(q, k, v, causal=True)
    b = fa.flash_attention_cuda(qs, ks, vs, causal=True)
    assert fa.LAUNCHES == before + 2
    assert b.stride() == qs.stride()
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    """No fallback: a dtype, head dim or layout the kernel does not take
    raises, and nothing is launched."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = attn_inputs(1, 4, 2, 64, 64, torch.float16, 0, cuda_device)
    before = fa.LAUNCHES
    with pytest.raises(TypeError):                    # fp16
        fa_ops.flash_attention(q, k, v)
    with pytest.raises(TypeError):                    # mixed dtypes
        fa_ops.flash_attention(q.float(), k.float(), v.bfloat16())
    with pytest.raises(ValueError):                   # head dim above 256
        fa_ops.flash_attention(*attn_inputs(1, 2, 1, 8, 260, torch.float32, 0,
                                            cuda_device))
    with pytest.raises(ValueError):                   # 3 kv heads for 4 heads
        fa_ops.flash_attention(*attn_inputs(1, 4, 3, 8, 64, torch.float32, 0,
                                            cuda_device))
    with pytest.raises(ValueError):                   # head dim not contiguous
        fa_ops.flash_attention(q.float().transpose(2, 3), k.float(),
                               v.float())
    assert fa.LAUNCHES == before


# ------------------- flash attention on the tensor cores ------------------- #

def check_route(route, q, k, v, **kw):
    """check_flash, and the one launch went to ``route``'s kernel."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    before = (fa.TENSOR_CORE_LAUNCHES, fa.CUDA_CORE_LAUNCHES)
    check_flash(q, k, v, **kw)
    moved = (fa.TENSOR_CORE_LAUNCHES - before[0],
             fa.CUDA_CORE_LAUNCHES - before[1])
    assert moved == ((1, 0) if route == "tensor_cores" else (0, 1)), moved


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_tensor_cores_head_dims(cuda_device, D):
    check_route("tensor_cores", *attn_inputs(2, 4, 2, 192, D, torch.bfloat16,
                                             D, cuda_device),
                causal=True, cap=50.0)


TC_MASKS = {"causal": dict(causal=True), "full": dict(causal=False),
            "window128": dict(causal=True, window=128),
            "window-below-a-tile": dict(causal=True, window=16),
            "window64-cap30": dict(causal=True, window=64, cap=30.0),
            "cap50": dict(causal=True, cap=50.0),
            "noncausal-window": dict(causal=False, window=40, cap=20.0)}


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kw", list(TC_MASKS.values()), ids=list(TC_MASKS))
def test_flash_tensor_cores_mask_variants(cuda_device, D, kw):
    """The fp32 mask variants' bf16 twins at the serving head dims: a
    window of 16 lies below both key tiles (64 and 128), so some rows'
    first tiles are wholly masked."""
    check_route("tensor_cores", *attn_inputs(1, 4, 2, 256, D, torch.bfloat16,
                                             7, cuda_device), **kw)


@pytest.mark.parametrize("S", [1, 65, 200, 1000])
@pytest.mark.parametrize("D", [128, 256])
def test_flash_tensor_cores_ragged_lengths(cuda_device, S, D):
    """Lengths that no 128-row block or 64/128-key tile divides: keys past
    S weigh nothing and rows past S are not written."""
    check_route("tensor_cores", *attn_inputs(1, 4, 2, S, D, torch.bfloat16,
                                             S, cuda_device),
                causal=True, window=100)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 4), (14, 2)],
                         ids=["gqa1", "gqa2", "gqa7"])
def test_flash_tensor_cores_gqa_ratios(cuda_device, H, KV):
    check_route("tensor_cores", *attn_inputs(2, H, KV, 160, 128,
                                             torch.bfloat16, H, cuda_device),
                causal=True)


def test_flash_tensor_cores_read_the_layers_strided_views(cuda_device):
    """The layer's [B,S,H,D] projections go in as permuted views (their
    tensor maps carry the strides), without a copy, and give the same bits
    as contiguous inputs."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    kw = dict(causal=True, window=100, cap=50.0)
    q, k, v = attn_inputs(2, 16, 8, 300, 256, torch.bfloat16, 11, cuda_device)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    check_route("tensor_cores", qs, ks, vs, **kw)
    a = fa.flash_attention_cuda(q, k, v, **kw)
    b = fa.flash_attention_cuda(qs, ks, vs, **kw)
    assert b.stride() == qs.stride()
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_kernels_count_launches_per_route(cuda_device, fp32_exact):
    """bf16 at 64, 128 and 256 with 16-byte aligned strides goes to the
    tensor cores; fp32, bf16 at another head dim, and bf16 whose strides
    are multiples of 4 elements but not of 8 go to the CUDA cores.
    LAUNCHES counts both routes."""
    def sliced(D, pad):
        """q, k, v as [..., :D] slices of rows D + pad long."""
        full = attn_inputs(1, 2, 1, 64, D + pad, torch.bfloat16, 5,
                           cuda_device)
        return tuple(t[..., :D] for t in full)

    cases = [("tensor_cores", attn_inputs(1, 2, 1, 64, 128, torch.bfloat16,
                                          1, cuda_device)),
             ("tensor_cores", sliced(128, 8)),
             ("cuda_cores", attn_inputs(1, 2, 1, 64, 128, torch.float32, 2,
                                        cuda_device)),
             ("cuda_cores", attn_inputs(1, 2, 1, 64, 96, torch.bfloat16, 3,
                                        cuda_device)),
             ("cuda_cores", sliced(128, 4))]
    for route, (q, k, v) in cases:
        check_route(route, q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_kernel_info_matches_the_plan_and_nothing_spills(cuda_device,
                                                               dtype):
    """The kernel that serves each (dtype, head dim, softcap) reports the
    host's tile plan and no local (spill) bytes."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for D in (32, 64, 96, 128, 256):
        plan = fa.tile_plan(dtype, D)
        for capped in (False, True):
            info = fa.kernel_info(dtype, D, capped)
            assert (info["route"], info["rows"], info["keys"],
                    info["stages"], info["smem_bytes"]) == \
                (plan.route, plan.rows, plan.keys, plan.stages,
                 plan.smem_bytes), (D, capped, info)
            assert info["local_bytes"] == 0, (D, capped, info)
            assert info["max_threads"] >= (384 if plan.route == "tensor_cores"
                                           else 256)


def test_gemma2_serving_on_the_card_matches_the_cpu(cuda_device, fp32_exact):
    """Reduced gemma2-9b (2 layers: local window 64, global; softcaps,
    post-norms), 2 x 160 tokens: prefill through the flash kernel (one
    launch a layer) and 4 decode steps on the card against the same on
    the CPU (plain)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = reduced_config("gemma2-9b")
    host = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 164)))
    caches = {d: M.init_cache(cfg, 2, 164, device=d) for d in ("cpu", "cuda")}
    before = fa.LAUNCHES
    got, caches["cuda"] = M.serve_step(card, cfg, {"tokens": toks[:, :160]
                                                   .to(cuda_device)},
                                       caches["cuda"], 0)
    assert fa.LAUNCHES == before + cfg.n_layers
    want, caches["cpu"] = M.serve_step(host, cfg, {"tokens": toks[:, :160]},
                                       caches["cpu"], 0)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    for j in range(160, 164):
        got, caches["cuda"] = M.serve_step(
            card, cfg, {"tokens": toks[:, j:j + 1].to(cuda_device)},
            caches["cuda"], j)
        want, caches["cpu"] = M.serve_step(
            host, cfg, {"tokens": toks[:, j:j + 1]}, caches["cpu"], j)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))
    assert fa.LAUNCHES == before + cfg.n_layers       # decode: no kernel


# ------------------- the hash's short rows: one warp a row ------------------ #

def lane_matrix(rows, lanes, device, seed=0):
    rng = np.random.default_rng(seed * 7919 + rows * 31 + lanes)
    mat = rng.integers(0, 2 ** 32, size=(rows, lanes), dtype=np.uint32)
    mat[0, lanes // 2:] = 0                       # a zero-padded row
    return torch.from_numpy(mat.view(np.int32)).to(device)


def hash_launches():
    return (checksum.LAUNCHES, checksum.SHORT_ROW_LAUNCHES,
            checksum.LONG_ROW_LAUNCHES)


@pytest.mark.parametrize("rows,lanes", [(1, 1), (7, 31), (9, 33), (64, 259),
                                        (1000, 259), (3, 4096)])
def test_short_row_kernel_matches_plain_version(cuda_device, rows, lanes):
    t = lane_matrix(rows, lanes, cuda_device)
    before = hash_launches()
    got = ops.tensor_checksum_batch(t)
    assert tuple(a - b for a, b in zip(hash_launches(), before)) == (1, 1, 0)
    assert got.dtype == torch.int64 and got.device == t.device
    assert torch.equal(got.cpu(), ref.checksum_lanes_2d(t.cpu()))


@pytest.mark.parametrize("lanes", [4097, 32769])
def test_long_rows_keep_the_block_chunk_kernel(cuda_device, lanes):
    t = lane_matrix(3, lanes, cuda_device)
    before = hash_launches()
    got = ops.tensor_checksum_batch(t)
    assert tuple(a - b for a, b in zip(hash_launches(), before)) == (1, 0, 1)
    assert torch.equal(got.cpu(), ref.checksum_lanes_2d(t.cpu()))


def test_log_waves_and_recovery_take_the_short_row_kernel(cuda_device):
    """1 KiB records on the card: each wave's hash and the recovery scan
    are one short-row launch each."""
    cap = 1 << 18
    dev = PMEMDevice(device_size(cap), mode="fast")
    wal = Log.create(dev, LogConfig(capacity=cap, phash_threshold=256),
                     device=cuda_device)
    waves = [[bytes([w + i]) * 1024 for i in range(64)] for w in range(3)]
    before = hash_launches()
    for wave in waves:
        wal.append_batch(wave)
    relog = Log.open(dev, LogConfig(capacity=cap), device=cuda_device)
    got = [p for _, p in relog.iter_records()]
    moved = tuple(a - b for a, b in zip(hash_launches(), before))
    assert moved[0] == moved[1] >= 3 + 1 and moved[2] == 0, moved
    assert got == [p for w in waves for p in w]


def test_health_monitor_scrubs_and_resyncs_on_the_card(cuda_device):
    """attach_health and recover_backup(resync=True) on a card-hashed
    replica set: bit rot on a backup is found by one short-row launch a
    copy and repaired (one more launch to re-validate), a partitioned
    backup fails over and comes back resynced, its image equal to the
    primary's."""
    from repro_torch.core import HeartbeatConfig, build_replica_set
    from repro_torch.core.log import ring_offset
    rs = build_replica_set(mode="local+remote", capacity=1 << 18,
                           n_backups=2, write_quorum=3, device=cuda_device)
    try:
        rs.log.cfg.phash_threshold = 256
        lsns = [rs.log.append(bytes([i]) * 1024) for i in range(32)]
        rs.group.drain(timeout=5.0)
        hm = rs.attach_health(allow_degraded=True, min_write_quorum=2,
                              heartbeat=HeartbeatConfig(
                                  interval_s=0.01, miss_threshold=2,
                                  backoff_base_s=0.05, jitter=0.0))
        rec = rs.log._recs[lsns[5]]
        rs.servers[1].device.corrupt(rec.off + 24, rec.size,
                                     np.random.default_rng(1), nbits=4)
        before = hash_launches()
        rep = hm.scrubber.scrub_once(force=True)
        moved = tuple(a - b for a, b in zip(hash_launches(), before))
        assert (rep.corrupt, rep.repaired, rep.unrepairable) == (1, 1, 0)
        assert moved == (4, 4, 0)
        rs.transports[0].inject(drop=True)
        now, evs = 0.0, []
        for _ in range(6):
            evs += hm.tick(now)
            now += 0.02
        for i in range(8):
            rs.log.append(bytes([100 + i]) * 1024)
        rs.transports[0].inject()
        for _ in range(12):
            evs += hm.tick(now)
            now += 0.1
        assert ("down", "node1") in evs and ("up", "node1") in evs
        assert rs.group.write_quorum == 3
        rs.log.drain(timeout=5.0)
        rs.group.drain(timeout=5.0)
        n = ring_offset() + rs.cfg.capacity
        ring = rs.primary_dev.read(0, n)
        assert all(s.device.read(0, n) == ring for s in rs.servers)
        assert rs.recover_backup("node2").repair_bytes == 0
    finally:
        rs.shutdown()


# ------------------- the SSD scan on the tensor cores ------------------- #

SSD_BLOCK_TOL = 2.0 ** -6       # per (batch, head, chunk) block of y, bf16


def ssd_launches():
    return (ssd_scan.LAUNCHES, ssd_scan.TENSOR_CORE_LAUNCHES,
            ssd_scan.CUDA_CORE_LAUNCHES)


# bf16 shapes the tensor-core kernel takes: a chunk of 64, H=6 over G=3
# groups, P 96 / N 48, P 16 / N 256 (the widest state), P 128 (its widest
# head), and mamba2-130m's widths in two chunks of 256
TC_SHAPES = [(2, 64, 4, 32, 4, 16, 64), (1, 256, 6, 32, 3, 32, 64),
             (1, 128, 2, 96, 1, 48, 128), (1, 128, 2, 16, 1, 256, 64),
             (1, 256, 2, 128, 1, 64, 128), (2, 512, 24, 64, 1, 128, 256)]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", TC_SHAPES)
def test_ssd_tensor_cores_match_plain_and_the_mirror(cuda_device, fp32_exact,
                                                     B, S, H, P, G, N, chunk):
    """One launch on the tensor-core route.  Against the CPU mirror of its
    three passes, which rounds at the same places and differs only in the
    order of its sums: y within 5e-2 elementwise and 2^-7 per block, the
    state within 2e-3 (the two fp64 decay sums can differ in their last
    bit, which can move a B·dt·decay across a bf16 rounding: a spacing of
    2^-8 of one term).  Against the plain version: y within 2^-6 per
    block and 5e-2 elementwise, the state within 5e-2."""
    args = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, S + H, cuda_device,
                      mixer=N == 128)
    before = ssd_launches()
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (1, 1, 0)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y_m, st_m = ssd_ref.ssd_three_pass_reference(*(a.cpu() for a in args),
                                                 chunk=chunk)
    torch.testing.assert_close(y.cpu().float(), y_m.float(), atol=5e-2,
                               rtol=5e-2)
    assert ssd_ref.chunk_block_rel_err(y.cpu(), y_m, chunk) <= 2.0 ** -7
    torch.testing.assert_close(st.cpu(), st_m, atol=2e-3, rtol=2e-3)
    y_ref, st_ref = ssd_ref.ssd_reference(*args, chunk=chunk)
    assert ssd_ref.chunk_block_rel_err(y, y_ref, chunk) <= SSD_BLOCK_TOL
    torch.testing.assert_close(st, st_ref, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", TC_SHAPES)
def test_ssd_tensor_cores_match_plain_elementwise_at_the_tests_draw(
        cuda_device, fp32_exact, B, S, H, P, G, N, chunk):
    """tests/test_kernels.py's dt and A draw at every tensor-core shape:
    |y| reaches 70 to 80 and some elements lie near 0, where one bf16
    rounding of the score tile (2^-9 of each term) missed 5e-2 + 5e-2·|y|
    by up to 1.53x.  With the tile split into bf16 hi and lo operands y is
    within the reference's bf16 tolerance of the plain version."""
    args = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, S + H, cuda_device)
    before = ssd_launches()
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (1, 1, 0)
    y_ref, st_ref = ssd_ref.ssd_reference(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2,
                               rtol=5e-2)
    torch.testing.assert_close(st, st_ref, atol=5e-2, rtol=5e-2)


def mixer_views(B, S, H, P, G, N, device, pad=0, seed=0):
    """bf16 xh, Bm and Cm as views of one [B, S, H·P + 2·G·N + pad] conv
    output, as models/layers.py's mixer passes them."""
    width = H * P + 2 * G * N
    gen = torch.Generator(device=device).manual_seed(seed)
    conv = torch.randn(B, S, width + pad, device=device,
                       generator=gen).to(torch.bfloat16)
    xi, bv, cv = torch.split(conv[..., :width], [H * P, G * N, G * N], dim=-1)
    return (xi.reshape(B, S, H, P), bv.reshape(B, S, G, N),
            cv.reshape(B, S, G, N))


def test_ssd_tensor_cores_read_the_mixers_views(cuda_device):
    """The mixer's strided views go in without a copy and give the same
    bits as contiguous copies of them."""
    B, S, H, P, G, N = 2, 512, 24, 64, 1, 128
    xh, Bm, Cm = mixer_views(B, S, H, P, G, N, cuda_device)
    _, dt, A, _, _ = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, 3,
                                cuda_device, mixer=True)
    assert not xh.is_contiguous() and xh.stride(1) == H * P + 2 * G * N
    before = ssd_launches()
    a = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=256)
    b = ssd_ops.ssd(xh.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                    chunk=256)
    assert tuple(x - y for x, y in zip(ssd_launches(), before)) == (2, 2, 0)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=0, rtol=0)


def test_ssd_misaligned_views_go_to_the_cuda_cores(cuda_device, fp32_exact):
    """A token stride that is not a multiple of 8 elements: the router
    sends the views to the CUDA-core kernel, whose route gives it
    contiguous copies."""
    B, S, H, P, G, N = 1, 256, 4, 64, 1, 128
    xh, Bm, Cm = mixer_views(B, S, H, P, G, N, cuda_device, pad=1)
    _, dt, A, _, _ = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, 4,
                                cuda_device, mixer=True)
    assert ssd_scan.route(xh, Bm, Cm, 256) == "cuda_cores"
    before = ssd_launches()
    y, st = ssd_ops.ssd(xh, dt, A, Bm, Cm, chunk=256)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (1, 0, 1)
    y_ref, st_ref = ssd_ref.ssd_reference(xh, dt, A, Bm, Cm, chunk=256)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2)
    assert ssd_ref.chunk_block_rel_err(y, y_ref, 256) <= SSD_BLOCK_TOL


def test_ssd_block_check_fails_planted_faults(cuda_device):
    """On the tensor cores at mamba2's widths: the second half of the
    sequence scanned alone, and A_log + ln 2, each miss the plain version
    by more than 8 × 2^-6 in some (batch, head, chunk) block."""
    B, S, H, P, G, N, Q = 1, 1024, 24, 64, 1, 128, 256
    xh, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, 9,
                                   cuda_device, mixer=True)
    y_ref, _ = ssd_ref.ssd_reference(xh, dt, A, Bm, Cm, chunk=Q)
    h = S // 2
    before = ssd_launches()
    half, _ = ssd_ops.ssd(xh[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:],
                          chunk=Q)
    fast, _ = ssd_ops.ssd(xh, dt, A + float(np.log(2.0)), Bm, Cm, chunk=Q)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (2, 2, 0)
    assert ssd_ref.chunk_block_rel_err(half, y_ref[:, h:], Q) > \
        8 * SSD_BLOCK_TOL
    assert ssd_ref.chunk_block_rel_err(fast, y_ref, Q) > 8 * SSD_BLOCK_TOL


def test_ssd_tensor_core_plan_matches_the_host(cuda_device):
    for P, N, Q in ((64, 128, 256), (16, 256, 64), (128, 256, 2048),
                    (96, 48, 128), (128, 256, 256)):
        assert ssd_scan.tc_kernel_plan(P, N, Q) == ssd_scan.tc_plan(P, N, Q)


def test_mamba2_prefill_scans_on_the_tensor_cores(cuda_device):
    """mamba2-130m at full width cut to 2 layers, bf16: each layer's scan
    of a 2 x 512 prefill takes the tensor-core route, and the logits are
    finite and agree in their greedy tokens with the fp32 prefill (CUDA
    cores) of the same params at most positions."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = replace(get_config("mamba2-130m"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 512))).to(cuda_device)
    before = ssd_launches()
    got, _ = M.serve_step(M.cast_params(params, cfg), cfg, {"tokens": toks},
                          None, None)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (2, 2, 0)
    assert torch.isfinite(got.float()).all()
    f32 = replace(cfg, compute_dtype="float32")
    want, _ = M.serve_step(params, f32, {"tokens": toks}, None, None)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (4, 2, 2)
    agree = (got.float().argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) >= 0.9
