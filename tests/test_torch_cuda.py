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
    assert got.dtype == q.dtype and got.shape == (*q.shape[:3], v.shape[-1])
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
    """check_flash, and the one launch went to ``route``'s kernel, as the
    C side reported it to the launch counters."""
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


def pair_inputs(B, H, KV, S, D, Dv, dtype, seed, device):
    """attn_inputs with v's head dim Dv: q [B,H,S,D], k [B,KV,S,D], v
    [B,KV,S,Dv]."""
    q, k, _ = attn_inputs(B, H, KV, S, D, dtype, seed, device)
    v = attn_inputs(B, KV, KV, S, Dv, dtype, seed + 1, device)[2]
    return q, k, v


# the serving pairs besides Dv = D at 128 and 256: hubert-xlarge's D 80
# (two 64-column boxes, the second zero past column 80) and MLA's prefill
# (D 192 over three boxes, Dv 128)
TC_PAIRS = [(128, 128), (256, 256), (80, 80), (192, 128)]
TC_PAIR_IDS = ["128", "256", "80", "192-128"]


@pytest.mark.parametrize("D,Dv", TC_PAIRS, ids=TC_PAIR_IDS)
@pytest.mark.parametrize("kw", list(TC_MASKS.values()), ids=list(TC_MASKS))
def test_flash_tensor_cores_mask_variants(cuda_device, D, Dv, kw):
    """The fp32 mask variants' bf16 twins at the serving pairs: a window of
    16 lies below both key tiles (64 and 128), so some rows' first tiles
    are wholly masked."""
    check_route("tensor_cores", *pair_inputs(1, 4, 2 if Dv == D else 4, 256,
                                             D, Dv, torch.bfloat16, 7,
                                             cuda_device), **kw)


@pytest.mark.parametrize("S", [1, 65, 200, 1000])
@pytest.mark.parametrize("D,Dv", TC_PAIRS, ids=TC_PAIR_IDS)
def test_flash_tensor_cores_ragged_lengths(cuda_device, S, D, Dv):
    """Lengths that no 128-row block or 64/128-key tile divides: keys past
    S weigh nothing and rows past S are not written."""
    check_route("tensor_cores", *pair_inputs(1, 4, 2, S, D, Dv,
                                             torch.bfloat16, S, cuda_device),
                causal=True, window=100)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 4), (14, 2)],
                         ids=["gqa1", "gqa2", "gqa7"])
def test_flash_tensor_cores_gqa_ratios(cuda_device, H, KV):
    check_route("tensor_cores", *attn_inputs(2, H, KV, 160, 128,
                                             torch.bfloat16, H, cuda_device),
                causal=True)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 4), (14, 2)],
                         ids=["gqa1", "gqa2", "gqa7"])
def test_flash_tensor_cores_gqa_ratios_at_mlas_pair(cuda_device, H, KV):
    """GQA ratios at (D 192, Dv 128): query head h reads kv head h // rep
    through the K and V maps."""
    check_route("tensor_cores", *pair_inputs(2, H, KV, 160, 192, 128,
                                             torch.bfloat16, H, cuda_device),
                causal=True, scale=1.0 / float(np.sqrt(192)))


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
    """bf16 at a tensor-core pair (here 128, hubert's 80 and MLA's 192/128)
    with 16-byte aligned strides goes to the tensor cores; fp32, bf16 at
    another pair (D 96; D 96 with Dv 64), and bf16 whose strides are
    multiples of 4 elements but not of 8 (at 128, 80 and 192/128: the
    plan's pair, TMA's rule broken) go to the CUDA cores.  LAUNCHES counts
    both routes."""
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
             ("cuda_cores", sliced(128, 4)),
             ("tensor_cores", sliced(80, 8)),
             ("cuda_cores", sliced(80, 4)),
             ("tensor_cores", sliced(192, 8)[:2] + (sliced(128, 8)[2],)),
             ("cuda_cores", sliced(192, 4)[:2] + (sliced(128, 4)[2],)),
             ("cuda_cores", attn_inputs(1, 2, 1, 64, 96, torch.bfloat16, 4,
                                        cuda_device)[:2]
              + (attn_inputs(1, 2, 1, 64, 64, torch.bfloat16, 4,
                             cuda_device)[2],))]
    for route, (q, k, v) in cases:
        check_route(route, q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_kernel_info_matches_the_plan_and_nothing_spills(cuda_device,
                                                               dtype):
    """The kernel that serves each (dtype, D, Dv, softcap) reports the
    host's tile plan and no local (spill) bytes: every tensor-core pair
    (MLA's 192/128 and hubert's 80 among them) and the CUDA-core widths."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    pairs = sorted(set(fa.TENSOR_CORE_PAIRS) | {(32, 32), (96, 96),
                                                (128, 64)})
    for D, Dv in pairs:
        plan = fa.tile_plan(dtype, D, Dv)
        for capped in (False, True):
            info = fa.kernel_info(dtype, D, capped, v_head_dim=Dv)
            assert (info["route"], info["rows"], info["keys"],
                    info["stages"], info["smem_bytes"]) == \
                (plan.route, plan.rows, plan.keys, plan.stages,
                 plan.smem_bytes), (D, Dv, capped, info)
            assert info["local_bytes"] == 0, (D, Dv, capped, info)
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


# --------------- a value head dim below the key head dim (MLA) --------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,D,Dv", [(1, 4, 4, 200, 192, 128),
                                           (2, 8, 4, 130, 128, 64),
                                           (1, 2, 1, 70, 48, 32)],
                         ids=["mla", "gqa-128-64", "reduced-mla"])
def test_flash_kernel_with_a_narrower_value_head(cuda_device, fp32_exact,
                                                 dtype, B, H, KV, S, D, Dv):
    """v [B,KV,S,Dv] with Dv < D, causal, within the elementwise and row
    tolerances of the plain version: MLA's pair (192, 128) in bf16 on the
    tensor cores; fp32, and bf16 at pairs without a tensor-core kernel
    (128/64, 48/32), on the CUDA cores."""
    q, k, _ = attn_inputs(B, H, KV, S, D, dtype, S + Dv, cuda_device)
    v = attn_inputs(B, KV, KV, S, Dv, dtype, S + D, cuda_device)[2]
    route = "tensor_cores" if dtype == torch.bfloat16 and (D, Dv) == \
        (192, 128) else "cuda_cores"
    check_route(route, q, k, v, causal=True, scale=1.0 / float(np.sqrt(D)))


def test_flash_kernel_reads_mlas_value_view(cuda_device):
    """MLA's prefill passes v as the strided [..., qk_nope:] view of the
    expanded [B,S,H,qk_nope + v] projection (a 256-byte offset) and q, k
    as permuted [B,S,H,D] views: the tensor-core kernel reads them with no
    copy, gives the same bits as contiguous inputs, and a
    [B,S,H,Dv]-laid-out output."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    B, S, H, dn, dr, dv = 2, 150, 4, 128, 64, 128
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)  # noqa: E731
                                    ).to(cuda_device, torch.bfloat16)
    q, k, kv = t(B, S, H, dn + dr), t(B, S, H, dn + dr), t(B, S, H, dn + dv)
    qv, kvw, vv = q.transpose(1, 2), k.transpose(1, 2), \
        kv[..., dn:].transpose(1, 2)
    check_route("tensor_cores", qv, kvw, vv, causal=True)
    a = fa.flash_attention_cuda(qv, kvw, vv, causal=True)
    b = fa.flash_attention_cuda(qv.contiguous(), kvw.contiguous(),
                                vv.contiguous(), causal=True)
    assert a.shape == (B, H, S, dv) and a.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_flash_kernel_reads_huberts_views(cuda_device):
    """hubert's encoder passes q, k, v as permuted views of [B,S,16,80]
    projections (head stride 80 elements, 160 bytes; row stride 1280):
    the tensor-core kernel reads them with no copy, non-causal, and gives
    the same bits as contiguous inputs."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    B, S, H, D = 2, 300, 16, 80
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(
        np.float32)).to(cuda_device, torch.bfloat16).transpose(1, 2)
        for _ in range(3))
    assert q.stride() == (S * H * D, D, H * D, 1)
    check_route("tensor_cores", q, k, v, causal=False)
    a = fa.flash_attention_cuda(q, k, v, causal=False)
    b = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=False)
    assert a.shape == (B, H, S, D) and a.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("D,Dv", [(80, 80), (192, 128)], ids=["80", "192-128"])
def test_flash_tensor_core_launch_that_fails_raises(cuda_device, monkeypatch,
                                                    D, Dv):
    """No fallback: when the C side reports a failed launch on the
    tensor-core route, the wrapper raises and counts nothing; it never
    re-runs the inputs on the CUDA cores."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import flash_attention as fa

    lib = nvcc.load(fa.SOURCE, fa._bind)

    class Refusing:
        """The library, with a launch that fails on the tensor cores."""
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def arcadia_flash_attention(*args):
            args[-1]._obj.value = 1                  # route: tensor cores
            return 1                                 # cudaErrorInvalidValue

    q, k, v = pair_inputs(1, 2, 2, 64, D, Dv, torch.bfloat16, 0, cuda_device)
    assert fa.tile_plan(q.dtype, D, Dv).route == "tensor_cores"
    monkeypatch.setattr(nvcc, "load", lambda source, bind: Refusing())
    before = (fa.LAUNCHES, fa.TENSOR_CORE_LAUNCHES, fa.CUDA_CORE_LAUNCHES)
    with pytest.raises(RuntimeError, match="route 1"):
        fa.flash_attention_cuda(q, k, v, causal=True)
    assert (fa.LAUNCHES, fa.TENSOR_CORE_LAUNCHES,
            fa.CUDA_CORE_LAUNCHES) == before


def test_flash_kernel_refuses_a_value_head_wider_than_the_key_head(
        cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, _ = attn_inputs(1, 2, 2, 64, 64, torch.float32, 0, cuda_device)
    before = fa.LAUNCHES
    wide = attn_inputs(1, 2, 2, 64, 68, torch.float32, 1, cuda_device)[2]
    for v in (wide, wide[..., :62]):                 # above D; not 4·k
        with pytest.raises(ValueError, match="v head dim"):
            fa_ops.flash_attention(q, k, v)
    v = attn_inputs(1, 2, 2, 32, 64, torch.float32, 1, cuda_device)[2]
    with pytest.raises(ValueError, match="shapes disagree"):
        fa_ops.flash_attention(q, k, v)              # another length
    assert fa.LAUNCHES == before


# ---------------------- MoE and the new model families ---------------------- #

def moe_inputs(cfg, device, dtype, seed=0):
    from repro_torch.models import layers as L

    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return torch.from_numpy((rng.normal(size=node) * 0.2)
                                .astype(np.float32)).to(device, dtype)
    x = torch.from_numpy(rng.normal(size=(2, 96, cfg.d_model))
                         .astype(np.float32)).to(device, dtype)
    return x, draw(L.moe_params_shapes(cfg))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0],
                         ids=["dropless", "dropping"])
def test_moe_ffn_on_the_card_matches_the_cpu_and_repeats_bitwise(
        cuda_device, fp32_exact, capacity_factor):
    """Reduced deepseek-v3's MoE (8 experts, top-3, a shared expert): in
    fp32 the card's output equals the CPU's within 1e-5 (the same products
    summed in another order) with the same aux; in bf16 two runs on the
    card give the same bits (the combine adds each token's contributions
    in a fixed order: no atomics)."""
    from dataclasses import replace

    from repro_torch.configs import reduced_config
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_map

    cfg = replace(reduced_config("deepseek-v3-671b"),
                  capacity_factor=capacity_factor)
    x, p = moe_inputs(cfg, "cpu", torch.float32)
    want, want_aux = L.moe_ffn(x, p, cfg)
    got, aux = L.moe_ffn(x.to(cuda_device),
                         tree_map(lambda t: t.to(cuda_device), p), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)
    xb, pb = moe_inputs(cfg, cuda_device, torch.bfloat16)
    first, _ = L.moe_ffn(xb, pb, cfg)
    second, _ = L.moe_ffn(xb, pb, cfg)
    assert torch.equal(first, second)


def family_card_vs_cpu(name, batch, prefill, decode_tokens, cuda_device):
    """Reduced ``name`` on the card (kernel) and the CPU (plain): the
    prefill's logits within 2e-4 with one flash launch per attention layer,
    then each decode token within 2e-3 with the same greedy token and no
    launch (a ``None`` prefill length: one cache-less forward)."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = reduced_config(name)
    host = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), host)
    on = lambda b: {k: v.to(cuda_device) for k, v in b.items()}  # noqa: E731
    attn_layers = sum(k.mixer == "attn" for k in cfg.block_pattern()) \
        * cfg.n_blocks + cfg.first_dense_layers
    before = fa.LAUNCHES
    if prefill is None:
        got, _ = M.serve_step(card, cfg, on(batch), None, None)
        want, _ = M.serve_step(host, cfg, batch, None, None)
        torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
        assert fa.LAUNCHES == before + attn_layers
        return
    T = prefill + len(decode_tokens)
    caches = {d: M.init_cache(cfg, 2, T, device=d) for d in ("cpu", "cuda")}
    got, caches["cuda"] = M.serve_step(card, cfg, on(batch), caches["cuda"], 0)
    want, caches["cpu"] = M.serve_step(host, cfg, batch, caches["cpu"], 0)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-4)
    assert fa.LAUNCHES == before + attn_layers
    for j, tok in enumerate(decode_tokens):
        got, caches["cuda"] = M.serve_step(card, cfg, on({"tokens": tok}),
                                           caches["cuda"], prefill + j)
        want, caches["cpu"] = M.serve_step(host, cfg, {"tokens": tok},
                                           caches["cpu"], prefill + j)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))
    assert fa.LAUNCHES == before + attn_layers        # decode: no kernel


def test_deepseek_serving_on_the_card_matches_the_cpu(cuda_device, fp32_exact):
    """Reduced deepseek-v3 (a dense MLA layer, an MLA + MoE layer; q/k
    head dim 48, v 32): the prefill's MLA attention on the CUDA-core
    kernel with Dv < D, the absorbed decode on the direct path."""
    from repro_torch.configs import reduced_config

    V = reduced_config("deepseek-v3-671b").vocab_size
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, V, (2, 164)))
    family_card_vs_cpu("deepseek-v3-671b", {"tokens": toks[:, :160]}, 160,
                       [toks[:, j:j + 1] for j in range(160, 164)],
                       cuda_device)


def test_llava_serving_on_the_card_matches_the_cpu(cuda_device, fp32_exact):
    """Reduced llava-next: 16 patch embeddings before 144 tokens."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config("llava-next-34b")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 148)))
    patches = torch.from_numpy(rng.normal(size=(2, 16, cfg.frontend_dim))
                               .astype(np.float32))
    family_card_vs_cpu("llava-next-34b",
                       {"patches": patches, "tokens": toks[:, :144]}, 160,
                       [toks[:, j:j + 1] for j in range(144, 148)],
                       cuda_device)


def test_hubert_forward_on_the_card_matches_the_cpu(cuda_device, fp32_exact):
    """Reduced hubert: a non-causal forward over 200 frame embeddings."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config("hubert-xlarge")
    frames = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 200, cfg.frontend_dim)).astype(np.float32))
    family_card_vs_cpu("hubert-xlarge", {"frames": frames}, None, [],
                       cuda_device)


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
    sends the views to the CUDA-core route's kernel, which reads them
    through their strides."""
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


# ----------------------------- SSD backward ------------------------------ #

BWD_SHAPES = [(2, 64, 4, 32, 2, 16, 16), (1, 128, 2, 64, 1, 32, 32),
              (1, 96, 6, 16, 2, 16, 32), (1, 64, 2, 16, 1, 64, 64),
              (1, 512, 24, 64, 1, 128, 256)]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def bwd_inputs(B, S, H, P, G, N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mixer = N == 128
    t = lambda a, d=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device).to(d)
    dt = rng.uniform(1e-3, 0.1, (B, S, H)) if mixer else \
        rng.uniform(0.05, 0.9, (B, S, H))
    A = np.log(rng.uniform(1.0, 16.0, H)) if mixer else \
        rng.uniform(-1.0, 0.5, H)
    args = (t(rng.standard_normal((B, S, H, P)), dtype), t(dt), t(A),
            t(rng.standard_normal((B, S, G, N)), dtype),
            t(rng.standard_normal((B, S, G, N)), dtype))
    return args, t(rng.standard_normal((B, S, H, P)), dtype), \
        t(rng.standard_normal((B, H, P, N)))


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_ssd_backward_kernel_matches_plain(cuda_device, fp32_exact, shape,
                                           dtype, with_dstate):
    """The gradient through ``ops.ssd`` on the card (forward kernel, then one
    backward launch) against the plain chunked backward and torch.autograd
    through the plain scan, within 1e-4 (fp32) / 5e-2 (bf16) of each
    gradient's largest value; a second call repeats it bitwise."""
    *dims, chunk = shape
    args, dy, ds = bwd_inputs(*dims, dtype, cuda_device, seed=sum(shape))
    ds = ds if with_dstate else None

    def grads(scan):
        leaves = [a.detach().requires_grad_() for a in args]
        y, st = scan(*leaves, chunk=chunk)
        outs, cots = ((y, st), (dy, ds)) if ds is not None else ((y,), (dy,))
        return torch.autograd.grad(outs, leaves, cots)

    before = ssd_scan.BACKWARD_LAUNCHES
    got, again = grads(ssd_ops.ssd), grads(ssd_ops.ssd)
    assert ssd_scan.BACKWARD_LAUNCHES == before + 2
    for g, h, a in zip(got, again, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        assert torch.equal(g, h)
    tol = BWD_TOL[dtype]
    for want in (ssd_ref.ssd_backward_reference(*args, dy, ds, chunk),
                 grads(ssd_ref.ssd_reference)):
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        assert max(errs) <= tol, errs


@pytest.mark.parametrize("seed", [1, 9])
def test_ssd_backward_of_fp32_is_near_float64(cuda_device, fp32_exact, seed):
    """In fp32 the kernel is about as close to a float64 gradient as the
    plain chunked backward: within 4x its distance or 2e-5 of each
    gradient's largest value.  At seed 1 (two heads, a d(state)) dA_log is
    a sum whose terms cancel: the plain fp32 version is 1.2e-4 (CPU) to
    1.4e-4 (card) from float64 there and the kernel 1.8e-4, past the 1e-4
    that two fp32 versions are held to elsewhere."""
    shape = (1, 128, 2, 64, 1, 32, 32)
    *dims, chunk = shape
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(cuda_device)
    B, S, H, P, G, N = dims
    dt, A = f(rng.uniform(0.05, 0.9, (B, S, H))), f(rng.uniform(-1.0, 0.5, H))
    args = (f(rng.standard_normal((B, S, H, P))), dt, A,
            f(rng.standard_normal((B, S, G, N))),
            f(rng.standard_normal((B, S, G, N))))
    dy, ds = f(rng.standard_normal((B, S, H, P))), \
        f(rng.standard_normal((B, H, P, N)))
    got = ssd_scan.ssd_backward_cuda(*args, dy, ds, chunk)
    plain = ssd_ref.ssd_backward_reference(*args, dy, ds, chunk)
    exact = ssd_ref.ssd_backward_reference(
        *(a.double() for a in args), dy.double(), ds.double(), chunk)
    for g, p, e in zip(got, plain, exact):
        assert rel_err(g, e) <= max(4 * rel_err(p, e), 2e-5)


def test_ssd_backward_reads_the_mixers_views(cuda_device):
    """xh, Bm and Cm as views of one conv output (the mixer's split): the
    gradient equals the one of contiguous copies, bitwise."""
    B, S, H, P, G, N, Q = 2, 256, 4, 64, 1, 128, 128
    args, dy, _ = bwd_inputs(B, S, H, P, G, N, torch.bfloat16, cuda_device)
    xh, dt, A, Bm, Cm = args
    conv = torch.cat([xh.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                      Cm.reshape(B, S, G * N)], dim=-1)
    xi, bv, cv = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    views = (xi.reshape(B, S, H, P), dt, A, bv.reshape(B, S, G, N),
             cv.reshape(B, S, G, N))
    got = ssd_scan.ssd_backward_cuda(*views, dy, None, Q)
    want = ssd_scan.ssd_backward_cuda(*args, dy, None, Q)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_backward_planted_faults_fail(cuda_device):
    """The gradient of each half of the sequence alone (no adjoint from the
    second half; no state from the first) misses the whole gradient by more
    than the bf16 tolerance, in dxh and dCm respectively."""
    B, S, H, P, G, N, Q = 1, 1024, 24, 64, 1, 128, 256
    args, dy, _ = bwd_inputs(B, S, H, P, G, N, torch.bfloat16, cuda_device)
    xh, dt, A, Bm, Cm = args
    whole = ssd_scan.ssd_backward_cuda(*args, dy, None, Q)
    h = S // 2
    first = ssd_scan.ssd_backward_cuda(xh[:, :h], dt[:, :h].contiguous(), A,
                                       Bm[:, :h], Cm[:, :h], dy[:, :h], None,
                                       Q)
    second = ssd_scan.ssd_backward_cuda(xh[:, h:], dt[:, h:].contiguous(), A,
                                        Bm[:, h:], Cm[:, h:], dy[:, h:], None,
                                        Q)
    assert rel_err(first[0], whole[0][:, :h]) > BWD_TOL[torch.bfloat16]
    assert rel_err(second[4], whole[4][:, h:]) > BWD_TOL[torch.bfloat16]


def test_ssd_backward_plan_matches_the_host(cuda_device):
    for P, N, Q in ((64, 128, 256), (16, 16, 16), (128, 192, 128),
                    (32, 64, 96)):
        assert ssd_scan.bwd_kernel_plan(P, N, Q, torch.float32) == \
            ssd_scan.bwd_plan(P, N, Q, torch.float32)


# ------------------ SSD backward on the tensor cores --------------------- #

# BWD_SHAPES' bf16 shapes whose chunk is 64·k, two groups at a chunk of 64,
# jamba's groups (G 8, two heads each) over two chunks, and the widest P
# and N the route takes over two chunks of 128
TC_BWD_SHAPES = [(1, 64, 2, 16, 1, 64, 64), (2, 64, 4, 32, 2, 16, 64),
                 (1, 512, 24, 64, 1, 128, 256), (2, 512, 16, 64, 8, 128, 256),
                 (1, 256, 4, 128, 2, 256, 128)]


def bwd_route_counts():
    return (ssd_scan.BACKWARD_TENSOR_CORE_LAUNCHES,
            ssd_scan.BACKWARD_CUDA_CORE_LAUNCHES)


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("layout", ["contiguous", "mixer views"])
@pytest.mark.parametrize("shape", TC_BWD_SHAPES, ids=str)
def test_ssd_backward_tensor_cores_match_plain_and_mirror(
        cuda_device, fp32_exact, shape, layout, with_dstate):
    """The tensor-core backward (one launch of its route) against the plain
    chunked backward, its CPU mirror run on the card and a float64
    gradient, within 5e-2 of each gradient's largest value; a second call
    repeats it bitwise."""
    *dims, chunk = shape
    args, dy, ds = bwd_inputs(*dims, torch.bfloat16, cuda_device,
                              seed=2 * sum(shape) + with_dstate)
    ds = ds if with_dstate else None
    xh, dt, A, Bm, Cm = args
    if layout == "mixer views":
        xh, Bm, Cm = mixer_views(*dims, cuda_device, seed=sum(shape))
    a = (xh, dt, A, Bm, Cm)
    assert ssd_scan.backward_route(xh, Bm, Cm, dy, chunk) == "tensor_cores"
    tc, cc = bwd_route_counts()
    got = ssd_scan.ssd_backward_cuda(*a, dy, ds, chunk)
    again = ssd_scan.ssd_backward_cuda(*a, dy, ds, chunk)
    assert bwd_route_counts() == (tc + 2, cc)
    for g, h, t in zip(got, again, args):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.equal(g, h)
    tol = BWD_TOL[torch.bfloat16]
    for want in (ssd_ref.ssd_backward_reference(*a, dy, ds, chunk),
                 ssd_ref.ssd_backward_tc_reference(*a, dy, ds, chunk),
                 ssd_ref.ssd_backward_reference(
                     *(t.double() for t in a), dy.double(),
                     None if ds is None else ds.double(), chunk)):
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        assert max(errs) <= tol, errs


def test_ssd_backward_tensor_cores_planted_faults_fail(cuda_device):
    """The mirror with a group's first head summed twice (dBm) or with the
    adjoint not carried across chunks (dxh) misses the kernel's gradient by
    more than the bf16 tolerance, where the faithful mirror is within it;
    at one chunk without d(state) the kernel's ddt (an fp32 output) is
    within 1e-4 of float64, which the mirror without its lo operands is
    not."""
    B, S, H, P, G, N, Q = 1, 512, 24, 64, 1, 128, 256
    args, dy, ds = bwd_inputs(B, S, H, P, G, N, torch.bfloat16, cuda_device,
                              seed=5)
    got = ssd_scan.ssd_backward_cuda(*args, dy, ds, Q)
    tol = BWD_TOL[torch.bfloat16]
    mirror = ssd_ref.ssd_backward_tc_reference(*args, dy, ds, Q)
    assert max(rel_err(g, w) for g, w in zip(got, mirror)) <= tol
    for fault, k in (("head summed twice", 3), ("adjoint dropped", 0)):
        bad = ssd_ref.ssd_backward_tc_reference(*args, dy, ds, Q, fault=fault)
        assert rel_err(got[k], bad[k]) > tol, fault
    one, dy1, _ = bwd_inputs(1, 256, H, P, G, N, torch.bfloat16, cuda_device,
                             seed=6)
    exact = ssd_ref.ssd_backward_reference(*(t.double() for t in one),
                                           dy1.double(), None, Q)
    got1 = ssd_scan.ssd_backward_cuda(*one, dy1, None, Q)
    assert rel_err(got1[1], exact[1]) <= 1e-4
    no_lo = ssd_ref.ssd_backward_tc_reference(
        *(t.float() for t in one), dy1.float(), None, Q, fault="lo dropped")
    assert rel_err(no_lo[1], exact[1]) > 1e-4


def test_ssd_backward_tc_plan_matches_the_host(cuda_device):
    for P, N, Q in ((64, 128, 256), (16, 16, 64), (128, 256, 256),
                    (48, 80, 128), (128, 256, 512)):
        assert ssd_scan.bwd_tc_kernel_plan(P, N, Q) == \
            ssd_scan.bwd_tc_plan(P, N, Q)


def test_ssd_backward_tc_launches_do_not_spill(cuda_device):
    for P, N in ((64, 128), (128, 256), (16, 16)):
        info = ssd_scan.bwd_tc_kernel_info(P, N)
        assert [r["launch"] for r in info] == \
            list(ssd_scan.BWD_LAUNCH_NAMES)
        assert all(r["local_bytes"] == 0 for r in info), info


def test_ssd_backward_bf16_off_the_tensor_cores_is_the_cuda_core_result(
        cuda_device):
    """bf16 inputs the route sends to the CUDA cores (xh, or dy, 2 bytes off
    16-byte alignment) take one CUDA-core launch each and give the same
    bits either way; both are within 5e-2 of the tensor-core gradient of
    the same values and of the plain chunked backward."""
    B, S, H, P, G, N, Q = 1, 256, 4, 64, 1, 128, 128
    args, dy, ds = bwd_inputs(B, S, H, P, G, N, torch.bfloat16, cuda_device,
                              seed=8)
    xh, dt, A, Bm, Cm = args

    def shifted(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        return v.view(t.shape).copy_(t)
    odd_x, odd_dy = shifted(xh), shifted(dy)
    assert ssd_scan.backward_route(odd_x, Bm, Cm, dy, Q) == "cuda_cores"
    assert ssd_scan.backward_route(xh, Bm, Cm, odd_dy, Q) == "cuda_cores"
    tc, cc = bwd_route_counts()
    g1 = ssd_scan.ssd_backward_cuda(odd_x, dt, A, Bm, Cm, dy, ds, Q)
    g2 = ssd_scan.ssd_backward_cuda(*args, odd_dy, ds, Q)
    assert bwd_route_counts() == (tc, cc + 2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    on_tc = ssd_scan.ssd_backward_cuda(*args, dy, ds, Q)
    assert bwd_route_counts() == (tc + 1, cc + 2)
    for want in (on_tc, ssd_ref.ssd_backward_reference(*args, dy, ds, Q)):
        errs = [rel_err(g, w) for g, w in zip(g1, want)]
        assert max(errs) <= BWD_TOL[torch.bfloat16], errs


# -------------- the SSD scan's CUDA-core route (mma.sync) ---------------- #

# fp32 shapes of the route: a chunk of 16 over G = 2, one ragged chunk of
# 100 tokens and two chunks of 256 at mamba2-130m's widths, widths that are
# not multiples of 16, and the widest head and state
SPLIT_SHAPES = [(2, 64, 4, 32, 2, 16, 16), (1, 100, 24, 64, 1, 128, 256),
                (1, 512, 24, 64, 1, 128, 256), (1, 96, 4, 20, 2, 24, 48),
                (1, 256, 4, 128, 2, 256, 128)]
# Against the split mirror (the same TF32 products, fp32 sums in another
# order, no truncation in the tensor cores' sums): chip_smoke.py's SSD
# phases put the kernels at most 4.7e-7 (scan) and 2.7e-6 (gradient) of
# the largest value from it
SPLIT_TOL = 1e-5


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_ssd_cuda_core_scan_matches_the_split_mirror(cuda_device, fp32_exact,
                                                    shape):
    """One launch of the route (three kernels) in fp32: y and the state
    within SPLIT_TOL of the largest value of ``ref.ssd_split_reference``
    run on the card, and within 1e-4 of the plain version."""
    *dims, chunk = shape
    args = ssd_inputs(*dims, torch.float32, sum(shape), cuda_device,
                      mixer=dims[5] == 128)
    assert ssd_scan.route(args[0], args[3], args[4], chunk) == "cuda_cores"
    before = ssd_launches()
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    assert tuple(a - b for a, b in zip(ssd_launches(), before)) == (1, 0, 1)
    y_m, st_m = ssd_ref.ssd_split_reference(*args, chunk=chunk)
    assert rel_err(y, y_m) <= SPLIT_TOL and rel_err(st, st_m) <= SPLIT_TOL
    y_p, st_p = ssd_ref.ssd_reference(*args, chunk=chunk)
    assert rel_err(y, y_p) <= 1e-4 and rel_err(st, st_p) <= 1e-4


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_ssd_cuda_core_backward_matches_the_split_mirror(
        cuda_device, fp32_exact, shape, with_dstate):
    """The route's gradient in fp32 within SPLIT_TOL of each gradient's
    largest value from ``ref.ssd_backward_split_reference`` on the card; a
    second call repeats it bitwise."""
    *dims, chunk = shape
    args, dy, ds = bwd_inputs(*dims, torch.float32, cuda_device,
                              seed=3 * sum(shape) + with_dstate)
    ds = ds if with_dstate else None
    assert ssd_scan.backward_route(args[0], args[3], args[4], dy, chunk) == \
        "cuda_cores"
    tc, cc = bwd_route_counts()
    got = ssd_scan.ssd_backward_cuda(*args, dy, ds, chunk)
    again = ssd_scan.ssd_backward_cuda(*args, dy, ds, chunk)
    assert bwd_route_counts() == (tc, cc + 2)
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    want = ssd_ref.ssd_backward_split_reference(*args, dy, ds, chunk)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    assert max(errs) <= SPLIT_TOL, errs


@pytest.mark.parametrize("shape", [(1, 64, 2, 32, 1, 16, 16),
                                   (1, 100, 24, 64, 1, 128, 256),
                                   (1, 96, 4, 20, 2, 24, 48)], ids=str)
def test_ssd_cuda_core_bf16_keeps_the_tensor_core_roundings(
        cuda_device, fp32_exact, shape):
    """bf16 the tensor-core route refuses (a chunk of 16, 100 tokens,
    widths that are not multiples of 16) against the CPU mirror of the
    tensor-core passes, whose roundings this route keeps: y within 5e-2
    elementwise and 2^-7 per block, the state within 2e-3; the gradient
    within 5e-2 of each gradient's largest value of the tensor-core
    backward's mirror."""
    *dims, chunk = shape
    args = ssd_inputs(*dims, torch.bfloat16, sum(shape), cuda_device,
                      mixer=dims[5] == 128)
    assert ssd_scan.route(args[0], args[3], args[4], chunk) == "cuda_cores"
    y, st = ssd_ops.ssd(*args, chunk=chunk)
    y_m, st_m = ssd_ref.ssd_three_pass_reference(*(a.cpu() for a in args),
                                                 chunk=chunk)
    torch.testing.assert_close(y.cpu().float(), y_m.float(), atol=5e-2,
                               rtol=5e-2)
    assert ssd_ref.chunk_block_rel_err(y.cpu(), y_m, chunk) <= 2.0 ** -7
    torch.testing.assert_close(st.cpu(), st_m, atol=2e-3, rtol=2e-3)
    bargs, dy, ds = bwd_inputs(*dims, torch.bfloat16, cuda_device,
                               seed=sum(shape))
    got = ssd_scan.ssd_backward_cuda(*bargs, dy, ds, chunk)
    want = ssd_ref.ssd_backward_tc_reference(*bargs, dy, ds, chunk)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BWD_TOL[torch.bfloat16], errs


def test_ssd_cuda_core_route_reads_views(cuda_device, fp32_exact):
    """fp32 xh, Bm and Cm as views of one conv output (the mixer's split)
    go in without a copy: the scan and its gradient equal those of
    contiguous copies, bitwise."""
    B, S, H, P, G, N, Q = 2, 512, 24, 64, 1, 128, 256
    args, dy, ds = bwd_inputs(B, S, H, P, G, N, torch.float32, cuda_device,
                              seed=4)
    xh, dt, A, Bm, Cm = args
    conv = torch.cat([xh.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
                      Cm.reshape(B, S, G * N)], dim=-1)
    xi, bv, cv = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    views = (xi.reshape(B, S, H, P), dt, A, bv.reshape(B, S, G, N),
             cv.reshape(B, S, G, N))
    assert not views[0].is_contiguous()
    for u, v in zip(ssd_ops.ssd(*views, chunk=Q), ssd_ops.ssd(*args, chunk=Q)):
        assert torch.equal(u, v)
    for u, v in zip(ssd_scan.ssd_backward_cuda(*views, dy, ds, Q),
                    ssd_scan.ssd_backward_cuda(*args, dy, ds, Q)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_gradient_of_a_reduction_of_a_transposed_view(
        cuda_device, fp32_exact, dtype, reduce):
    """``y.sum()`` / ``y.mean()`` hand the backward an expanded cotangent
    (every stride 0) and xh comes as a transposed view (its last dimension
    strided): the CUDA-core routes copy those two and read the rest as they
    are.  The scan matches the plain version within 1e-4 (fp32) / 5e-2
    (bf16) and, in fp32, a contiguous copy's scan bitwise; the gradient
    matches plain autograd within the same tolerances of each gradient's
    largest value."""
    B, S, H, P, G, N, Q = 2, 128, 4, 32, 1, 64, 64
    args, _, _ = bwd_inputs(B, S, H, P, G, N, dtype, cuda_device, seed=11)
    xt = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    assert xt.stride(3) != 1 and torch.equal(xt, args[0])
    assert ssd_scan.route(xt, args[3], args[4], Q) == "cuda_cores"
    tol = BWD_TOL[dtype]
    got = ssd_ops.ssd(xt, *args[1:], chunk=Q)
    for g, w in zip(got, ssd_ref.ssd_reference(*args, chunk=Q)):
        assert rel_err(g, w) <= tol
    if dtype == torch.float32:
        for g, w in zip(got, ssd_ops.ssd(*args, chunk=Q)):
            assert torch.equal(g, w)

    def grads(scan, x):
        leaves = [x.detach().requires_grad_()] + \
            [a.detach().requires_grad_() for a in args[1:]]
        y, _ = scan(*leaves, chunk=Q)
        getattr(y, reduce)().backward()
        return [t.grad for t in leaves]

    tc, cc = bwd_route_counts()
    got = grads(ssd_ops.ssd, xt)
    assert bwd_route_counts() == (tc, cc + 1)
    want = grads(ssd_ref.ssd_reference, args[0])
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    assert max(errs) <= tol, errs


def test_ssd_cuda_core_plans_match_the_host(cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        for P, N, Q in ((64, 128, 256), (16, 16, 16), (128, 256, 256),
                        (20, 24, 100), (128, 192, 2048)):
            assert ssd_scan.kernel_plan(P, N, Q, dtype) == \
                ssd_scan.plan(P, N, Q, dtype)
            assert ssd_scan.bwd_kernel_plan(P, N, Q, dtype) == \
                ssd_scan.bwd_plan(P, N, Q, dtype)


def test_ssd_cuda_core_launches_do_not_spill(cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        for P in (16, 20, 64, 128):
            info = ssd_scan.kernel_info(P, dtype)
            assert [r["launch"] for r in info] == list(ssd_scan.LAUNCH_NAMES)
            assert all(r["local_bytes"] == 0 for r in info), info
        for P, N in ((64, 128), (128, 256), (16, 16), (20, 24)):
            info = ssd_scan.bwd_kernel_info(P, N, dtype)
            assert [r["launch"] for r in info] == \
                list(ssd_scan.BWD_LAUNCH_NAMES)
            assert all(r["local_bytes"] == 0 for r in info), info


def test_attention_refuses_a_gradient_on_the_card(cuda_device, fp32_exact):
    """A CUDA prefill that needs a gradient no longer raises: it runs the
    flash forward with its lse and the flash backward kernels (never the
    plain strategies on the card), and its grads match the CPU's."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import layers as L

    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 64, 2, 2, 64), (1, 64, 2, 64), (1, 64, 2, 64))]
    grads = []
    for dev in (cuda_device, "cpu"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in arrs]
        before = (fa.LAUNCHES, fa.BACKWARD_LAUNCHES)
        L.attention(*leaves).square().sum().backward()
        moved = (fa.LAUNCHES - before[0], fa.BACKWARD_LAUNCHES - before[1])
        assert moved == ((1, 1) if dev != "cpu" else (0, 0)), moved
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert L.attention(*(torch.from_numpy(a).to(cuda_device)
                             for a in arrs)).shape == (1, 64, 2, 2, 64)


# ------------------------ flash attention backward ------------------------ #

# per row of each gradient, |kernel - plain| over the row's largest |plain|
# (the forward's bounds) — but no smaller than 2^-8 of the gradient's
# largest value: dq's row at a query that sees one key cancels to round-off
# (dP - delta = dO·v - dO·o with o = v), and the round-off of the two sides
# scales with the products summed, not with the row's result
BWD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
BWD_ROW_FLOOR = 2.0 ** -8
BWD_OPTIONS = [dict(causal=True), dict(causal=False),
               dict(causal=True, window=48), dict(causal=True, cap=30.0),
               dict(causal=True, window=16, cap=20.0),
               dict(causal=False, window=40)]
BWD_PAIRS = [(32, 32), (64, 64), (80, 80), (128, 128), (192, 128),
             (256, 256), (48, 24)]


def grad_row_err(got, want) -> float:
    got, want = got.float(), want.float()
    den = want.abs().amax(-1).clamp_min(BWD_ROW_FLOOR * float(
        want.abs().max())).clamp_min(1e-30)
    return float(((got - want).abs().amax(-1) / den).max())


def flash_bwd_inputs(B, H, KV, S, D, Dv, dtype, seed, device, q_mul=2.0):
    """q, k, v and dO from numpy's normal draw (q scaled so that a softcap
    of 20-30 is reached)."""
    rng = np.random.default_rng(seed)
    out = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           .to(device=device, dtype=dtype)
           for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, Dv),
                     (B, H, S, Dv))]
    out[0] = (out[0].float() * q_mul).to(dtype)
    return out


def flash_grads(q, k, v, do, **kw):
    """o, lse and (dq, dk, dv) through the kernels: one forward launch,
    one backward call of three launches."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    before = (fa.LAUNCHES, fa.BACKWARD_LAUNCHES, fa.BACKWARD_CALL_LAUNCHES)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    grads = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert (fa.LAUNCHES - before[0], fa.BACKWARD_LAUNCHES - before[1],
            fa.BACKWARD_CALL_LAUNCHES - before[2]) == (1, 1, 3)
    return o, lse, grads


def check_backward(q, k, v, do, **kw):
    """The kernels' gradients against the plain backward on the same
    inputs (o and lse from the kernel), each row within BWD_ROW_TOL."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    o, lse, grads = flash_grads(q, k, v, do, **kw)
    want = fa_ref.attention_backward_reference(q, k, v, o, lse, do, **kw)
    for name, g, w, t in zip(("dq", "dk", "dv"), grads, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_err(g, w)
        assert err <= BWD_ROW_TOL[q.dtype], (name, err, kw)
    return o, lse, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,Dv", BWD_PAIRS)
def test_flash_backward_matches_plain_version(cuda_device, fp32_exact, D, Dv,
                                              dtype):
    """Every head width the kernels are built for (and MLA's, hubert's and
    a Dv < D pair off the tensor cores), every option, GQA 4 over 2, a
    length that no tile divides."""
    for n, kw in enumerate(BWD_OPTIONS):
        check_backward(*flash_bwd_inputs(2, 4, 2, 200, D, Dv, dtype, D + n,
                                   cuda_device), **kw)


@pytest.mark.parametrize("S", [2, 31, 65, 129])
def test_flash_backward_ragged_lengths(cuda_device, fp32_exact, S):
    """Lengths no tile divides.  Not causal, so that no row sees a single
    key (whose dq is round-off: see BWD_ROW_FLOOR) at S = 2."""
    check_backward(*flash_bwd_inputs(1, 4, 1, S, 64, 64, torch.float32, S,
                                     cuda_device, q_mul=1.0),
                   causal=False, window=40)


def test_flash_backward_of_one_token(cuda_device, fp32_exact):
    """One token sees one key: p = 1, so dv is the group's sum of dO and
    dq, dk vanish but for round-off (dP - delta = dO·v - dO·o, o = v)."""
    q, k, v, do = flash_bwd_inputs(1, 4, 2, 1, 64, 64, torch.float32, 1,
                                   cuda_device)
    _, _, (dq, dk, dv) = flash_grads(q, k, v, do, causal=True)
    torch.testing.assert_close(dv, do.view(1, 2, 2, 1, 64).sum(2), atol=1e-6,
                               rtol=1e-6)
    assert float(dq.abs().max()) <= 1e-5 and float(dk.abs().max()) <= 1e-5


def test_flash_backward_lse_matches_plain_version(cuda_device, fp32_exact):
    """Both forward kernels' lse (tensor cores at their pairs in bf16, CUDA
    cores in fp32) against the plain log-sum-exp of the same scores."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    for dtype, pairs in ((torch.bfloat16, fa.TENSOR_CORE_PAIRS),
                         (torch.float32, [(64, 64), (256, 256), (192, 128)])):
        for (D, Dv), kw in zip(pairs, BWD_OPTIONS):
            q, k, v, _ = flash_bwd_inputs(1, 4, 2, 300, D, Dv, dtype, D,
                                    cuda_device)
            before = (fa.TENSOR_CORE_LAUNCHES, fa.CUDA_CORE_LAUNCHES)
            _, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            route = (fa.TENSOR_CORE_LAUNCHES - before[0],
                     fa.CUDA_CORE_LAUNCHES - before[1])
            assert route == ((1, 0) if dtype == torch.bfloat16 else (0, 1))
            want = fa_ref.attention_lse_reference(q, k, **kw)
            assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
            torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


def test_flash_forward_unchanged_by_the_lse(cuda_device):
    """Serving's launch (no lse) and training's give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for dtype, D, Dv in ((torch.bfloat16, 256, 256), (torch.bfloat16, 192, 128),
                         (torch.float32, 128, 128)):
        q, k, v, _ = flash_bwd_inputs(2, 8, 4, 333, D, Dv, dtype, 1, cuda_device)
        a = fa.flash_attention_cuda(q, k, v, causal=True, window=100, cap=30.0)
        b, _ = fa.flash_attention_cuda(q, k, v, causal=True, window=100,
                                       cap=30.0, return_lse=True)
        assert torch.equal(a, b)


def test_flash_backward_repeats_bitwise(cuda_device):
    q, k, v, do = flash_bwd_inputs(2, 8, 2, 300, 128, 128, torch.bfloat16, 5,
                             cuda_device)
    _, _, a = flash_grads(q, k, v, do, causal=True, window=100, cap=30.0)
    _, _, b = flash_grads(q, k, v, do, causal=True, window=100, cap=30.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fault", ["no_cap_grad", "one_head", "no_delta",
                                   "no_window"])
def test_flash_backward_planted_faults_fail(cuda_device, fp32_exact, fault):
    """The row check tells the kernels from each wrong plain backward."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    kw = dict(causal=True, window=48, cap=20.0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_bwd_inputs(1, 4, 2, 256, 64, 64, dtype, 9, cuda_device)
        o, lse, grads = check_backward(q, k, v, do, **kw)
        wrong = fa_ref.attention_backward_reference(q, k, v, o, lse, do,
                                                    fault=fault, **kw)
        assert max(grad_row_err(g, w) for g, w in zip(grads, wrong)) > \
            BWD_ROW_TOL[dtype]


def test_flash_backward_reads_views_and_copies_a_strided_cotangent(
        cuda_device, fp32_exact):
    """The layer's permuted views and MLA's value slice go in as they are;
    the gradients come back in the inputs' memory order; a dO whose head
    dim is not contiguous is copied once, and counted."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v, do = flash_bwd_inputs(2, 4, 2, 160, 96, 64, torch.bfloat16, 3,
                             cuda_device)
    kw = dict(causal=True, window=50)
    o, lse, want = flash_grads(q, k, v, do, **kw)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    ks = k.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros(2, 160, 2, 96 + 64, dtype=v.dtype, device=cuda_device)
    wide[..., 96:] = v.transpose(1, 2)
    vs = wide[..., 96:].transpose(1, 2)
    dos = do.transpose(2, 3).contiguous().transpose(2, 3)   # head dim strided
    copies = fa.BACKWARD_DO_COPIES
    got = fa.flash_attention_backward_cuda(qs, ks, vs, o, lse, dos, **kw)
    assert fa.BACKWARD_DO_COPIES == copies + 1
    assert got[0].stride() == qs.stride() and got[1].stride() == ks.stride()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_backward_kernel_info_matches_the_plan(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 80, 128, 192, 256):
            info = fa.backward_kernel_info(dtype, D)
            plan = fa.backward_plan(dtype, D)
            assert (info["rows"], info["keys"], info["smem_bytes"]) == \
                (plan.rows, plan.keys, plan.smem_bytes)
            assert plan.smem_bytes <= fa.MAX_SMEM
            assert set(info["registers"]) == set(fa.BWD_KERNELS)
            assert all(0 < r <= 255 for r in info["registers"].values())


def test_flash_backward_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v, do = flash_bwd_inputs(1, 4, 2, 64, 64, 64, torch.float32, 0,
                             cuda_device)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    before = fa.BACKWARD_LAUNCHES
    with pytest.raises(ValueError):                   # lse of another shape
        fa.flash_attention_backward_cuda(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError):                   # dO of another dtype
        fa.flash_attention_backward_cuda(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError):                   # o's head dim strided
        fa.flash_attention_backward_cuda(
            q, k, v, o.transpose(2, 3).contiguous().transpose(2, 3), lse, do)
    assert fa.BACKWARD_LAUNCHES == before


# ------------------ flash backward on the tensor cores -------------------- #

def flash_bwd_route_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa

    return (fa.BACKWARD_TENSOR_CORE_LAUNCHES, fa.BACKWARD_CUDA_CORE_LAUNCHES)


def shifted_copy(t, by=4):
    """A copy of ``t`` whose data starts ``by`` elements past a 16-byte
    boundary: its values, not TMA-aligned."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    return buf[by:].view(t.shape).copy_(t)


def check_tc_backward(q, k, v, do, **kw):
    """One backward call on the tensor-core route (its counter moves by
    one, the CUDA cores' not at all) against the plain backward and the
    mirror, each row within BWD_ROW_TOL; a second call repeats it
    bitwise."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa.backward_route(q, k, v, o, do) == "tensor_cores"
    tc, cc = flash_bwd_route_counts()
    got = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert flash_bwd_route_counts() == (tc + 1, cc)
    again = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    for g, h, t in zip(got, again, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, h)
    for want in (fa_ref.attention_backward_reference(q, k, v, o, lse, do, **kw),
                 fa_ref.attention_backward_tc_reference(q, k, v, o, lse, do,
                                                        **kw)):
        errs = [grad_row_err(g, w) for g, w in zip(got, want)]
        assert max(errs) <= BWD_ROW_TOL[torch.bfloat16], (errs, kw)
    return o, lse, got


TC_PAIRS = [(64, 64), (80, 80), (128, 128), (192, 128), (256, 256)]


@pytest.mark.parametrize("D,Dv", TC_PAIRS)
def test_flash_backward_tensor_cores_match_plain_and_mirror(cuda_device,
                                                            fp32_exact, D, Dv):
    """Each tensor-core pair with every option of BWD_OPTIONS, GQA 4 over
    2 and a length (200) that no tile divides."""
    for n, kw in enumerate(BWD_OPTIONS):
        check_tc_backward(*flash_bwd_inputs(2, 4, 2, 200, D, Dv,
                                            torch.bfloat16, 7 * D + n,
                                            cuda_device), **kw)


@pytest.mark.parametrize("S", [2, 31, 64, 65, 129, 300])
def test_flash_backward_tensor_cores_ragged_lengths(cuda_device, fp32_exact,
                                                     S):
    """Lengths no tile divides, not causal so that no row sees a single key
    (whose dq is round-off: see BWD_ROW_FLOOR)."""
    for D, Dv in ((128, 128), (80, 80)):
        check_tc_backward(*flash_bwd_inputs(1, 4, 1, S, D, Dv, torch.bfloat16,
                                            S + D, cuda_device, q_mul=1.0),
                          causal=False, window=40)


@pytest.mark.parametrize("fault", ["no_cap_grad", "one_head", "no_delta",
                                   "no_window"])
def test_flash_backward_tensor_cores_planted_faults_fail(cuda_device,
                                                         fp32_exact, fault):
    """The row check tells the tensor-core gradient from the mirror with
    each planted fault, at gemma2's pair and MLA's."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    kw = dict(causal=True, window=48, cap=20.0)
    for D, Dv in ((256, 256), (192, 128)):
        q, k, v, do = flash_bwd_inputs(1, 4, 2, 256, D, Dv, torch.bfloat16, 9,
                                       cuda_device)
        o, lse, got = check_tc_backward(q, k, v, do, **kw)
        wrong = fa_ref.attention_backward_tc_reference(q, k, v, o, lse, do,
                                                       fault=fault, **kw)
        assert max(grad_row_err(g, w) for g, w in zip(got, wrong)) > \
            BWD_ROW_TOL[torch.bfloat16]


def test_flash_backward_tensor_cores_read_views_and_copy_a_strided_do(
        cuda_device, fp32_exact):
    """The layer's [B,S,H,D] views, MLA's value slice ([..., 128:] of its
    key/value expansion) and hubert's D 80 go in as they are and give the
    bits of contiguous copies; the gradients come back in the inputs'
    memory order; a dO TMA cannot read (head dim strided) is copied once."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for D, Dv in ((192, 128), (80, 80), (256, 256)):
        q, k, v, do = flash_bwd_inputs(2, 4, 2, 160, D, Dv, torch.bfloat16,
                                       D, cuda_device)
        kw = dict(causal=True, window=50)
        _, _, want = check_tc_backward(q, k, v, do, **kw)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        qs = q.transpose(1, 2).contiguous().transpose(1, 2)
        ks = k.transpose(1, 2).contiguous().transpose(1, 2)
        wide = torch.zeros(2, 160, 2, 128 + Dv, dtype=v.dtype,
                           device=cuda_device)
        wide[..., 128:] = v.transpose(1, 2)
        vs = wide[..., 128:].transpose(1, 2)
        dos = do.transpose(2, 3).contiguous().transpose(2, 3)
        assert fa.backward_route(qs, ks, vs, o, dos) == "tensor_cores"
        copies, (tc, cc) = fa.BACKWARD_DO_COPIES, flash_bwd_route_counts()
        got = fa.flash_attention_backward_cuda(qs, ks, vs, o, lse, dos, **kw)
        assert fa.BACKWARD_DO_COPIES == copies + 1
        assert flash_bwd_route_counts() == (tc + 1, cc)
        assert got[0].stride() == qs.stride() and \
            got[1].stride() == ks.stride()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_flash_backward_bf16_off_the_tensor_cores_is_the_cuda_core_result(
        cuda_device, fp32_exact):
    """bf16 at a tensor-core pair whose q, or k and v, lie 8 bytes off
    16-byte alignment take the CUDA-core route and give the same bits
    either way, within the row check of the tensor-core gradient of the
    same values and of the plain backward; so do bf16 at another pair."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    kw = dict(causal=True, window=100, cap=30.0)
    q, k, v, do = flash_bwd_inputs(1, 4, 2, 256, 128, 128, torch.bfloat16, 4,
                                   cuda_device)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    oq, ok_, ov = shifted_copy(q), shifted_copy(k), shifted_copy(v)
    assert fa.backward_route(oq, k, v, o, do) == "cuda_cores"
    assert fa.backward_route(q, ok_, ov, o, do) == "cuda_cores"
    tc, cc = flash_bwd_route_counts()
    g1 = fa.flash_attention_backward_cuda(oq, k, v, o, lse, do, **kw)
    g2 = fa.flash_attention_backward_cuda(q, ok_, ov, o, lse, do, **kw)
    assert flash_bwd_route_counts() == (tc, cc + 2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    on_tc = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert flash_bwd_route_counts() == (tc + 1, cc + 2)
    for want in (on_tc, fa_ref.attention_backward_reference(q, k, v, o, lse,
                                                            do, **kw)):
        errs = [grad_row_err(g, w) for g, w in zip(g1, want)]
        assert max(errs) <= BWD_ROW_TOL[torch.bfloat16], errs
    q, k, v, do = flash_bwd_inputs(1, 4, 2, 128, 96, 64, torch.bfloat16, 4,
                                   cuda_device)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    assert fa.backward_route(q, k, v, o, do) == "cuda_cores"
    fa.flash_attention_backward_cuda(q, k, v, o, lse, do)
    assert flash_bwd_route_counts() == (tc + 1, cc + 3)


def test_flash_backward_tc_kernel_info_matches_the_plan(cuda_device):
    """At every tensor-core pair: the card's plan is the host's, and no
    instantiation of either route spills."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for D, Dv in TC_PAIRS:
        for route in ("tensor_cores", "cuda_cores"):
            info = fa.backward_kernel_info(torch.bfloat16, D, Dv, route=route)
            plan = fa.backward_plan(torch.bfloat16, D, Dv, route=route)
            assert info["route"] == plan.route == route
            assert {f: info[f] for f in ("rows", "keys", "smem_bytes",
                                         "dq_rows", "dq_smem_bytes",
                                         "dq_stages")} == \
                {f: getattr(plan, f) for f in ("rows", "keys", "smem_bytes",
                                               "dq_rows", "dq_smem_bytes",
                                               "dq_stages")}
            assert max(plan.smem_bytes, plan.dq_smem_bytes) <= fa.MAX_SMEM
            assert all(0 < r <= 255 for r in info["registers"].values())
            assert all(b == 0 for b in info["local_bytes"].values()), info
        assert fa.backward_kernel_info(torch.bfloat16, D, Dv)["route"] == \
            "tensor_cores"


# --------- the mma.sync route (fp32, and bf16 that TMA cannot read) --------- #

def check_mma_backward(q, k, v, do, **kw):
    """One forward launch and one backward call on the "cuda_cores"
    (mma.sync) route, held to the plain versions (check_flash's bounds,
    BWD_ROW_TOL) and, in fp32, to the split mirror
    (ref.attention_split_reference and its backward: the kernels'
    arithmetic on the card's own terms) at the same bounds; a second
    backward call repeats the first bitwise."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    check_route("cuda_cores", q, k, v, **kw)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    if q.dtype == torch.float32:
        want = fa_ref.attention_split_reference(q, k, v, **kw)
        row_err = ((o - want).abs().amax(-1)
                   / want.abs().amax(-1).clamp_min(1e-30)).max()
        assert float(row_err) <= FLASH_ROW_TOL[q.dtype], float(row_err)
    assert fa.backward_route(q, k, v, o, do) == "cuda_cores"
    tc, cc = flash_bwd_route_counts()
    got = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert flash_bwd_route_counts() == (tc, cc + 2)
    wants = [fa_ref.attention_backward_reference(q, k, v, o, lse, do, **kw)]
    if q.dtype == torch.float32:
        wants.append(fa_ref.attention_backward_split_reference(
            q, k, v, o, lse, do, **kw))
    for g, h, x in zip(got, again, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, h)
    for want in wants:
        errs = [grad_row_err(g, w) for g, w in zip(got, want)]
        assert max(errs) <= BWD_ROW_TOL[q.dtype], (errs, kw)


@pytest.mark.parametrize("D,Dv,causal", [(192, 128, True), (80, 80, False)],
                         ids=["mla", "hubert"])
def test_flash_mma_route_fp32_at_mla_and_hubert(cuda_device, fp32_exact, D,
                                                Dv, causal):
    """MLA's prefill pair (D 192, Dv 128, causal, scale 1/sqrt(192)) and
    hubert's (D 80, not causal) in fp32, forward and backward, GQA 4 over
    2, a length (300) that no tile divides, a softcap and a window."""
    for n, kw in enumerate([dict(causal=causal),
                            dict(causal=causal, window=64, cap=30.0)]):
        check_mma_backward(*flash_bwd_inputs(2, 4, 2, 300, D, Dv,
                                             torch.float32, D + n,
                                             cuda_device),
                           scale=1.0 / float(np.sqrt(D)), **kw)


@pytest.mark.parametrize("D,Dv", [(80, 80), (192, 128)],
                         ids=["hubert", "mla"])
def test_flash_mma_route_bf16_that_tma_cannot_read(cuda_device, fp32_exact, D,
                                                    Dv):
    """bf16 at a tensor-core pair, as copies 8 bytes past 16-byte alignment
    (the route's 4-element alignment, not TMA's 16 bytes): forward and
    backward on the mma.sync route, within the bf16 bounds of the plain
    versions."""
    for n, kw in enumerate([dict(causal=True), dict(causal=False, window=40),
                            dict(causal=True, window=48, cap=20.0)]):
        check_mma_backward(*(shifted_copy(t) for t in flash_bwd_inputs(
            2, 4, 2, 200, D, Dv, torch.bfloat16, 3 * D + n, cuda_device)),
            **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_mma_route_backward_repeats_bitwise(cuda_device, dtype):
    """No atomics: two backward calls on the mma.sync route give the same
    bits (fp32, and bf16 copies TMA cannot read), GQA 6 over 2."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v, do = (shifted_copy(t) for t in flash_bwd_inputs(
        1, 6, 2, 333, 128, 128, dtype, 11, cuda_device))
    kw = dict(causal=True, window=100, cap=30.0)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa.backward_route(q, k, v, o, do) == "cuda_cores"
    a = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    b = fa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_mma_route_instantiations_match_the_plan_and_do_not_spill(
        cuda_device):
    """Every instantiation the mma.sync route builds (fp32 and bf16 at
    widths 64, 128, 192 and 256, with and without a softcap): the card's
    plan is the host's (forward and backward) and no kernel spills."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for D, Dv in ((32, 32), (64, 64), (80, 80), (96, 64), (128, 128),
                      (160, 160), (192, 128), (256, 256), (256, 128)):
            plan = fa.tile_plan(dtype, D, Dv)
            for capped in (False, True):
                info = fa.kernel_info(dtype, D, capped, v_head_dim=Dv,
                                      route="cuda_cores")
                assert info["route"] == "cuda_cores"
                if plan.route == "cuda_cores":
                    assert (info["rows"], info["keys"], info["stages"],
                            info["smem_bytes"]) == \
                        (plan.rows, plan.keys, plan.stages, plan.smem_bytes)
                assert info["local_bytes"] == 0, (dtype, D, Dv, info)
                assert info["max_threads"] >= 256
            binfo = fa.backward_kernel_info(dtype, D, Dv, route="cuda_cores")
            bplan = fa.backward_plan(dtype, D, Dv, route="cuda_cores")
            assert {f: binfo[f] for f in ("rows", "keys", "smem_bytes",
                                          "dq_rows", "dq_keys",
                                          "dq_smem_bytes", "dq_stages")} == \
                {f: getattr(bplan, f) for f in (
                    "rows", "keys", "smem_bytes", "dq_rows", "dq_keys",
                    "dq_smem_bytes", "dq_stages")}
            assert all(b == 0 for b in binfo["local_bytes"].values()), binfo


def test_mamba2_train_step_on_the_card_matches_the_cpu(cuda_device,
                                                       fp32_exact):
    """mamba2-130m (reduced) in fp32: one journaled train step on the card
    (the SSD forward and backward kernels, the hash kernel) and on the CPU
    from the same state: the loss within 1e-5, each grad's hash equal to
    the plain hash of that grad, the new params within 1e-4 of each leaf's
    largest update plus two fp32 spacings of its largest value, where the
    grad is at least 1e-3 of the leaf's largest (below that, AdamW's sign
    from zero moments is round-off)."""
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.optim import OptConfig
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, tree_map

    cfg = reduced_config("mamba2-130m")
    opt = OptConfig(lr=3e-3, warmup_steps=2, decay_steps=1000)
    host = S.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                              device="cpu")
    host["step"] = torch.tensor(2, dtype=torch.int32)
    card = tree_map(lambda t: t.to(cuda_device), host)
    batch = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=256)
                             ).tensors_at(0, "cpu")
    before = ssd_scan.BACKWARD_LAUNCHES
    tc, cc = bwd_route_counts()
    new_card, met_card = S.train_step(
        card, {k: v.to(cuda_device) for k, v in batch.items()}, cfg, opt,
        journal=True)
    assert ssd_scan.BACKWARD_LAUNCHES == before + cfg.n_layers
    assert bwd_route_counts() == (tc, cc + cfg.n_layers)   # fp32: CUDA cores
    new_cpu, met_cpu = S.train_step(host, batch, cfg, opt, journal=True)
    assert float(met_card["loss"]) == pytest.approx(float(met_cpu["loss"]),
                                                    rel=1e-5)
    grads, _ = S.grads_and_metrics(card["params"], {
        k: v.to(cuda_device) for k, v in batch.items()}, cfg)
    assert met_card["integrity"].tolist() == [
        int(ref.tensor_checksum(g.cpu())) for _, g in leaf_paths(grads)]
    g_cpu = dict(leaf_paths(S.grads_and_metrics(host["params"], batch,
                                                cfg)[0]))
    old = dict(leaf_paths(host["params"]))
    for (n, pc), (_, pp) in zip(leaf_paths(new_card["params"]),
                                leaf_paths(new_cpu["params"])):
        g = g_cpu[n].abs()
        keep = (g >= 1e-3 * g.max()) | (g == 0)
        tol = 1e-4 * (pp - old[n]).abs().max() + 2 * 2.0 ** -23 * \
            pp.abs().max()
        assert float(((pc.cpu() - pp).abs() * keep).max()) <= float(tol), n



def test_init_peak_is_params_and_one_block_slice(cuda_device):
    """moonshot-v1-16b-a3b at its published widths cut to 4 layers (14 GB
    in bf16): ``init_params`` on the card peaks at most its param bytes,
    one block's slice of its largest leaf in fp32 (64 experts' wi of one
    layer, 1.48 GB) and 1 GiB above what was allocated before it."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=4)
    specs = M.param_specs(cfg)
    nbytes = sum(math.prod(s.shape) * s.dtype.itemsize
                 for _, s in leaf_paths(specs))
    piece = 4 * max(math.prod(s.shape[1:])
                    for _, s in leaf_paths(specs["blocks"]))
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    assert torch.cuda.memory_allocated() - start == nbytes
    assert peak <= nbytes + piece + (1 << 30), (peak, nbytes, piece)
    wi = params["blocks"]["l0"]["ffn"]["experts"]["wi"]
    assert wi.dtype == torch.bfloat16 and not torch.equal(wi[0], wi[1])
    del params
    torch.cuda.empty_cache()


def test_piecewise_adafactor_step_on_the_card_matches_the_cpu(
        cuda_device, fp32_exact, monkeypatch):
    """qwen2-7b (reduced, 3 blocks, fp32): one journaled Adafactor step on
    the card and on the CPU from the same state, in pieces of 2048
    elements (the stacked MLP leaf [3, 128, 2, 256] splits into 4 rows a
    piece): the loss within 1e-5; then the update alone from the CPU's
    grads on both devices (Adafactor's update is linear in g, so the grads'
    own card-vs-CPU distance would pass into it where a row or column is
    small): the grad norm within 1e-6, each new moment leaf within 1e-5 of
    its largest, each new param leaf within 1e-5 of its largest update
    plus two fp32 spacings of its largest value; the donated update on the
    card bitwise the functional one."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.optim import OptConfig
    from repro_torch.optim import optimizer as topt
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths, tree_map

    monkeypatch.setattr(topt, "PIECE", 2048)
    cfg = dataclasses.replace(reduced_config("qwen2-7b"), n_layers=3)
    opt = OptConfig(name="adafactor", lr=3e-3, warmup_steps=2,
                    decay_steps=1000)
    host = S.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                              device="cpu")
    host["step"] = torch.tensor(2, dtype=torch.int32)
    card = tree_map(lambda t: t.to(cuda_device), host)
    batch = SyntheticDataset(cfg, DataConfig(batch=2, seq_len=256)
                             ).tensors_at(0, "cpu")
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}
    _, met_card = S.train_step(card, on_card, cfg, opt, journal=True)
    g_cpu, met = S.grads_and_metrics(host["params"], batch, cfg)
    new_cpu, met_cpu = S.apply_step(host, g_cpu, met, opt)
    assert float(met_card["loss"]) == pytest.approx(float(met_cpu["loss"]),
                                                    rel=1e-5)
    grads = tree_map(lambda t: t.to(cuda_device), g_cpu)
    new_card, met_same = S.apply_step(card, grads, met, opt)
    assert float(met_same["grad_norm"]) == pytest.approx(
        float(met_cpu["grad_norm"]), rel=1e-6)
    for (n, mc), (_, mp) in zip(leaf_paths(new_card["opt"]),
                                leaf_paths(new_cpu["opt"])):
        assert float((mc.cpu() - mp).abs().max()) <= \
            1e-5 * float(mp.abs().max()), n
    old = dict(leaf_paths(host["params"]))
    for (n, pc), (_, pp) in zip(leaf_paths(new_card["params"]),
                                leaf_paths(new_cpu["params"])):
        tol = 1e-5 * (pp - old[n]).abs().max() + 2 * 2.0 ** -23 * \
            pp.abs().max()
        assert float((pc.cpu() - pp).abs().max()) <= float(tol), n
    got, _ = S.apply_step(card, grads, met, opt, donate=True)
    for (n, a), (_, b) in zip(leaf_paths((got["params"], got["opt"])),
                              leaf_paths((new_card["params"],
                                          new_card["opt"]))):
        assert torch.equal(a, b), n


def test_async_save_and_restore_of_a_card_state_are_bitwise(cuda_device,
                                                           tmp_path):
    """qwen2-7b (reduced, bf16 params, Adafactor's state) on the card: one
    ``save_async`` to two FileStore replicas at W = 2 with the manifest in
    a replicated log, the source leaves zeroed on the card as soon as it
    returns, then one restore into another state on the card: every leaf
    bitwise the state as it was saved, in its dtype, on the card."""
    import dataclasses

    from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                        FileStore, ReplicatedStore)
    from repro_torch.configs import reduced_config
    from repro_torch.core.replication import build_replica_set
    from repro_torch.optim import OptConfig
    from repro_torch.train import step as S
    from repro_torch.tree import leaf_paths

    cfg = dataclasses.replace(reduced_config("qwen2-7b"),
                              param_dtype="bfloat16")
    opt = OptConfig(name="adafactor")

    def state(seed):
        return S.init_train_state(
            cfg, opt, torch.Generator(device=cuda_device).manual_seed(seed),
            device=cuda_device)
    saved = state(0)
    want = {n: t.clone() for n, t in leaf_paths(saved)}
    assert any(t.dtype == torch.bfloat16 for t in want.values())
    rs = build_replica_set(mode="local+remote", capacity=1 << 20,
                           n_backups=1, write_quorum=2, device=cuda_device)
    try:
        stores = [FileStore(str(tmp_path / f"replica{i}"), f"fs{i}")
                  for i in range(2)]
        mgr = CheckpointManager(ReplicatedStore(stores, write_quorum=2),
                                rs.log, CheckpointConfig(force_freq=4))
        mgr.save_async(3, saved, {"pos": 3})
        for _, t in leaf_paths(saved):
            t.zero_()
        mgr.wait()
        step, got, extra = mgr.restore(state(1))
        mgr.close()
    finally:
        rs.shutdown()
    assert (step, extra) == (3, {"pos": 3})
    for n, t in leaf_paths(got):
        assert t.device.type == cuda_device.type, n
        assert t.dtype == want[n].dtype, n
        assert torch.equal(t, want[n]), n

# ---------------------------------------------------------------------- #
# the distributed layer over a one-rank NCCL group
# ---------------------------------------------------------------------- #

@pytest.fixture
def nccl_mesh(cuda_device, monkeypatch):
    """A one-rank NCCL group and its (1, 1) smoke mesh, destroyed after; its
    bootstrap stays on the loopback."""
    from repro_torch.distributed import one_rank_group
    from repro_torch.launch.mesh import make_smoke_mesh
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    with one_rank_group("cuda"):
        yield make_smoke_mesh(device_type="cuda")


def test_make_smoke_mesh_on_one_card(nccl_mesh):
    import torch.distributed as dist
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert nccl_mesh.device_type == "cuda"
    assert tuple(nccl_mesh.shape) == (1, 1)
    assert nccl_mesh.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_nccl_ep_equals_dense(nccl_mesh, dtype):
    """Reduced moonshot at capacity factor 1.25 (tokens dropped): at one
    rank the EP path's buckets, drops and products are the dense path's,
    so y and aux are bitwise equal and so are the grads of x, router, wi
    and wo."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(reduced_config("moonshot-v1-16b-a3b"),
                              capacity_factor=1.25)
    gen = torch.Generator(device="cuda").manual_seed(0)
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def draw(*shape, std=0.1):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).to(dtype)
    base = [draw(4, 64, D, std=1.0), draw(D, E), draw(E, D, 2, F_),
            draw(E, F_, D)]
    gy = draw(4, 64, D, std=1.0)

    def run(ep):
        leaves = [t.clone().requires_grad_(True) for t in base]
        p = {"router": leaves[1], "experts": {"wi": leaves[2],
                                              "wo": leaves[3]}}
        L.set_moe_ep(nccl_mesh, ("data", "model") if ep else None)
        try:
            y, aux = L.moe_ffn(leaves[0], p, cfg)
            grads = torch.autograd.grad((y.float() * gy.float()).sum() + aux,
                                        leaves)
        finally:
            L.set_moe_ep(None, None)
        return [y, aux, *grads]
    for a, b in zip(run(True), run(False)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_compression_equals_plain_on_the_card(nccl_mesh):
    from repro_torch.distributed.compression import (
        compressed_psum_reference, quantized_allreduce)
    g = torch.randn(1 << 20, generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda")
    got = quantized_allreduce(g, nccl_mesh, "data")
    assert torch.equal(got, compressed_psum_reference([g]))
    assert float((got - g).abs().max() / g.abs().max()) < 0.02
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (2, 2)]
    assert torch.equal(quantized_allreduce(g, nccl_mesh, "data", gens[0]),
                       compressed_psum_reference([g], [gens[1]]))


def test_one_stage_pipeline_equals_sequential(nccl_mesh):
    """Reduced mamba2 in bf16 as one stage: bitwise the stack on each
    microbatch in turn, one scan kernel launch a block and microbatch."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced_config("mamba2-130m"), ssm_chunk=64,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    blocks = M.cast_params(M.init_params(cfg, gen, device="cuda"),
                           cfg)["blocks"]

    def stage(bp, h):
        for b in range(cfg.n_blocks):
            h, _, _ = M.apply_block(tree_map(lambda t: t[b], bp), h, cfg)
        return h
    xs = torch.randn((3, 2, 128, cfg.d_model), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    with torch.no_grad():
        want = torch.stack([stage(blocks, x) for x in xs])
        before = ssd_scan.LAUNCHES
        got = pipeline_forward(stage, tree_map(lambda t: t[None], blocks),
                               xs, mesh=nccl_mesh, axis="data", n_micro=3)
    assert torch.equal(got, want)
    assert ssd_scan.LAUNCHES - before == 3 * cfg.n_blocks
