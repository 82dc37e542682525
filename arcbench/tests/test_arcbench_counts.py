"""The yardstick's FLOP and byte counts against counts made by hand at
the cells' shapes."""

import pytest

from arcbench.harness import roofline as R

from .common import spec

MAMBA = spec.cell("mamba2-130m.train").config["model"]
STAR = spec.cell("starcoder2-3b.train").config["model"]


def test_matmul_params_by_hand():
    # mamba2-130m: in_proj 768 x (2*1536 + 2*128 + 24), out_proj 1536 x
    # 768, 24 layers, the tied head 768 x 50280
    assert R.matmul_params(MAMBA) == 24 * (768 * 3352 + 1536 * 768) + \
        768 * 50280 == 128_710_656
    # starcoder2-3b: q, o 3072^2; k, v 3072 x 256; MLP 2 x 3072 x 12288;
    # 30 layers; the head 3072 x 49152
    layer = 2 * 3072 * 3072 + 2 * 3072 * 256 + 2 * 3072 * 12288
    assert R.matmul_params(STAR) == 30 * layer + 3072 * 49152 == \
        3_029_336_064


def test_model_flops_per_token_by_hand():
    # the scan a token: H (Q(Q+1)(N+P) + 4QNP) / Q, plus the conv 2 W C
    scan = 24 * (257 * 192 + 4 * 128 * 64)
    conv = 2 * 4 * 1792
    fwd = 2 * 128_710_656 + 24 * (scan + conv)
    assert R.forward_flops_per_token(MAMBA, 4096) == fwd == 305_061_888
    assert R.train_flops_per_token(MAMBA, 4096) == 3 * fwd
    # causal attention: 2 products of 2*128 a pair, (S+1)/2 pairs a token
    att = 30 * 2 * 24 * 2 * 128 * 4097 / 2
    assert R.train_flops_per_token(STAR, 4096) == \
        pytest.approx(3 * (2 * 3_029_336_064 + att), rel=1e-12)
    assert R.train_flops_per_token(STAR, 4096) == \
        pytest.approx(20.44e9, rel=1e-3)


def test_kernel_bounds_by_hand():
    # the scan at 8 x 4096, bf16: its bytes (67.9 us) bound it, just above
    # its operations (65.3 us)
    ops = 8 * 24 * 16 * (256 * 257 * 192 + 4 * 256 * 128 * 64)
    assert R.ssd_ops((8, 4096, 24, 64, 1, 128, 256)) == ops
    nbytes = (2 * 8 * 4096 * 24 * 64 * 2 + 8 * 4096 * 24 * 4 + 24 * 4
              + 2 * 8 * 4096 * 128 * 2 + 8 * 24 * 64 * 128 * 4)
    assert nbytes == 227_541_088
    assert nbytes / 3.35e12 > ops / 989e12
    assert R.ssd_bound_ms((8, 4096, 24, 64, 1, 128, 256), "bfloat16") == \
        pytest.approx(nbytes / 3.35e12 * 1e3)
    # flash at starcoder2's 2 x 4096, causal: 2*2*24*(128+128) a pair
    pairs = 4096 * 4097 // 2
    assert R.attended_pairs(4096, True, None) == pairs
    assert R.flash_bound_ms((2, 24, 2, 4096, 128), True, None,
                            "bfloat16") == \
        pytest.approx(2 * 2 * 24 * 256 * pairs / 989e12 * 1e3)
    assert R.flash_bwd_bound_ms((2, 24, 2, 4096, 128), True, None,
                                "bfloat16") == \
        pytest.approx(2 * 2 * 24 * (3 * 128 + 2 * 128) * pairs
                      / 989e12 * 1e3)
    # the hash: a 1 GiB fp32 leaf is bound by its bytes
    lanes = 1 << 28
    assert R.bound_ms(1, lanes) == pytest.approx(
        (4 * lanes + 8) / 3.35e12 * 1e3)
