"""chip_smoke.py's teacher-forced decode checks for the dense configs
served whole, run on the CPU at a reduced size in fp32: each decode layer
fed the prefill's input gives the prefill's output, attention output and
cached K/V, and each planted decode fault (a rotary position off by one, a
cache write one slot early) fails that check.  The card runs the same
functions at full depth in bf16.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-7b", "command-r-35b",
                                  "llava-next-34b"])
def test_decode_checks_pass_clean_and_fail_each_planted_fault(smoke, arch):
    cfg = dataclasses.replace(reduced_config(arch), n_layers=3)
    params = M.cast_params(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    rng = np.random.default_rng(0)
    Np = cfg.n_patches if cfg.input_kind == "tokens+patches" else 0
    positions = 192 + Np
    patches = None if not Np else torch.from_numpy(rng.normal(
        size=(2, Np, cfg.frontend_dim)).astype(np.float32))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (2, positions - Np)))
    first = {"tokens": prompts} if not Np else \
        {"tokens": prompts, "patches": patches}
    logits, _ = M.serve_step(params, cfg, first, None, None)
    cut = positions - smoke.WHOLE_CUT
    real = (L.rope_tables, L.attention, L.gqa_attention, M._apply_layer,
            M._logits)
    out = smoke.dense_teacher_forced(params, cfg, prompts, patches,
                                     positions, logits[:, cut:cut + 4].float())
    # every harness patch is undone
    assert (L.rope_tables, L.attention, L.gqa_attention, M._apply_layer,
            M._logits) == real
    checks = out["layer_checks"]
    assert set(checks) == {"clean", *smoke.WHOLE_DECODE_FAULTS}
    assert max(checks["clean"].values()) <= smoke.WHOLE_LAYER_TOL, checks
    for fault in smoke.WHOLE_DECODE_FAULTS:
        # the K/V written at the decode positions is wrong under both
        assert checks[fault]["cache"] > smoke.WHOLE_LAYER_TOL, (fault, checks)
    assert len(out["layer_errs"]) == len(out["mixer_errs"]) == \
        len(out["cache_errs"]) == cfg.n_layers
    # in fp32 the decode, the prefill and the fp32 forward agree closely
    assert max(out["teacher_forced_diffs"]) <= \
        1e-5 * out["teacher_forced_scale"]
    assert out["prefill_vs_fp32"] <= 1e-5 and out["decode_vs_fp32"] <= 1e-5
