"""The form of the result's last line."""

import json

from arcbench.harness import main as hm
from arcbench.harness.trace import TraceSummary

from .common import tiny_cell


def _outcome(correct=True):
    return hm.Outcome(
        e2e={"train_tokens_per_s": 50123.25, "setup_s": 17.5},
        attempted=46, failed=0,
        checks=[("loss_gap", 1e-4 if correct else 1.0, 1e-2),
                ("journal_bad", 0, 0.0)],
        readings={"kind": "train", "tokens_per_s": 50123.25,
                  "flops_per_token": 9.15e8, "steps": 46,
                  "journal_ms": [0.2] * 46, "busy_s": 2.5, "window_s": 2.6,
                  "kernel_ms": {"ssd_fwd": 100.0, "ssd_bwd": 200.0,
                                "hash": 5.0},
                  "bound_ms": {"ssd_fwd": 60.0, "ssd_bwd": 90.0,
                               "hash": 1.0}},
        summary=TraceSummary(first=2, last=6, busy_s=2.5, window_s=2.6,
                             calls={}, kernel_ms={}, kernel_count={},
                             device_ops=[["gemm", 1.25]],
                             idle_gaps=[["step", 0.01]]),
        memory_peak_bytes=123)


def _ctx(trace):
    return hm.Context(cell=tiny_cell("mamba2-130m.train"), seed=1,
                      seconds=30, trace=trace, t0=0.0)


def test_untraced_line_has_the_end_to_end_metrics_and_checks_last():
    line = hm.result_line(_ctx(False), _outcome(), "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {
        "train_tokens_per_s": {"value": 50123.25, "unit": "tokens/s"},
        "setup_s": {"value": 17.5, "unit": "s"}}
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["checks"]["loss_gap"] == {"value": 1e-4, "limit": 1e-2}
    json.dumps(line)


def test_traced_line_has_the_per_layer_metrics_and_the_breakdown():
    line = hm.result_line(_ctx(True), _outcome(), "NVIDIA H100 80GB HBM3")
    assert list(line)[-1] == "checks"
    assert line["device"]["busy_s"] == 2.5
    assert line["device"]["window_s"] == 2.6
    assert line["breakdown"] == {"device_ops": [["gemm", 1.25]],
                                 "idle_gaps": [["step", 0.01]]}
    m = line["metrics"]
    assert set(m) == {"train_mfu", "ssd_fwd_roofline.train",
                      "ssd_bwd_roofline.train", "hash_roofline.train",
                      "journal_ms_per_step.train",
                      "device_idle_share.train"}
    assert m["ssd_fwd_roofline.train"] == {"value": 60.0, "unit": "%"}
    assert abs(m["train_mfu"]["value"] - 100 * 9.15e8 * 50123.25 / 989e12) \
        < 1e-9


def test_a_failed_check_makes_the_run_incorrect():
    assert _outcome(correct=False).correct is False
    out = _outcome()
    out.checks.append(("grad_gap", float("nan"), 1.0))
    assert out.correct is False
