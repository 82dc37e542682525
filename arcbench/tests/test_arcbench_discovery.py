"""A cell, a traffic mix, a configuration and a per-layer metric are
found by name: adding their files and BENCHMARK.json entries is enough."""

import json
import shutil

from .common import ROOT, spec


def test_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    bench_dir = tmp_path / "arcbench"
    shutil.copytree(ROOT / "arcbench", bench_dir,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    # a new configuration, mix, cell and per-layer metric: new files only
    conf = json.loads((bench_dir / "configs" / "mamba2-130m.json")
                      .read_text())
    (bench_dir / "configs" / "mamba2-new.json").write_text(
        json.dumps({**conf, "name": "mamba2-new"}))
    (bench_dir / "traffic" / "train-4x2048.json").write_text(json.dumps(
        {"driver": "train", "batch": 4, "seq_len": 2048,
         "warmup_steps": 2}))
    (bench_dir / "workloads" / "mamba2-new.train.json").write_text(
        (bench_dir / "workloads" / "mamba2-130m.train.json").read_text())
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(
        'LAYER = "model step"\nUNIT = "steps"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nMOVES = "train_tokens_per_s"\n\n\n'
        'def compute(r):\n    return r.get("steps")\n')
    bench["configs"].append({"name": "mamba2-new", "source": "x",
                             "file": "arcbench/configs/mamba2-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mamba2-new.train",
                               "config": "mamba2-new",
                               "traffic": "train-4x2048", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("mamba2-new.train")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "model step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["mamba2-new.train"]})
    cell = spec.cell("mamba2-new.train", bench, bench_dir)
    assert cell.driver == "train"
    assert cell.traffic["batch"] == 4 and cell.config["name"] == "mamba2-new"
    assert [m.name for m in cell.end_to_end] == ["train_tokens_per_s",
                                                 "setup_s"]
    assert [m.name for m in cell.per_layer] == ["steps_seen.train"]
    got = spec.per_layer_values(cell, {"steps": 7}, bench_dir)
    assert got == {"steps_seen.train": {"value": 7, "unit": "steps"}}
    # no file that was there changed
    for rel, raw in before.items():
        assert (bench_dir / rel).read_bytes() == raw


def test_every_metric_file_agrees_with_benchmark_json():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert mod.compute({}) is None
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert cell.settings["rate_metric"] in [m.name for m in
                                                cell.end_to_end]
