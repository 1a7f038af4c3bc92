"""Cells, configurations, traffic mixes, metrics and limits are found by
name from their files, and BENCHMARK.json keeps to the contract's form."""

import dataclasses
import json
import os
import re

import pytest

from harness import core

BENCH = core.read_json(os.path.join(core.REPO, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", WORKLOADS):
            assert w in WORKLOADS
            moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
            assert core.applies(moved, w), (m["name"], w)
    assert "setup_s" in names
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert len(set(names)) == len(names) and len(set(WORKLOADS)) == len(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = core.find_cell(workload)
    assert cell.traffic["kind"] in ("transcribe", "train")
    assert os.path.exists(os.path.join(core.BENCH_DIR, "drivers",
                                       cell.traffic["kind"] + ".py"))
    assert hasattr(core.driver(cell), "run")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(core.reader(m["name"]))
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_ports_preset(conf):
    """The file is the port's preset with its `preset_changes` and the
    port's default audio, and lists every departure from the published
    settings in `reduced`."""
    from yourmt3_tpu_torch.config.audio import DEFAULT_AUDIO
    from yourmt3_tpu_torch.config.model import get_model_config
    from yourmt3_tpu_torch.tokens.task_manager import TaskManager
    data = core.read_json(os.path.join(core.REPO, conf["file"]))
    assert conf["file"].startswith("portbench/") and data["reduced"] == conf["reduced"]
    assert data["source"] == conf["source"]
    assert set(data["published"]) - {"args"} == set(data["reduced"])
    assert all(data[k] != v for k, v in data["published"].items() if k != "args")
    tm = TaskManager(data["task"])
    want = dataclasses.asdict(get_model_config(data["preset"]).replace(
        vocab_size=tm.vocab_size, num_channels=tm.num_decoding_channels,
        max_target_length=tm.max_token_length, **data.get("preset_changes", {})))
    assert data["model"] == want
    assert data["audio"] == dataclasses.asdict(DEFAULT_AUDIO)
    assert data["detok"]["default_programs"] == tm.channel_default_programs
    assert data["detok"]["segment_seconds"] == tm.audio_cfg.segment_seconds
    assert data["detok"]["num_velocity_bins"] == tm.task.num_velocity_bins
    assert tuple(data["detok"]["extra_tokens"]) == tuple(tm.task.subtask_tokens)
    # the forced prefix, encoded by the reference codec, is the port's; a
    # serving cell of a prefixed configuration checks that its rows carry it
    from reference import serve_check
    assert serve_check.prefix_ids(data) == tm.subtask_prefix_ids()
    for w in BENCH["workloads"]:
        cell = core.find_cell(w["name"])
        if w["config"] == conf["name"] and cell.traffic["kind"] == "transcribe":
            assert ("prefix_mismatch" in cell.limits) == bool(data["prefix"]), w["name"]
            assert cell.limits.get("prefix_mismatch", 0) == 0


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
