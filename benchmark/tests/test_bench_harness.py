"""The harness is driven by data, its result line keeps to the contract,
and a run writes only inside its checkout and the given HOME,
XDG_CACHE_HOME and TMPDIR."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PORT = "yetanotherconsolegameengine_tpu_torch"
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# Runs a cell on the CPU under an audit hook that records every path the
# process opens for writing or creates, renames or removes.
AUDITED_RUN = r"""
import json, os, pathlib, sys
written = set()
WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC
def hook(event, args):
    if event == "open" and not isinstance(args[0], int):
        mode, flags = args[1] or "", args[2] or 0
        if any(c in mode for c in "wax+") or flags & WRITE:
            written.add(os.path.abspath(os.fsdecode(args[0])))
    elif event in ("os.mkdir", "os.rename", "os.remove", "os.rmdir",
                   "os.symlink", "os.link", "os.truncate", "shutil.rmtree"):
        written.add(os.path.abspath(os.fsdecode(args[0])))
sys.addaudithook(hook)
from benchmark import run
result, _, _ = run.run_cell(sys.argv[1], 2**31 + 99, 1.0, int(sys.argv[2]),
                            device="cpu", root=pathlib.Path.cwd(),
                            overrides=json.loads(sys.argv[3]))
print(json.dumps(result))
print("WRITTEN " + json.dumps(sorted(written)), file=sys.stderr)
"""


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _checkout(tmp: Path) -> Path:
    """A copy of what the benchmark's command needs: BENCHMARK.json, the
    benchmark and the program."""
    co = tmp / "checkout"
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "benchmark", co / "benchmark", ignore=ignore)
    shutil.copytree(ROOT / PORT, co / PORT, ignore=ignore)
    shutil.copy(ROOT / "BENCHMARK.json", co / "BENCHMARK.json")
    return co


def _run(co: Path, tmp: Path, workload: str, trace: int, overrides):
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[var] = str(tmp / var.lower())
        os.makedirs(env[var], exist_ok=True)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", AUDITED_RUN, workload, str(trace),
         json.dumps(overrides)], cwd=co, env=env, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    written = json.loads(out.stderr.split("WRITTEN ")[-1].splitlines()[0])
    allowed = [co] + [Path(env[v]) for v in ("HOME", "XDG_CACHE_HOME",
                                             "TMPDIR")]
    outside = [w for w in written if w != os.devnull and not any(
        Path(w).is_relative_to(a.resolve()) for a in allowed)]
    return result, outside


def test_new_files_are_found_by_name_and_runs_stay_inside(tmp_path):
    co = _checkout(tmp_path)
    before = _digests(co)
    bench = co / "benchmark"
    cfg = json.loads((bench / "configs" / "cornell_160x90.json").read_text())
    cfg.update(fb_w=16, fb_h=6, warmup_ticks=2)
    (bench / "configs" / "cornell_16x6.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "play.json").read_text())
    tr.update(cycle=[{"keys": ["left"], "ticks": [8]}], follow_calls=1,
              check_calls=1)
    (bench / "traffic" / "look.json").write_text(json.dumps(tr))
    (bench / "metrics" / "shell.ticks_per_s.py").write_text(
        'LAYER = "app shell"\nUNIT = "ticks/s"\nMOVES = "tick_ms"\n\n\n'
        "def read(t):\n    s = t.spans.tick_ms\n"
        "    return 1e3 * len(s) / sum(s) if s else None\n")
    shutil.copy(bench / "checks" / "cornell.play.json",
                bench / "checks" / "cornell_16x6.look.json")
    spec = json.loads((co / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="cornell_16x6",
                                file="benchmark/configs/cornell_16x6.json"))
    spec["workloads"].append({"name": "cornell_16x6.look",
                              "config": "cornell_16x6", "traffic": "look",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "shell.ticks_per_s", "unit": "ticks/s",
                              "better": "higher", "source": "program_span",
                              "layer": "app shell", "moves": "tick_ms",
                              "workloads": ["cornell_16x6.look"]})
    (co / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(co)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == [co / "BENCHMARK.json"]   # entries, no other edit

    result, outside = _run(co, tmp_path, "cornell_16x6.look", 1, {})
    assert not outside, outside
    assert list(result)[:5] == CONTRACT_KEYS and list(result)[-1] == "check"
    assert set(result) <= set(CONTRACT_KEYS) | {"breakdown", "check"}
    assert result["correct"], result["check"]
    assert result["metrics"]["shell.ticks_per_s"]["unit"] == "ticks/s"
    assert result["metrics"]["shell.ticks_per_s"]["value"] > 0


def test_a_cluster_mesh_cell_needs_only_files_and_entries(tmp_path):
    """The dragon (a cluster mesh with fine, LOD and shadow proxy sets)
    becomes a cell with a configuration, a limits file and entries; the
    run's check holds the program's cluster tables to the reference's
    and replays its calls exactly. (At 16x12 pixels one cell is 1% of a
    frame, so its frames are held to the limits at the cell's own size,
    on the card: test_bench_reference.py.)"""
    co = _checkout(tmp_path)
    before = _digests(co)
    bench = co / "benchmark"
    cfg = json.loads((bench / "configs" / "museum_standin_160x90.json")
                     .read_text())
    cfg.update(scene="dragon", fb_w=16, fb_h=6, warmup_ticks=2)
    (bench / "configs" / "dragon_16x6.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "checks" / "museum.play.json",
                bench / "checks" / "dragon_16x6.play.json")
    spec = json.loads((co / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][1], name="dragon_16x6",
                                file="benchmark/configs/dragon_16x6.json"))
    spec["workloads"].append({"name": "dragon_16x6.play",
                              "config": "dragon_16x6", "traffic": "play",
                              "chips": 1, "why": "a test cell"})
    (co / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(co)
    assert [p for p in before if before[p] != after[p]] == [
        co / "BENCHMARK.json"]

    result, outside = _run(co, tmp_path, "dragon_16x6.play", 0, {
        "traffic": {"follow_calls": 1, "check_calls": 1}})
    assert not outside, outside
    for k in ("input_diff", "sequence_errors", "pose_diff"):
        assert result["check"][k]["value"] == 0, result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("workload", ["cornell.play", "cornell.batch8"])
def test_end_to_end_line_keeps_to_the_contract(tmp_path, workload):
    from benchmark.tests.conftest import TINY
    co = _checkout(tmp_path)
    from benchmark import spec
    result, outside = _run(co, tmp_path, workload, 0, TINY)
    assert not outside, outside
    assert list(result) == CONTRACT_KEYS + ["check"]
    cell = spec.load_cell(ROOT, workload)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "lag_p95_ms"} <= set(result["metrics"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for name, c in result["check"].items():
        assert set(c) == {"value", "limit"}, name


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "cornell.play",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark only, a run
    fails before printing anything."""
    co = tmp_path / "bare"
    shutil.copytree(ROOT / "benchmark", co / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", co / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-c", AUDITED_RUN, "cornell.play", "0", "{}"],
        cwd=co, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_the_contract():
    from benchmark import spec
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(configs) == len(b["configs"]) and len(cells) == len(
        b["workloads"])
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(ROOT, w["name"])   # finds every file by name
        assert set(cell.limits) >= {"input_diff", "rgb_mae"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_the_tick_readers_take_the_windows_wall_and_tail():
    """``shell.tick_ms`` and ``shell.tick_p95_ms`` read what ``tick_ms``
    and ``tick_p95_ms`` take end to end, from the traced run's window."""
    from types import SimpleNamespace

    from benchmark import spec
    ticks = [4.0] * 19 + [24.0]
    s = SimpleNamespace(wall_ms=110.0, tick_ms=ticks)
    mean = spec.metric_reader("shell.tick_ms")
    p95 = spec.metric_reader("shell.tick_p95_ms")
    assert mean.read(SimpleNamespace(spans=s)) == 5.5
    assert p95.read(SimpleNamespace(spans=s)) == pytest.approx(5.0)
    empty = SimpleNamespace(spans=SimpleNamespace(wall_ms=0.0, tick_ms=[]))
    assert mean.read(empty) is None and p95.read(empty) is None
