"""BENCHMARK.json against the shapes it must keep, the files it names found by
name, and no JAX in the run's modules."""

import json
import re
import subprocess
import sys

import pytest

from harness import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"output_tokens_per_s", "ttft_p90_ms", "itl_p90_ms",
                        "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in MAN["workloads"]:
        got = [m["name"] for m in manifest.end_to_end(MAN, w["name"])]
        assert "setup_s" in got and len(got) >= 2
        assert manifest.per_layer(MAN, w["name"])


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            moved = [e["name"] for e in manifest.end_to_end(MAN, cell)]
            assert m["moves"] in moved, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name():
    for w in MAN["workloads"]:
        cfg = manifest.config(MAN, w["config"])
        assert cfg["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["loop"] in ("open", "closed")
        assert manifest.limits(w["name"])
    for c in MAN["configs"]:
        f = manifest.config(MAN, c["name"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_departures_lie_over_the_published_keys():
    from reference.masters import dims

    for c in MAN["configs"]:
        f = manifest.config(MAN, c["name"])
        run = manifest.as_run(f)
        for key, value in f.get("departures", {}).items():
            assert run[key] == value
            # each departure of the port is said in words beside it
            assert any(key.split("_")[0] in a or "departures" in a
                       for a in f["assumed"])
        assert {k: run[k] for k in f["model"] if k not in
                f.get("departures", {})} == {
            k: v for k, v in f["model"].items()
            if k not in f.get("departures", {})}
    star = manifest.config(MAN, "starcoder2-7b")
    # published, StarCoder2 biases every projection; the port (and so the
    # reference it is held to) has none on the attention's output
    with pytest.raises(NotImplementedError):
        dims(star["model"])
    d = dims(manifest.as_run(star))
    assert d["qkv_bias"] and d["mlp_bias"]
    assert not dims(manifest.as_run(
        manifest.config(MAN, "internlm2-20b")))["qkv_bias"]


def test_run_imports_no_jax():
    code = (
        "import sys, json\n"
        "sys.path[:0] = ['bench', 'src']\n"
        "import run, control\n"
        "from harness import build, cell, check, manifest, readers, stats, "
        "trace, traffic\n"
        "from reference import masters, model\n"
        "import repro_torch.serving.engine, repro_torch.serving.api\n"
        "import repro_torch.core.quant_plan, repro_torch.kernels.ops\n"
        "man = manifest.load()\n"
        "[manifest.reader(m['name']) for m in man['end_to_end'] + "
        "man['per_layer']]\n"
        "print(json.dumps(run.loaded_forbidden()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(manifest.ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_card_or_port(tmp_path):
    """With no card (this host) or no port beside it, no result line."""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         MAN["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=str(manifest.ROOT), timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    (bare / "bench").mkdir(parents=True)
    (bare / "BENCHMARK.json").write_text(json.dumps(MAN))
    (bare / "bench" / "run.py").write_text(
        (manifest.BENCH / "run.py").read_text())
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         MAN["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=str(bare), timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no port" in out.stderr
