"""``BENCHMARK.json`` held to the contract's shape and characters, every
name found as a file, and a configuration, traffic mix and metric added
by new files and entries alone."""
import json
import os
import re
import shutil


from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def _manifest():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    b = _manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_is_a_file_and_every_cell_reports_enough():
    b = _manifest()
    cfgs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    used = set()
    for w in b["workloads"]:
        used.add(w["config"])
        _, config, traffic = harness.cell_spec(b, w["name"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "runners",
                                           traffic["runner"] + ".py"))
        reports = [m["name"] for m in harness.cell_metrics(b, w["name"], False)]
        assert "setup_s" in reports and len(reports) >= 2, w["name"]
        assert harness.cell_metrics(b, w["name"], True), w["name"]
        for m in reports + [m["name"] for m in
                            harness.cell_metrics(b, w["name"], True)]:
            assert callable(harness.reader(m)), m
    assert used == set(cfgs)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for wl in m.get("workloads", ()):
            moved = e2e[m["moves"]]
            assert wl in moved.get("workloads", (wl,)), (m["name"], wl)
    layers = {m["layer"] for m in b["per_layer"]}
    assert all(NAME.match(x.replace(" ", "_")) for x in layers)


def test_a_full_check_fits_with_24_cells_and_four_chip_cells_are_few():
    b = _manifest()
    runs, cells = 2 + 14 * 24, 24
    assert runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path, small):
    """A copy of the benchmark with a new configuration (16 nodes, 4 x 4),
    a new traffic mix for the minibatch runner and a new metric reader,
    each a new file plus its entries: the new cell runs and reports the
    new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _manifest()
    cfg = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                         "m64-16x4.json"))
    cfg.update(small("minibatch.m64-16x4")["config"])
    cfg.update(name="m16-4x4", nodes=16, degrees=[4, 4])
    (root / "portbench" / "configs" / "m16-4x4.json").write_text(
        json.dumps(cfg))
    traffic = harness.load_json(os.path.join(ROOT, "portbench", "traffic",
                                             "minibatch.json"))
    traffic.update(small("minibatch.m64-16x4")["traffic"])
    (root / "portbench" / "traffic" / "minibatch-small.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / "reduce_p50_ms.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n"
        "    return statistics.median(ctx['latencies_s']) * 1e3\n")
    b["configs"].append({"name": "m16-4x4", "source": "a test",
                         "file": "portbench/configs/m16-4x4.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "minibatch-small.m16-4x4",
                           "config": "m16-4x4", "traffic": "minibatch-small",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "reduce_p50_ms", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["minibatch-small.m16-4x4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    line = harness.run_cell("minibatch-small.m16-4x4", 5, 0.2, False,
                            device="cpu", root=str(root))
    assert line["correct"], line
    assert {"reduce_p50_ms", "setup_s"} <= set(line["metrics"])
