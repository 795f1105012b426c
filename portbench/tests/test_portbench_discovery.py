"""A configuration, a traffic mix and a per-layer metric added as new files
with their entries in BENCHMARK.json are found without editing a file."""

import json
import shutil

from portbench.harness import cell as cells

ROOT = cells.ROOT


def test_new_files_are_found_by_name(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "portbench" / "metrics").mkdir()
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "hagcn-fd001.json").read_text())
    cfg["dataset_id"] = "FD003"
    (tmp_path / "portbench" / "configs" / "hagcn-fd003.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "cmapss_test_fleets.json").read_text())
    mix["sizes"] = [100]
    (tmp_path / "portbench" / "traffic" / "serve100.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "serve.new_share.py").write_text(
        "def read(r):\n    return 42.0 if r.calls else None\n")
    bench["configs"].append({"name": "hagcn-fd003", "source": "s",
                             "file": "portbench/configs/hagcn-fd003.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "hagcn-fd003.serve100",
                               "config": "hagcn-fd003",
                               "traffic": "serve100", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "serve.new_share", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "entry", "moves": "serve_p95_ms",
                               "workloads": ["hagcn-fd003.serve100"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_windows_per_s", "serve_p95_ms"):
            m["workloads"].append("hagcn-fd003.serve100")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic"):
        for f in (ROOT / "portbench" / sub).glob("*.json"):
            shutil.copy(f, tmp_path / "portbench" / sub)

    cell = cells.load("hagcn-fd003.serve100", root=tmp_path)
    assert cell.config["dataset_id"] == "FD003"
    assert cell.traffic["sizes"] == [100]
    assert [m["name"] for m in cell.per_layer] == ["serve.new_share"]
    assert {m["name"] for m in cell.end_to_end} == {
        "serve_windows_per_s", "serve_p95_ms", "setup_s"}
    read = cells.reader("serve.new_share", root=tmp_path)
    assert read(cells.Readings(cell.config, cell.counts, calls={"request": [1]})) == 42.0
    assert read(cells.Readings(cell.config, cell.counts)) is None


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        cells.runner(cell.traffic["kind"])
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))


def test_a_suffixed_metric_reads_its_prefix():
    assert cells.base_name("lstm_fwd_roofline.host_paced", lambda n: (
        ROOT / "portbench" / "metrics" / f"{n}.py").is_file()) == \
        "lstm_fwd_roofline"
    assert cells.base_name("serve_p95_ms.host_paced",
                           {"serve_p95_ms": 1.0}.__contains__) == "serve_p95_ms"
    assert callable(cells.reader("idle_share.serve.host_paced"))
