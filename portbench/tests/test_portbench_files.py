"""Every file the harness finds by name loads, and BENCHMARK.json keeps to
the shape the harness reads."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.feeds import load_traffic

PKG = Path(harness.__file__).resolve().parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_names_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for x in ("end_to_end", "per_layer") for n in (m["name"] for m in b[x]))) \
        == len(b["end_to_end"]) + len(b["per_layer"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in b["workloads"]}


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_loads_by_name(kind):
    for entry in bench()[kind]:
        if kind == "configs":
            with open(ROOT / entry["file"]) as f:
                cfg = json.load(f)["config"]
            harness.port_config(cfg)  # the port takes every key
        else:
            cell = harness.load_cell(entry["name"])
            assert cell.limits and cell.end_to_end and cell.per_layer
            assert cell.traffic["checked_steps"] <= cell.traffic.get("pool_batches", 1 << 30)


def test_every_traffic_file_loads():
    files = sorted((PKG / "traffic").glob("*.json"))
    assert files
    for f in files:
        t = load_traffic(f.stem)
        assert t["feed"] in ("resident", "loader")


def test_every_metric_reader_loads():
    per_layer = {m["name"] for m in bench()["per_layer"]}
    files = {p.stem for p in (PKG / "metrics").glob("*.py")}
    assert per_layer <= files
    for name in files:
        assert callable(harness.load_reader(name))


def test_every_limits_file_names_known_numbers():
    known = {"loss1_gap", "loss_gap", "grad_gap", "grad_median_gap", "change_gap",
             "change_median_gap", "bn_gap", "bn_median_gap", "loader_gap"}
    for f in (PKG / "limits").glob("*.json"):
        with open(f) as fh:
            assert set(json.load(fh)) <= known, f.name


def test_reference_imports_nothing_of_the_port_or_jax():
    banned = {"jax", "jaxlib", "flax", "unsupervised_depth_opticalflow_egomotion_tpu",
              "unsupervised_depth_opticalflow_egomotion_torch"}
    for path in list((PKG / "reference").glob("*.py")) + [PKG / "flops" / "__init__.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & banned, f"{path.name} imports {tops & banned}"


@pytest.mark.parametrize("cell,module,cls", [
    ("geom-b8", "joint", "JointReference"),  # kitti_geom.json names none: the default
    ("flow-b8", "joint", "JointReference"),
    ("depth-b8", "depth", "DepthReference"),  # kitti_depth.json names its own
])
def test_a_configuration_names_its_reference(cell, module, cls):
    ref = harness.load_cell(cell).reference
    assert (ref.__module__, ref.__name__) == (f"portbench.reference.{module}", cls)


@pytest.mark.parametrize("name", ["nosuch.Reference", "joint.NoSuchReference", "JointReference",
                                  "joint.WEIGHTS", ""])
def test_a_reference_that_does_not_resolve_raises_naming_the_file(name, tmp_path, monkeypatch):
    b = bench()
    b["workloads"] = [dict(next(w for w in b["workloads"] if w["name"] == "geom-b8"),
                           config="odd")]
    b["configs"] = [{"name": "odd", "file": "odd.json"}]
    with open(ROOT / "portbench" / "configs" / "kitti_geom.json") as f:
        conf = dict(json.load(f), reference=name)
    (tmp_path / "odd.json").write_text(json.dumps(conf))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(ValueError, match="odd.json"):
        harness.load_cell("geom-b8")
