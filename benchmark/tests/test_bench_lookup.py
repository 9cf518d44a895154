"""Configurations, traffic mixes and metric readers are found by name."""

import pytest

from benchmark import harness


def test_every_entry_of_the_benchmark_is_found():
    spec = harness.load_spec()
    for cfg in spec["configs"]:
        assert harness.load_config(cfg["name"])["name"] == cfg["name"]
    for cell in spec["workloads"]:
        harness.load_config(cell["config"])
        harness.load_traffic(cell["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("load", [harness.load_config, harness.load_traffic,
                                  harness.load_reader])
def test_unknown_name_fails(load):
    with pytest.raises(KeyError, match="unknown"):
        load("no_such_name")


def test_unknown_cell_fails():
    with pytest.raises(KeyError, match="unknown workload"):
        harness.find(harness.load_spec()["workloads"], "no.such", "workload")


def test_metrics_of_a_cell():
    spec = harness.load_spec()
    names = {m["name"] for m in harness.cell_metrics(
        spec, "cnr2000.decode", False)}
    assert {"decode_ns_per_arc", "setup_s", "bits_per_link"} <= names
    assert "query_p95_ms" not in names
    layer = {m["name"] for m in harness.cell_metrics(
        spec, "cnr2000.query_uniform", True)}
    assert "ra_rounds.query" in layer and "post_ms.decode" not in layer
    # every per-layer metric moves an end-to-end metric that each of its
    # cells reports
    for m in spec["per_layer"]:
        for cell in m.get("workloads", [c["name"] for c in
                                        spec["workloads"]]):
            e2e = {x["name"] for x in harness.cell_metrics(spec, cell,
                                                           False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_query_draws_depend_on_the_seed_alone():
    import numpy as np

    from benchmark import generator
    mix = {"entry": "query", "batch": 64, "distribution": "uniform"}
    nodes = 1000
    draw = [generator.make_driver(mix, None, nodes, seed, None).draw(
        np.random.default_rng(seed)) for seed in (5, 5, 6)]
    assert np.array_equal(draw[0], draw[1])
    assert not np.array_equal(draw[0], draw[2])
    assert draw[0].min() >= 0 and draw[0].max() < nodes


@pytest.mark.parametrize("mix,match", [
    ({"entry": "nope"}, "unknown traffic entry"),
    ({"entry": "query", "batch": 4, "distribution": "zipf"},
     "unknown query distribution"),
    ({"entry": "query", "batch": 4, "clients": 2}, "not read"),
    ({"entry": "decode", "warmup_calls": 1, "checked": 1,
      "check_range": [1, 4], "loop": "open"}, "not read")])
def test_unknown_traffic_entry_key_or_value_fails(mix, match):
    from benchmark import generator
    with pytest.raises(ValueError, match=match):
        generator.make_driver(mix, None, 10, 1, None)


def test_every_traffic_file_is_read_whole():
    from benchmark import generator
    for cell in harness.load_spec()["workloads"]:
        generator.make_driver(harness.load_traffic(cell["traffic"]), None,
                              10, 1, None)
