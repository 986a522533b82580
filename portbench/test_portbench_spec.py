"""BENCHMARK.json against the contract's rules, a cell made from files
and entries alone, and the import guard."""
import copy
import importlib.util

import pytest

from portbench.harness import cell, spec, traffic

RUN = spec.PACKAGE / "run.py"


def _run_module():
    sp = importlib.util.spec_from_file_location("portbench_run", RUN)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def test_benchmark_keeps_the_rules():
    bench = spec.load()
    assert spec.check_names(bench) == []
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).exists()
        assert spec.read_json(spec.ROOT / c["file"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        traffic.load(w["traffic"])
        assert (spec.PACKAGE / "limits" / f"{w['name']}.json").exists()
        for trace in (False, True):
            for m in spec.metrics_of(bench, w["name"], trace):
                assert (spec.PACKAGE / "metrics" / f"{m['name']}.py").exists()
        assert {"setup_s", "gen_tok_s"} <= {
            m["name"] for m in spec.metrics_of(bench, w["name"], False)}
    assert all(m.get("bound", 0) <= 0.25 for m in bench["end_to_end"])
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("bad", [
    ("end_to_end", 0, "unit", "tokens per second"),
    ("per_layer", 0, "name", "deploy s"),
    ("workloads", 0, "name", "a/b"),
    ("per_layer", 0, "layer", "two\nlines"),
    ("end_to_end", 0, "name", "gen_tok_µs")])
def test_a_name_or_unit_out_of_the_rules_is_found(bad):
    bench = copy.deepcopy(spec.load())
    key, i, field, value = bad
    bench[key][i][field] = value
    assert spec.check_names(bench)


def test_a_new_configuration_from_a_file_and_an_entry(tiny_root):
    root = tiny_root("dense")
    bench = spec.load(root)
    w = spec.workload(bench, "tiny.mix")
    cfg = spec.read_json(root / spec.config_entry(bench, w["config"])["file"])
    mcfg = cell.model_config(cfg)
    assert (mcfg.name, mcfg.num_layers, mcfg.d_model) == ("tiny-dense", 2, 64)
    assert traffic.load(w["traffic"], root / "portbench")["rows"] == 4
    assert [m["name"] for m in spec.metrics_of(bench, "tiny.mix", True)] == [
        "pass_ms"]
    ssm = cell.model_config(spec.read_json(
        spec.PACKAGE / "configs" / "falcon-mamba-7b.json"))
    assert ssm.ssm.resolved_dt_rank(ssm.d_model) == 256
    assert ssm.num_layers == 64 and ssm.attention == "none"


def test_the_guard_compares_whole_top_level_names():
    run = _run_module()
    assert run.forbidden(["repro_torch", "repro_torch.models", "jaxtyping",
                          "reprolib", "portbench.harness"]) == []
    assert run.forbidden(["repro_torch", "repro.core.pilot", "jax.numpy",
                          "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]
